"""The port's density grids against the JAX package's, and the mirrors of
tests/test_grids.py.

The grid functions run on the same inputs, made from a seed with numpy, in
both packages: density (trilinear and nearest), the optical depth and its
inverse through the exact cell walk (K6's twin, ops/grid_walk.py) and
through the raymarching trapezoid march. XLA on the CPU contracts the
world-to-grid product and the trilinear weights into fused multiply-adds,
and the port computes them as separate products in a fixed order, so the
bars are: density rtol 1e-5 (atol 1e-6); tau rtol 2e-5 (atol 1e-5: a sum of
up to ~100 cells); the inverse t atol 1e-4 (the 24 bisection rounds bracket
t to a cell width / 2^24, but the cell where the target is crossed can
differ by one when tau sits on a cell boundary within rounding; such lanes
are counted and allowed on 1% of the lanes), INF lanes equal. The seven
tests of tests/test_grids.py follow with their own bars, on the port.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tungsten_tpu.models import grids as jg
from tungsten_tpu_torch.models.grids import grid as tg
from tungsten_tpu_torch.models.media.media import medium_sample_distance, medium_transmittance
from tungsten_tpu_torch.models.media.media import pack_media
from tungsten_tpu_torch.ops import grid_walk

SIGMA = 0.25
CENTER = np.array([0.0, 0.5, 0.0])  # normalize_size bottom-aligns y (VdbGrid.cpp:237-240)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _pair(spec):
    return jg.load_grid_spec(spec), tg.load_grid_spec(spec, device=torch.device("cpu"))


def _rays(seed, n, spread=0.9):
    rng = np.random.default_rng(seed)
    o = (rng.uniform(-1.2, 1.2, (n, 3)) + CENTER).astype(np.float32)
    target = (rng.uniform(-spread / 2, spread / 2, (n, 3)) + CENTER).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32), rng


GRIDS = {
    "linear": {"type": "gaussian", "resolution": 24, "sigma": SIGMA},
    "nearest": {"type": "gaussian", "resolution": 24, "sigma": SIGMA,
                "sampling_method": "exact_nearest"},
    "raymarching": {"type": "gaussian", "resolution": 24, "sigma": SIGMA, "steps": 48,
                    "integration_method": "raymarching"},
}


@pytest.mark.parametrize("kind", list(GRIDS))
def test_grid_functions_match_jax(kind):
    """density, optical depth over [t0, t1] and the inverse against JAX, on
    256 random rays through and around the blob (a quarter miss it)."""
    jgr, tgr = _pair(GRIDS[kind])
    assert tgr.dims == jgr.dims and tgr.linear == jgr.linear and tgr.exact == jgr.exact
    np.testing.assert_array_equal(tgr.density.numpy(), np.asarray(jgr.density))
    np.testing.assert_array_equal(tgr.w2g.numpy(), np.asarray(jgr.w2g))
    n = 256
    o, d, rng = _rays(7, n)
    p = (rng.uniform(-0.6, 0.6, (n, 3)) + CENTER).astype(np.float32)
    np.testing.assert_allclose(tg.grid_density(tgr, _t(p)).numpy(),
                               np.asarray(jg.grid_density(jgr, jnp.asarray(p))),
                               rtol=1e-5, atol=1e-6)
    t0 = rng.uniform(0.0, 0.5, n).astype(np.float32)
    t1 = rng.uniform(0.5, 4.0, n).astype(np.float32)
    t1[:16] = 1e30
    want = np.asarray(jg.grid_optical_depth(jgr, jnp.asarray(o), jnp.asarray(d),
                                            jnp.asarray(t0), jnp.asarray(t1)))
    got = tg.grid_optical_depth(tgr, _t(o), _t(d), _t(t0), _t(t1)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)
    assert (want > 0.05).mean() > 0.3
    target = (want * rng.uniform(0.1, 1.3, n)).astype(np.float32)
    jinv = np.asarray(jg.grid_inverse_optical_depth(
        jgr, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t0), jnp.asarray(t1),
        jnp.asarray(target)))
    tinv = tg.grid_inverse_optical_depth(tgr, _t(o), _t(d), _t(t0), _t(t1), _t(target)).numpy()
    inf = jinv >= 1e30
    np.testing.assert_array_equal(tinv >= 1e30, inf)
    assert 0 < inf.sum() < n
    off = np.abs(tinv[~inf] - jinv[~inf]) > 1e-4
    assert off.mean() <= 0.01, f"{off.sum()} lanes off: {tinv[~inf][off]} vs {jinv[~inf][off]}"


def test_grid_emission_matches_jax(tmp_path):
    """A dense .npz with an emission grid: grid_emission against JAX, and
    the emission scale and scale_emission_by_density options."""
    rng = np.random.default_rng(4)
    dens = rng.uniform(0.0, 1.0, (6, 7, 8)).astype(np.float32)
    emis = rng.uniform(0.0, 2.0, (6, 7, 8, 3)).astype(np.float32)
    path = str(tmp_path / "g.npz")
    np.savez(path, density=dens, emission=emis)
    spec = {"type": "dense", "file": path, "emission_scale": 1.5,
            "scale_emission_by_density": True, "transform": {"scale": 2.0}}
    jgr, tgr = _pair(spec)
    assert tgr.has_emission and jgr.has_emission
    np.testing.assert_array_equal(tgr.emission.numpy(), np.asarray(jgr.emission))
    p = rng.uniform(-1.2, 2.2, (200, 3)).astype(np.float32)
    np.testing.assert_allclose(tg.grid_emission(tgr, _t(p)).numpy(),
                               np.asarray(jg.grid_emission(jgr, jnp.asarray(p))),
                               rtol=1e-5, atol=1e-6)


def test_walk_twin_counts_rounds_and_masks():
    """The twin's bookkeeping: a masked-out lane returns 0 (tau) or INF
    (inverse) and walks no round; every other lane equals its unmasked
    value bit for bit; `.work` counts the lane-rounds."""
    tgr = tg.load_grid_spec(GRIDS["linear"], device=torch.device("cpu"))
    o, d, _ = _rays(9, 64)
    oq, dq, ta, tb = tg._walk_inputs(tgr, _t(o), _t(d), torch.zeros(64), torch.full((64,), 5.0))
    full = grid_walk.walk_twin(tgr.density, True, oq, dq, ta, tb)
    rounds_all = grid_walk.walk_twin.work["rounds"]
    mask = torch.arange(64) % 2 == 0
    half = grid_walk.walk_twin(tgr.density, True, oq, dq, ta, tb, mask=mask)
    assert torch.equal(half[mask], full[mask]) and (half[~mask] == 0).all()
    assert 0 < grid_walk.walk_twin.work["rounds"] < rounds_all
    inv = grid_walk.walk_twin(tgr.density, True, oq, dq, ta, tb, "inverse", full * 0.5, mask)
    assert (inv[~mask] >= 1e30).all() and (inv[mask & (full > 0)] < 1e30).all()
    assert grid_walk.walk_twin.work["bisect"] == 24 * int((mask & (full > 0)).sum())


# ---- the mirrors of tests/test_grids.py, on the port ----

@pytest.fixture(scope="module")
def blob():
    return tg.load_grid_spec({"type": "gaussian", "resolution": 64, "sigma": SIGMA,
                              "steps": 128}, device=torch.device("cpu"))


def _analytic_tau(o, d, t):
    """int_0^t exp(-|o + s d - c|^2 / (2 sigma^2)) ds inside the grid's box."""
    from scipy.integrate import quad

    def dens(s):
        p = o + s * d - CENTER
        if np.any(np.abs(p) > 0.5):
            return 0.0
        return np.exp(-np.dot(p, p) / (2 * SIGMA * SIGMA))

    return quad(dens, 0.0, t, limit=400)[0]


def test_density_matches_analytic(blob):
    rng = np.random.default_rng(0)
    p = (rng.uniform(-0.45, 0.45, (64, 3)) + CENTER).astype(np.float32)
    got = tg.grid_density(blob, _t(p)).numpy()
    pc = p - CENTER.astype(np.float32)
    assert np.allclose(got, np.exp(-np.sum(pc * pc, axis=1) / (2 * SIGMA * SIGMA)), atol=2e-3)


def test_optical_depth_matches_analytic(blob):
    rng = np.random.default_rng(1)
    o = (rng.uniform(-0.9, -0.6, (8, 3)) + CENTER).astype(np.float32)
    rng.normal(size=(8, 3))
    d = (CENTER.astype(np.float32) - o + rng.uniform(-0.2, 0.2, (8, 3)).astype(np.float32))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t1 = np.full((8,), 3.0, np.float32)
    got = tg.grid_optical_depth(blob, _t(o), _t(d), torch.zeros(8), _t(t1)).numpy()
    want = np.array([_analytic_tau(o[i], d[i], t1[i]) for i in range(8)])
    # the 64^3 trilinear discretization biases a gaussian peak by ~3%
    assert np.allclose(got, want, rtol=0.04, atol=1e-3), (got, want)


def test_inverse_optical_depth_roundtrip(blob):
    rng = np.random.default_rng(2)
    o = np.tile(np.array([[-1.0, 0.52, -0.03]], np.float32), (16, 1))
    d = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (16, 1))
    t = rng.uniform(0.6, 1.4, 16).astype(np.float32)
    tau = tg.grid_optical_depth(blob, _t(o), _t(d), torch.zeros(16), _t(t))
    t_back = tg.grid_inverse_optical_depth(blob, _t(o), _t(d), torch.zeros(16),
                                           torch.full((16,), 1e30), tau).numpy()
    assert np.allclose(t_back, t, atol=5e-3)


def test_inverse_unreachable_is_inf(blob):
    o, d = _t([[-1.0, 0.5, 0.0]]), _t([[1.0, 0.0, 0.0]])
    total = tg.grid_optical_depth(blob, o, d, torch.zeros(1), torch.full((1,), 1e30))
    t = tg.grid_inverse_optical_depth(blob, o, d, torch.zeros(1), torch.full((1,), 1e30),
                                      total * 1.5)
    assert float(t[0]) >= 1e30


def _voxel_media():
    return pack_media([{"type": "voxel", "sigma_a": 0.5, "sigma_s": 1.5,
                        "grid": {"type": "gaussian", "resolution": 48, "sigma": SIGMA,
                                 "steps": 128, "normalize_size": True},
                        "phase_function": {"type": "isotropic"}}], device=torch.device("cpu"))


def test_voxel_medium_transmittance_matches_analytic():
    media = _voxel_media()
    n = 4
    o = _t(np.tile([[-1.0, 0.5, 0.0]], (n, 1)))
    d = _t(np.tile([[1.0, 0.0, 0.0]], (n, 1)))
    far = _t([0.6, 1.0, 1.4, 2.0])
    ones = torch.ones(n, dtype=torch.bool)
    tr = medium_transmittance(media, torch.zeros(n, dtype=torch.int64), far, ones, ones,
                              o, d).numpy()
    want = np.array([np.exp(-2.0 * _analytic_tau(np.array([-1.0, 0.5, 0]),
                                                 np.array([1.0, 0, 0]), float(f)))
                     for f in far.numpy()])
    assert np.allclose(tr[:, 0], want, rtol=0.03), (tr[:, 0], want)


def test_voxel_medium_distance_sampling_unbiased():
    """E[1{scatter before t*}] = 1 - exp(-sigma_t tau(t*)); the weights are
    finite and positive; the scatter points lie in the blob."""
    media = _voxel_media()
    n = 4096
    rng = np.random.default_rng(3)
    o = _t(np.tile([[-1.0, 0.5, 0.0]], (n, 1)))
    d = _t(np.tile([[1.0, 0.0, 0.0]], (n, 1)))
    u = [_t(rng.uniform(size=n)) for _ in range(3)]
    ms = medium_sample_distance(media, torch.zeros(n, dtype=torch.int64), o, d,
                                torch.full((n,), 2.0), torch.ones(n, dtype=torch.bool),
                                torch.zeros(n, dtype=torch.int64), *u)
    scatter_frac = float(ms.scattered.float().mean())
    want = 1.0 - np.exp(-2.0 * _analytic_tau(np.array([-1.0, 0.5, 0]),
                                             np.array([1.0, 0, 0]), 2.0))
    assert abs(scatter_frac - want) < 0.03, (scatter_frac, want)
    w = ms.weight.numpy()
    assert np.all(np.isfinite(w)) and np.all(w >= 0.0)
    p = ms.p.numpy()[ms.scattered.numpy()]
    assert len(p) and np.abs(p[:, 0]).max() < 0.55


def test_exact_dda_linear_ramp_machine_exact(tmp_path):
    """A linear density ramp is reproduced EXACTLY by trilinear
    interpolation, so the exact cell walk (DDA + Gauss-2) integrates it to
    float precision (1e-5), and its inverse round-trips (2e-5)."""
    n = 16
    c = (np.arange(n) + 0.5) / n
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    path = os.path.join(tmp_path, "ramp.npy")
    np.save(path, (0.25 + 1.5 * x).astype(np.float32))
    g = tg.load_grid_spec({"type": "dense", "file": path}, device=torch.device("cpu"))
    assert g.exact
    rng = np.random.default_rng(5)
    o = np.stack([np.full(64, -1.0), rng.uniform(0.15, 0.85, 64),
                  rng.uniform(-0.35, 0.35, 64)], -1).astype(np.float32)
    d = np.tile([1.0, 0.0, 0.0], (64, 1)).astype(np.float32)
    tau = tg.grid_optical_depth(g, _t(o), _t(d), torch.zeros(64),
                                torch.full((64,), 10.0)).numpy()
    # the ramp on [-0.5 + h/2, 0.5 - h/2], and in each half-voxel margin the
    # missing neighbor taps contribute 0: w * d_edge, w from 0.5 to 1
    h = 1.0 / n
    lo, hi = -0.5 + 0.5 * h, 0.5 - 0.5 * h
    f = lambda xx: 0.25 + 1.5 * (xx + 0.5)  # noqa: E731
    expected = 0.5 * (f(lo) + f(hi)) * (hi - lo) + 0.75 * (f(lo) + f(hi)) * 0.5 * h
    assert np.allclose(tau, expected, rtol=1e-5), (tau[:4], expected)
    t_inv = tg.grid_inverse_optical_depth(g, _t(o), _t(d), torch.zeros(64),
                                          torch.full((64,), 10.0), torch.full((64,), 0.35))
    tau_back = tg.grid_optical_depth(g, _t(o), _t(d), torch.zeros(64), t_inv).numpy()
    assert np.allclose(tau_back, 0.35, atol=2e-5)


def _ahead_case(backstop, n=512, seed=21):
    """A small density grid and rays in its coordinates: most cross it,
    some start inside, some parallel to a grid plane; a masked fifth; one
    lane with an empty span; with `backstop`, one with a NaN span (it walks
    to the backstop without a live round) and one walking 5,000 unit cells
    (past the 4,096-round backstop)."""
    rng = np.random.default_rng(seed)
    dens = torch.as_tensor(rng.uniform(0.0, 2.0, (12, 10, 14)).astype(np.float32))
    oq = torch.as_tensor(rng.uniform(-4.0, 18.0, (n, 3)).astype(np.float32))
    aim = torch.as_tensor(rng.uniform(2.0, 10.0, (n, 3)).astype(np.float32))
    dq = aim - oq
    dq[::37, 2] = 0.0
    dq = dq / dq.norm(dim=1, keepdim=True)
    ta = torch.zeros(n)
    tb = torch.as_tensor(rng.uniform(1.0, 30.0, n).astype(np.float32))
    tb[2] = 0.0
    if backstop:
        oq[1], dq[1], tb[1] = torch.tensor([0.25, 5.0, 5.0]), torch.tensor([1.0, 0, 0]), 5000.0
        tb[3] = float("nan")
    mask = torch.arange(n) % 5 != 4
    return dens, oq, dq, ta, tb, mask


@pytest.mark.parametrize("mode", ["tau", "inverse"])
@pytest.mark.parametrize("linear", [True, False], ids=["linear", "nearest"])
def test_walk_ahead_equals_the_twin(mode, linear):
    """K6's new schedule (walk_ahead: the walking lanes listed, the
    boundaries GROUP rounds ahead, the step's live segments at once, the
    fold in round order, the inverse's first crossing, the bisection's
    tree of midpoints) equals walk_twin bit for bit, at GROUP rounds and
    BISECT_DEPTH levels a step and at 5 rounds and 3 levels: the masked and
    empty lanes' 0 or INF, the NaN lane, the lane cut at the 4,096-round
    backstop (on the nearest grid: the twin's 4,096 rounds of trilinear
    sampling take half a minute); a call with every lane masked gives the
    twin's result."""
    dens, oq, dq, ta, tb, mask = _ahead_case(backstop=not linear)
    target = None
    if mode == "inverse":
        full = grid_walk.walk_twin(dens, linear, oq, dq, ta, tb)
        target = full * torch.as_tensor(np.random.default_rng(2).uniform(0.1, 1.3, len(full)),
                                        dtype=torch.float32)
        target[1] = 1e30  # never reached where lane 1 walks to the backstop: INF
    want = grid_walk.walk_twin(dens, linear, oq, dq, ta, tb, mode, target, mask)
    assert (grid_walk.walk_twin.work["longest"] == grid_walk.MAX_ROUNDS) == (not linear)
    for ahead, depth in ((grid_walk.GROUP, grid_walk.BISECT_DEPTH), (5, 3)):
        got = grid_walk.walk_ahead(dens, linear, oq, dq, ta, tb, mode, target, mask, ahead,
                                   depth)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    off = torch.zeros_like(mask)
    assert torch.equal(grid_walk.walk_ahead(dens, linear, oq, dq, ta, tb, mode, target, off),
                       grid_walk.walk_twin(dens, linear, oq, dq, ta, tb, mode, target, off))
    if mode == "tau":
        assert (want[~mask] == 0).all() and want[2] == 0 and (want[mask] > 0).float().mean() > 0.5
        assert linear or (want[1] > 0 and want[3] == 0)
    else:
        assert (want[~mask] >= 1e30).all() and want[1] >= 1e30 and want[2] >= 1e30
        assert 0 < int((want[mask] < 1e30).sum()) < int(mask.sum())


def test_walking_lanes_keeps_the_lanes_that_walk():
    """The list pass's set: masked, with tb <= ta not true (NaN walks)."""
    ta = torch.tensor([0.0, 1.0, 2.0, 0.0, 0.0, 0.0])
    tb = torch.tensor([1.0, 1.0, 1.0, float("nan"), 2.0, 3.0])
    mask = torch.tensor([True, True, True, True, False, True])
    assert grid_walk.walking_lanes(ta, tb, mask).tolist() == [0, 3, 5]
    assert grid_walk.walking_lanes(ta, tb).tolist() == [0, 3, 4, 5]
