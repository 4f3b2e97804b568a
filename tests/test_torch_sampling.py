"""The torch port's sampling against the JAX package on the same inputs.

Integer hashes and sampler draws must match bit for bit (the counter RNG
makes every sample a pure function of (seed, lane, dim)); warps and the
alias-table distribution match at rtol 1e-5 (transcendentals come from a
different library).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tungsten_tpu.sampling import sampler as js
from tungsten_tpu.sampling import warps as jw
from tungsten_tpu.sampling.distributions import Distribution2D as JDist
from tungsten_tpu_torch.sampling import sampler as ts
from tungsten_tpu_torch.sampling import warps as tw
from tungsten_tpu_torch.sampling.distributions import Distribution2D as TDist

RTOL = 1e-5


def _u32(rng, n):
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def test_pcg4d_bits(rng):
    vs = [_u32(rng, 4096) for _ in range(4)]
    want = js.pcg4d(*(jnp.asarray(v) for v in vs))
    got = ts.pcg4d(*(_t(v) for v in vs))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64), g.numpy())


def test_owen_scramble_bits(rng):
    v, key = _u32(rng, 4096), _u32(rng, 4096)
    want = js.owen_scramble_u32(jnp.asarray(v), jnp.asarray(key))
    got = ts.owen_scramble_u32(_t(v), _t(key))
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64), got.numpy())


@pytest.mark.parametrize("pass_index", [0, 1, 5, 37, 1023])
def test_stratified_cam_2d_exact(rng, pass_index):
    lanes = np.arange(3000, dtype=np.uint32) * 7 + 3
    want = js.stratified_cam_2d(jnp.asarray(lanes), jnp.uint32(pass_index))
    got = ts.stratified_cam_2d(_t(lanes), pass_index)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    # per-lane pass indices (the regen path's form)
    passes = rng.integers(0, 64, lanes.shape[0]).astype(np.uint32)
    want = js.stratified_cam_2d(jnp.asarray(lanes), jnp.asarray(passes))
    got = ts.stratified_cam_2d(_t(lanes), _t(passes))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def _draw_sequence(mod, smp):
    """The regen bounce's draw pattern (skip 3, NEE 1d/2d/1d pairing,
    continuation 2d/1d, RR 1d), then draws past the prefetched window."""
    out = []
    smp = smp.skip(3)
    for kind in ("1d", "2d", "1d", "2d", "1d", "1d", "2d", "1d", "2d", "2d", "1d", "1d"):
        u, smp = smp.next_1d() if kind == "1d" else smp.next_2d()
        out.append(np.asarray(u if isinstance(u, jnp.ndarray) else u.numpy()))
    return out


@pytest.mark.parametrize("strat", [False, True])
@pytest.mark.parametrize("prefetch", [False, True])
def test_sampler_draws_exact(rng, strat, prefetch):
    n = 2048
    seed = (0xBA5EBA11, 0)
    lane = _u32(rng, n)
    bounce = rng.integers(0, 30, n).astype(np.int32)
    dim = 2 + bounce * 24
    samp = rng.integers(0, 700, n).astype(np.uint32)
    pix = _u32(rng, n)
    jsmp = js.Sampler(jnp.asarray(np.array(seed, np.uint32)), jnp.asarray(lane),
                      jnp.asarray(dim), None,
                      jnp.asarray(samp) if strat else None,
                      jnp.asarray(pix) if strat else None, strat)
    tsmp = ts.Sampler(seed, _t(lane), torch.as_tensor(dim.astype(np.int64)),
                      _t(samp) if strat else None, _t(pix) if strat else None, strat)
    if prefetch:
        jsmp, tsmp = jsmp.prefetch(8), tsmp.prefetch(8)
    for w, g in zip(_draw_sequence(js, jsmp), _draw_sequence(ts, tsmp)):
        np.testing.assert_array_equal(w, g)


@pytest.mark.parametrize("strat", [False, True])
def test_sampler_create_camera_draws_exact(rng, strat):
    """Sampler.create at dim 0 (the regen camera draws)."""
    n = 1024
    lane = _u32(rng, n)
    samp = rng.integers(0, 40, n).astype(np.uint32)
    pix = _u32(rng, n)
    jsmp = js.Sampler.create(jnp.asarray(np.array([7, 9], np.uint32)), jnp.asarray(lane), None,
                             jnp.asarray(samp), jnp.asarray(pix), strat)
    tsmp = ts.Sampler.create((7, 9), _t(lane), None, _t(samp), _t(pix), strat)
    for _ in range(2):
        uj, jsmp = jsmp.next_2d()
        ut, tsmp = tsmp.next_2d()
        np.testing.assert_array_equal(np.asarray(uj), ut.numpy())


def test_warps(rng):
    u = rng.random((4096, 2)).astype(np.float32)
    uj, ut = jnp.asarray(u), torch.as_tensor(u)
    for name in ("cosine_hemisphere", "uniform_sphere"):
        np.testing.assert_allclose(getattr(tw, name)(ut).numpy(),
                                   np.asarray(getattr(jw, name)(uj)), rtol=RTOL, atol=1e-6)
    w = np.array(jw.cosine_hemisphere(uj))
    np.testing.assert_allclose(tw.cosine_hemisphere_pdf(torch.as_tensor(w)).numpy(),
                               np.asarray(jw.cosine_hemisphere_pdf(jnp.asarray(w))), rtol=RTOL)
    np.testing.assert_allclose(tw.tent_filter_sample(ut).numpy(),
                               np.asarray(jw.tent_filter_sample(uj)), rtol=RTOL, atol=1e-6)
    gj = jw.gaussian_filter_sample(uj[:, 0], uj[:, 1])
    gt = tw.gaussian_filter_sample(ut[:, 0], ut[:, 1])
    for a, b in zip(gj, gt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=1e-6)
    p0, p1 = rng.random(4096).astype(np.float32), rng.random(4096).astype(np.float32)
    np.testing.assert_allclose(
        tw.power_heuristic(torch.as_tensor(p0), torch.as_tensor(p1)).numpy(),
        np.asarray(jw.power_heuristic(jnp.asarray(p0), jnp.asarray(p1))), rtol=RTOL)


@pytest.mark.parametrize("shape", [(1, 1), (32, 64), (17, 9)])
def test_distribution2d_sample_and_pdf(rng, shape):
    w = rng.random(shape) ** 4
    w[0, :] = 0.0  # an empty row
    jd = JDist.build(w)
    td = TDist.build(w, torch.device("cpu"))
    np.testing.assert_array_equal(td.alias_pack.numpy(), np.asarray(jd.alias_pack))
    np.testing.assert_array_equal(td.joint_pdf.numpy(), np.asarray(jd.joint_pdf))
    u = rng.random((4096, 2)).astype(np.float32)
    xj, yj, pj, uvj = jd.sample(jnp.asarray(u))
    xt, yt, pt, uvt = td.sample(torch.as_tensor(u))
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=RTOL)
    np.testing.assert_allclose(uvt.numpy(), np.asarray(uvj), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(td.prob(xt, yt).numpy(), np.asarray(jd.prob(xj, yj)), rtol=RTOL)
