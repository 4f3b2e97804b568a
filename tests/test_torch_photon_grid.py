"""SPPM's hash grids and K7's twin against the JAX package, on the CPU.

  * `_hash_cell` (negative cells wrap as uint32) and `_mix01` bit for bit;
  * `build_photon_grid` on seeded photons crowded into a few cells (so that
    cells overflow and the compensation rescales their kept rows): the
    pack, the cell tables and the overflow equal the JAX package's (the
    compensated powers within rtol 1e-5: two cumulative sums in float32);
  * the mirrors of tests/test_photon_overflow.py's two CPU tests;
  * `build_beam_grid`: the cell tables, overflow, truncation and the valid
    stations' rows (the port keeps only those, in the JAX order);
  * `build_plane_list` with thinning (more records than MAX_PLANES) and
    with padding (fewer);
  * K7's twin (ops/photon_walk.py) in surface and hist mode against a
    brute-force loop over the same grid written from the JAX package's loop
    structure, pair for pair (its DDA modes are held to the JAX gathers in
    test_torch_sppm_media.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

N = 4096


def jnp_u32(x):
    return jnp.asarray(np.asarray(x, np.int64) & 0xFFFFFFFF, jnp.uint32)


def test_hash_and_mix_bit_for_bit():
    from tungsten_tpu.integrators import photon_map as jpm
    from tungsten_tpu_torch.integrators import photon_map as tpm

    gen = np.random.default_rng(1)
    c = gen.integers(-(1 << 30), 1 << 30, (3, N)).astype(np.int32)
    c[:, :8] = [[-1, 0, 1, -(1 << 31), (1 << 31) - 1, 5, -7, 1 << 28]] * 3
    want = np.asarray(jpm._hash_cell(*(jnp.asarray(x) for x in c)))
    got = tpm._hash_cell(*(torch.as_tensor(x) for x in c)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert got.max() < jpm.GRID_SIZE and (got >= 0).all()
    u = gen.integers(0, 1 << 32, (3, N), dtype=np.uint64)
    want = np.asarray(jpm._mix01(*(jnp_u32(x) for x in u)))
    got = tpm._mix01(*(torch.as_tensor(x.astype(np.int64)) for x in u)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0.0 and got.max() < 1.0


def crowded_photons(n, seed, cells=6, size=0.5):
    """n photons in a few cells of `size` (many over MAX_PER_CELL), some
    invalid, in emission order."""
    gen = np.random.default_rng(seed)
    centre = gen.integers(-4, 4, (cells, 3)).astype(np.float32)
    pick = gen.integers(0, cells, n)
    pos = ((centre[pick] + gen.random((n, 3)).astype(np.float32) * 0.98 + 0.01) * size)
    power = gen.random((n, 3)).astype(np.float32)
    wi = gen.normal(size=(n, 3)).astype(np.float32)
    valid = gen.random(n) < 0.9
    bounce = gen.integers(1, 7, n).astype(np.int32)
    return pos.astype(np.float32), power, wi, valid, bounce


def test_build_photon_grid_matches_jax():
    from tungsten_tpu.integrators import photon_map as jpm
    from tungsten_tpu_torch.integrators import photon_map as tpm

    pos, power, wi, valid, bounce = crowded_photons(2000, 2)
    want = jpm.build_photon_grid(*(jnp.asarray(x) for x in (pos, power, wi, valid)), 0.5,
                                 bounce=jnp.asarray(bounce))
    got = tpm.build_photon_grid(*(torch.as_tensor(x) for x in (pos, power, wi, valid)), 0.5,
                                bounce=torch.as_tensor(bounce))
    pack_w, pack_g = np.asarray(want[0]), got[0].numpy()
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[3]) == int(want[3]) > 0
    cols = [0, 1, 2, 6, 7, 8, 9]
    np.testing.assert_array_equal(pack_g[:, cols], pack_w[:, cols])
    np.testing.assert_allclose(pack_g[:, 3:6], pack_w[:, 3:6], rtol=1e-5)


def test_overflow_energy_preserved():
    """tests/test_photon_overflow.py: all photons in one cell; the kept
    MAX_PER_CELL rows carry the cell's whole power."""
    from tungsten_tpu_torch.integrators.photon_map import (MAX_PER_CELL, _hash_cell,
                                                           build_photon_grid)

    rng = np.random.default_rng(11)
    n = 4 * MAX_PER_CELL
    pos = rng.random((n, 3)).astype(np.float32) * 0.8 + 0.1
    power = rng.random((n, 3)).astype(np.float32)
    wi = np.tile([0.0, 0.0, 1.0], (n, 1)).astype(np.float32)
    pack, starts, counts, ovf = build_photon_grid(
        torch.as_tensor(pos), torch.as_tensor(power), torch.as_tensor(wi),
        torch.ones(n, dtype=torch.bool), cell_size=1.0)
    assert int(ovf) == n - MAX_PER_CELL
    key = int(_hash_cell(torch.tensor(0), torch.tensor(0), torch.tensor(0)))
    s = int(starts[key])
    kept = pack.numpy()[s:s + MAX_PER_CELL, 3:6]
    assert np.allclose(kept.sum(), power.sum(), rtol=2e-3)


def test_no_overflow_unchanged():
    from tungsten_tpu_torch.integrators.photon_map import MAX_PER_CELL, build_photon_grid

    rng = np.random.default_rng(3)
    n = MAX_PER_CELL // 2
    pos = rng.random((n, 3)).astype(np.float32) * 0.8 + 0.1
    power = rng.random((n, 3)).astype(np.float32)
    wi = np.tile([0.0, 0.0, 1.0], (n, 1)).astype(np.float32)
    pack, starts, counts, ovf = build_photon_grid(
        torch.as_tensor(pos), torch.as_tensor(power), torch.as_tensor(wi),
        torch.ones(n, dtype=torch.bool), cell_size=1.0)
    assert int(ovf) == 0
    assert np.allclose(np.sort(pack.numpy()[:n, 3].ravel()), np.sort(power[:, 0]))


def seeded_beams(nb, seed):
    gen = np.random.default_rng(seed)
    bo = gen.uniform(-0.2, 0.2, (nb, 3)).astype(np.float32)  # crowded near the origin
    bd = gen.normal(size=(nb, 3)).astype(np.float32)
    bd /= np.linalg.norm(bd, axis=-1, keepdims=True)
    blen = gen.uniform(0.0, 5.0, nb).astype(np.float32)
    blen[:20] = 40.0  # past the last station: truncated
    bpow = gen.random((nb, 3)).astype(np.float32)
    bmed = gen.integers(0, 2, nb).astype(np.int32)
    valid = gen.random(nb) < 0.85
    bounce = gen.integers(1, 7, nb).astype(np.int32)
    return bo, bd.astype(np.float32), blen, bpow, bmed, valid, bounce


def test_build_beam_grid_matches_jax():
    from tungsten_tpu.integrators import photon_map as jpm
    from tungsten_tpu_torch.integrators import photon_map as tpm

    beams = seeded_beams(600, 4)
    r = 0.15
    want = jpm.build_beam_grid(*(jnp.asarray(x) for x in beams), jnp.float32(r))
    got = tpm.build_beam_grid(*(torch.as_tensor(x) for x in beams), r)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[3]) == int(want[3]) > 0
    np.testing.assert_allclose(float(got[4]), float(want[4]), rtol=1e-5)
    assert float(got[4]) > 0.0
    n_valid = got[0].shape[0]
    assert 0 < n_valid == int(np.asarray(want[2]).sum()) < np.asarray(want[0]).shape[0]
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0])[:n_valid])


@pytest.mark.parametrize("nrec", [6000, 1000])
def test_build_plane_list_matches_jax(nrec):
    """Thinned to MAX_PLANES with power x n_valid / MAX_PLANES (6000
    records), or padded (1000)."""
    from tungsten_tpu.integrators import photon_map as jpm
    from tungsten_tpu_torch.integrators import photon_map as tpm

    gen = np.random.default_rng(5)
    recs = [gen.normal(size=(nrec, 3)).astype(np.float32) for _ in range(3)]
    recs += [gen.random(nrec).astype(np.float32), gen.random((nrec, 3)).astype(np.float32),
             gen.random(nrec) < 0.8, gen.integers(0, 7, nrec).astype(np.int32)]
    want = jpm.build_plane_list(*(jnp.asarray(x) for x in recs), seed=3)
    got = tpm.build_plane_list(*(torch.as_tensor(x) for x in recs), seed=3)
    assert got[0].shape == (jpm.MAX_PLANES, 14)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[2]) == int(want[2]) == max(int(recs[5].sum()) - jpm.MAX_PLANES, 0)


def brute_pairs(mode, pack, starts, counts, o, d, lim, bounce, mask, cell, r, min_b, max_b):
    """K7's pairs by the JAX loops' structure, one lane, one round, one
    neighbour cell and one slot at a time, in numpy float32 with every
    operation rounded on its own."""
    f = np.float32
    offs = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
    out = []
    cell, r = f(cell), f(r)

    def hsh(c):
        h = 0
        for ci, m in zip(c, (73856093, 19349663, 83492791)):
            h ^= ((int(ci) & 0xFFFFFFFF) * m) & 0xFFFFFFFF
        return h & ((1 << 20) - 1)

    def dot(a, b):
        return f(f(f(a[0] * b[0]) + f(a[1] * b[1])) + f(a[2] * b[2]))

    for lane in np.nonzero(mask)[0]:
        lo = o[lane]
        cv = np.floor(lo / cell).astype(np.int64)
        for off in offs:
            h = hsh(cv + np.asarray(off))
            for m in range(min(int(counts[h]), 32)):
                row = int(starts[h]) + m
                x = pack[row]
                fb = int(bounce[lane]) + int(x[9]) - 1
                if not (min_b <= fb < max_b):
                    continue
                e = (x[0:3] - lo).astype(f)
                if mode == "surface" and dot(e, e) < lim[lane]:
                    out.append((lane, row))
    return out


def test_walk_twin_surface_and_hist_against_brute_force():
    """K7's twin in surface mode equals the brute-force loop pair for pair,
    in (lane, offset, slot) order; its hist mode counts those pairs' bins."""
    from tungsten_tpu_torch.integrators.photon_map import build_photon_grid
    from tungsten_tpu_torch.ops import photon_walk

    pos, power, wi, valid, bounce = crowded_photons(3000, 6, cells=12, size=0.4)
    pack, starts, counts, _ = build_photon_grid(
        *(torch.as_tensor(x) for x in (pos, power, wi, valid)), 0.4,
        bounce=torch.as_tensor(bounce))
    gen = np.random.default_rng(7)
    n = 300
    gp = (pos[gen.integers(0, len(pos), n)] + gen.normal(0, 0.1, (n, 3))).astype(np.float32)
    r2 = np.full(n, np.float32(0.4) * np.float32(0.4), np.float32)
    r2[::3] *= np.float32(0.25)
    gb = gen.integers(1, 4, n).astype(np.int32)
    mask = gen.random(n) < 0.8
    args = (pack, starts, counts, torch.as_tensor(gp), None)
    lane, row = photon_walk.walk_twin("surface", *args, torch.as_tensor(r2), torch.as_tensor(gb),
                                      torch.as_tensor(mask), 0.4, 0.0, 0, 5)
    want = brute_pairs("surface", pack.numpy(), starts.numpy(), counts.numpy(), gp, None, r2, gb,
                       mask, 0.4, 0.0, 0, 5)
    assert len(want) > 1000
    assert list(zip(lane.tolist(), row.tolist())) == want
    assert photon_walk.walk_twin.work["pairs"] == len(want)
    r2_max = torch.full((n,), float(np.float32(0.4) * np.float32(0.4)))
    hist = photon_walk.walk_twin("hist", *args, r2_max, torch.as_tensor(gb),
                                 torch.as_tensor(mask), 0.4, 0.0, 0, 5)
    full = brute_pairs("surface", pack.numpy(), starts.numpy(), counts.numpy(), gp, None,
                       r2_max.numpy(), gb, mask, 0.4, 0.0, 0, 5)
    assert hist.shape == (n, 32) and int(hist.sum()) == len(full)
    np.testing.assert_array_equal(hist.sum(1).numpy(),
                                  np.bincount([p[0] for p in full], minlength=n))


@pytest.mark.parametrize("mode", ["points", "beams"])
def test_walk_twin_chunks_change_nothing(mode, monkeypatch):
    """The twin tests its candidate rows in runs of CANDIDATE_CHUNK (so a
    full-width call fits on the card); runs of 1,000 rows give the same
    pairs, floats and work, bit for bit."""
    from tungsten_tpu_torch.integrators.photon_map import build_photon_grid
    from tungsten_tpu_torch.ops import photon_walk

    pos, power, wi, valid, bounce = crowded_photons(3000, 6, cells=12, size=0.4)
    pack, starts, counts, _ = build_photon_grid(
        *(torch.as_tensor(x) for x in (pos, power, wi, valid)), 0.4,
        bounce=torch.as_tensor(bounce))
    if mode == "beams":  # stations: o, a direction, a length, power, bounce, medium, s0
        d = torch.nn.functional.normalize(pack[:, 6:9], dim=-1)
        pack = torch.cat([pack[:, 0:3], d, torch.full_like(pack[:, :1], 0.5), pack[:, 3:6],
                          pack[:, 9:10], torch.zeros_like(pack[:, :1]),
                          torch.full_like(pack[:, :1], 0.1)], 1)
    gen = np.random.default_rng(8)
    n = 300
    o = torch.as_tensor((pos[gen.integers(0, len(pos), n)]
                         + gen.normal(0, 0.2, (n, 3))).astype(np.float32))
    d = torch.nn.functional.normalize(
        torch.as_tensor(gen.normal(size=(n, 3)).astype(np.float32)), dim=-1)
    seg = torch.as_tensor(gen.uniform(0, 3, n), dtype=torch.float32)
    args = (mode, pack, starts, counts, o, d, seg, torch.ones(n, dtype=torch.int32),
            torch.as_tensor(gen.random(n) < 0.9), 0.8, 0.4, 0, 9)
    whole = photon_walk.walk_twin(*args)
    work = dict(photon_walk.walk_twin.work)
    monkeypatch.setattr(photon_walk, "CANDIDATE_CHUNK", 1000)
    runs = photon_walk.walk_twin(*args)
    assert work["tests"] > 10_000 and work["pairs"] > 0 and work["rounds"] > 1
    assert photon_walk.walk_twin.work == work
    assert all(torch.equal(a, b) for a, b in zip(whole, runs))
