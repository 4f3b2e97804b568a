"""The port's BVH8 walk (K3) against the real Pallas kernel and brute force.

On the CPU the port's walk is its plain twin (`walk_twin`); it is held
against the JAX package's K3 kernel `_walk_kernel8` run unchanged in Pallas
interpret mode (intersect_bvh_pallas8(fast=False) / occluded_bvh_pallas8;
the fast walk has its own file, test_torch_bvh8_fast.py),
on a pack built by the JAX package's build_bvh_pack8, and against
intersect_brute. Bars: prim agrees on >= 99.9% of rays (expected 100%), t
within rtol 1e-5 where prim agrees, occlusion agrees on >= 99.9%. The t bar
has an absolute floor of 1e-6: the plane form's numerator N.o + nc cancels
to the point-plane distance, so its rounding error is absolute, about eps
times the scene extent (~5e-7 here), and dominates on short hits.

The CUDA kernel itself is held against the twin in test_torch_cuda.py. Its
leaf step (the 128 slots split across the 32 lanes, the warp's minimum over
an unsigned key of t and the slot) is emulated in plain torch
(`bvh8.coop_leaf_step`, `coop_merge`) and held here, bit for bit, to the
twin's rule (`bvh8.leaf_merge`) on ties, NaN slots, latched rays and the
"strictly nearer" rule across leaves.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tungsten_tpu_torch.ops import bvh8
from tungsten_tpu_torch.ops.intersect import TriangleSoA

BAR = 0.999
T_RTOL = 1e-5
T_ATOL = 1e-6


def _scene(rng, n_tris=600):
    v0 = rng.uniform(-2.0, 2.0, (n_tris, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.4, (n_tris, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.4, (n_tris, 3)).astype(np.float32)
    e2[::50] = e1[::50] * 2.0  # degenerate slots: all-zero planes
    return v0, e1, e2


def _rays(rng, n_random=384, n_camera=256):
    """Random incoherent rays plus a pinhole-like camera fan, with dead lanes."""
    o = rng.uniform(-3.0, 3.0, (n_random, 3))
    d = rng.normal(size=(n_random, 3))
    eye = np.array([0.3, 0.5, 6.0])
    tgt = rng.uniform(-1.5, 1.5, (n_camera, 3)) * np.array([1.0, 1.0, 0.0])
    o = np.concatenate([o, np.broadcast_to(eye, (n_camera, 3))])
    d = np.concatenate([d, tgt - eye])
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    n = len(o)
    tnear = np.full(n, 1e-4)
    tfar = np.full(n, 3.0e38)
    tfar[::9] = 0.0  # dead lanes: tnear >= tfar
    tfar[5::9] = rng.uniform(0.5, 4.0, len(tfar[5::9]))  # bounded segments
    return [np.ascontiguousarray(a, np.float32) for a in (o, d, tnear, tfar)]


@pytest.fixture(scope="module")
def case():
    from tungsten_tpu.ops.intersect import TriangleSoA as JTris
    from tungsten_tpu.ops.pallas_bvh8 import build_bvh_pack8

    rng = np.random.default_rng(0xB8)
    v0, e1, e2 = _scene(rng)
    jpack = build_bvh_pack8(v0, e1, e2, leaf_size=128)
    pack = bvh8.Bvh8Pack.from_arrays(
        {k: np.asarray(getattr(jpack, k)) for k in ("boxes", "kid", "order", "planes", "prim_map")},
        torch.device("cpu"))
    jtris = JTris(v0=jnp.asarray(v0), e1=jnp.asarray(e1), e2=jnp.asarray(e2))
    tris = TriangleSoA(*(torch.as_tensor(a) for a in (v0, e1, e2)))
    return jpack, jtris, pack, tris, _rays(rng)


def _t(arrs):
    return [torch.as_tensor(a) for a in arrs]


def _agree_closest(prim_a, t_a, prim_b, t_b, label):
    same = prim_a == prim_b
    assert same.mean() >= BAR, f"{label}: prim agrees on {same.mean():.4%}"
    hit = same & (prim_a >= 0)
    np.testing.assert_allclose(t_a[hit], t_b[hit], rtol=T_RTOL, atol=T_ATOL, err_msg=label)


def test_twin_matches_pallas_k3(case):
    from jax.experimental.pallas import tpu as pltpu
    from tungsten_tpu.ops.pallas_bvh8 import intersect_bvh_pallas8, occluded_bvh_pallas8

    jpack, jtris, pack, tris, rays = case
    jr = [jnp.asarray(a) for a in rays]
    with pltpu.force_tpu_interpret_mode():
        hk = intersect_bvh_pallas8(jpack, jtris, *jr, rt=128, walks=1, fast=False)
        occ_k = np.asarray(occluded_bvh_pallas8(jpack, *jr, rt=128, walks=1))
    ht = bvh8.intersect(pack, tris, *_t(rays), fast=False)
    _agree_closest(ht.prim.numpy(), ht.t.numpy(), np.asarray(hk.prim), np.asarray(hk.t), "vs K3")
    np.testing.assert_allclose(ht.u.numpy(), np.asarray(hk.u), rtol=T_RTOL, atol=1e-6)
    np.testing.assert_allclose(ht.v.numpy(), np.asarray(hk.v), rtol=T_RTOL, atol=1e-6)
    occ_t = bvh8.occluded(pack, *_t(rays)).numpy()
    assert (occ_t == occ_k).mean() >= BAR
    assert 0.2 < occ_t.mean() < 0.9  # the case exercises both outcomes


def test_twin_matches_brute_force(case):
    from tungsten_tpu_torch.ops.intersect import intersect_brute

    _, _, pack, tris, rays = case
    ht = bvh8.intersect(pack, tris, *_t(rays), fast=False)
    hb = intersect_brute(tris, *_t(rays))
    _agree_closest(ht.prim.numpy(), ht.t.numpy(), hb.prim.numpy(), hb.t.numpy(), "vs brute")
    occ = bvh8.occluded(pack, *_t(rays)).numpy()
    assert (occ == (hb.prim.numpy() >= 0)).mean() >= BAR
    # dead lanes do no work and report a miss
    dead = rays[3] <= rays[2]
    assert (ht.prim.numpy()[dead] == -1).all() and not occ[dead].any()


def test_port_brute_force_matches_jax_brute_force(case):
    from tungsten_tpu.ops.intersect import intersect_brute as jbrute
    from tungsten_tpu_torch.ops.intersect import intersect_brute

    _, jtris, _, tris, rays = case
    hj = jbrute(jtris, *(jnp.asarray(a) for a in rays))
    ht = intersect_brute(tris, *_t(rays))
    np.testing.assert_array_equal(ht.prim.numpy(), np.asarray(hj.prim))
    hit = ht.prim.numpy() >= 0
    np.testing.assert_allclose(ht.t.numpy()[hit], np.asarray(hj.t)[hit], rtol=T_RTOL, atol=T_ATOL)


def test_mixed_latch_gives_closest_hit_booleans(case):
    """The merged shadow + next-ray walk: latched lanes stop at their first
    hit, yet report the same `blocked = prim >= 0` as an all-closest walk
    (the TPU configuration's merged walk), and unlatched lanes are exact
    closest hits."""
    _, _, pack, tris, rays = case
    o, d, tn, tf = _t(rays)
    n = o.shape[0]
    latch = torch.arange(n) % 2 == 0
    hm = bvh8.intersect_mixed(pack, tris, o, d, tn, tf, latch)
    hc = bvh8.intersect(pack, tris, o, d, tn, tf, fast=False)
    np.testing.assert_array_equal((hm.prim >= 0).numpy(), (hc.prim >= 0).numpy())
    free = ~latch
    np.testing.assert_array_equal(hm.prim[free].numpy(), hc.prim[free].numpy())
    np.testing.assert_array_equal(hm.t[free].numpy(), hc.t[free].numpy())


def test_walk_dispatches_by_device(case):
    """CPU tensors run the twin and count its launch; the kernel's count
    moves only where it launches."""
    _, _, pack, _, rays = case
    k0, t0 = bvh8.walk_cuda.launches, bvh8.walk_twin.launches
    bvh8.walk(pack, *_t(rays))
    assert bvh8.walk_twin.launches == t0 + 1 and bvh8.walk_cuda.launches == k0
    with pytest.raises(ValueError):
        bvh8.walk_cuda(pack, *_t(rays))  # CPU tensors are refused, not served


def test_pack_stack_bound_is_checked():
    """The per-ray stack holds DEPTH entries; a tree too deep for it is
    refused at build time (pallas_bvh8.py:454's assert)."""
    from tungsten_tpu_torch.accel.bvh import BvhArrays

    # a binary chain: every inner node has one leaf child and one inner child
    depth = 8 * (bvh8.DEPTH // 8 + 4)  # each 8-ary node spans 7 chain levels
    m = 2 * depth + 1
    count = np.zeros(m, np.int32)
    skip = np.zeros(m, np.int32)
    for i in range(depth):
        left, right = 2 * i + 1, 2 * i + 2
        count[left] = 1
        skip[left] = right
        skip[2 * i] = m
    count[m - 1] = 1
    skip[m - 1] = m
    bvh = BvhArrays(node_min=np.zeros((m, 3), np.float32), node_max=np.ones((m, 3), np.float32),
                    first=np.zeros(m, np.int32), count=count, skip=skip,
                    prim_order=np.zeros(1, np.int32))
    with pytest.raises(ValueError, match="DEPTH"):
        bvh8._collapse8(bvh, np.cumsum(count > 0) - 1)


def test_order_key_orders_like_floats():
    """The kernels' key: a < b on f32 (no NaN) iff key(a) < key(b); -0 and
    +0 tie, as they compare."""
    rng = np.random.default_rng(11)
    x = np.concatenate([rng.normal(0, 1, 500) * 10.0 ** rng.integers(-30, 30, 500),
                        [0.0, -0.0, 1e-45, -1e-45, 3e38, -3e38, np.inf, -np.inf]])
    t = torch.as_tensor(x.astype(np.float32))
    k = bvh8.order_key(t)
    assert bool(((k >= 0) & (k < bvh8.NONE_KEY)).all())
    a, b = np.meshgrid(np.arange(len(x)), np.arange(len(x)))
    np.testing.assert_array_equal((t[a] < t[b]).numpy(), (k[a] < k[b]).numpy())
    np.testing.assert_array_equal((t[a] == t[b]).numpy(), (k[a] == k[b]).numpy())


def _leaf_results(rng, k, latch_share, with_nan=True):
    """k rays' slot results on one leaf: t from a few values (ties), NaN on
    a share of slots (all-zero planes), hits on a random share."""
    t = rng.choice(np.float32([0.25, 0.5, 0.5000001, 1.0, -0.0, 0.0, 2.0]), size=(k, bvh8.LEAF))
    if with_nan:
        t[rng.random((k, bvh8.LEAF)) < 0.3] = np.nan
    h = (rng.random((k, bvh8.LEAF)) < rng.uniform(0.0, 0.2, (k, 1))) & ~np.isnan(t)
    h[0] = False  # a ray that hits nothing
    latched = rng.random(k) < latch_share
    return torch.as_tensor(t), torch.as_tensor(h), torch.as_tensor(latched)


@pytest.mark.parametrize("latch_share", [0.0, 1.0, 0.5])
def test_coop_leaf_step_matches_the_walk_rule(latch_share):
    """One leaf: the lane-split step and its write-back give the twin's
    best, slot and done, bit for bit, closest / latched / mixed."""
    rng = np.random.default_rng(int(latch_share * 10) + 3)
    t, h, latched = _leaf_results(rng, 400, latch_share)
    best = torch.full((400,), bvh8.INF)
    local = torch.full((400,), -1, dtype=torch.int64)
    t_win, slot = bvh8.coop_leaf_step(t, h, latched)
    got = bvh8.coop_merge(t_win, slot, latched, best, local, 7 * bvh8.LEAF, fast=False)
    want = bvh8.leaf_merge(t, h, latched, best, local, 7 * bvh8.LEAF)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b)
    hit = slot >= 0
    assert 0.3 < hit.float().mean().item() < 1.0 and not bool(hit[0])


def test_coop_leaf_step_latched_t_is_the_lowest_hit_slots():
    """A latched ray's leaf step reports its lowest hit slot with that
    slot's own t (what K4-any's walker keeps), not the t of the lane that
    holds the closest hit; an unlatched ray's t stays the least t."""
    rng = np.random.default_rng(17)
    t, h, _ = _leaf_results(rng, 400, 0.0, with_nan=False)
    t = t + torch.as_tensor(rng.uniform(0.0, 1e-3, t.shape).astype(np.float32))  # no ties
    for latched in (torch.ones(400, dtype=torch.bool), torch.zeros(400, dtype=torch.bool)):
        t_win, slot = bvh8.coop_leaf_step(t, h, latched)
        hit = h.any(dim=1)
        assert torch.equal(slot >= 0, hit) and not bool(hit[0])
        lowest = torch.argmax(h.to(torch.uint8), dim=1)
        want_slot = lowest if bool(latched[0]) else torch.where(h, t, bvh8.INF).argmin(dim=1)
        assert torch.equal(slot[hit], want_slot[hit])
        want_t = t.gather(1, want_slot[:, None])[:, 0]
        assert torch.equal(t_win[hit].view(torch.int32), want_t[hit].view(torch.int32))
        assert bool((t_win[~hit] == bvh8.INF).all())
    # the two rules part on most rays that hit twice or more
    t_l, _ = bvh8.coop_leaf_step(t, h, torch.ones(400, dtype=torch.bool))
    t_c, _ = bvh8.coop_leaf_step(t, h, torch.zeros(400, dtype=torch.bool))
    assert int((t_l[hit] != t_c[hit]).sum()) > 100


@pytest.mark.parametrize("fast", [False, True])
def test_coop_merge_across_leaves_matches_the_walk_rule(fast):
    """A sequence of leaves: each accepts t only below the ray's limit (the
    fast rule with 1e-3 slack above it, so a later leaf may offer a t that
    is not strictly nearer); the emulated steps and the twin's rule keep the
    same best and slot after every leaf."""
    rng = np.random.default_rng(5 + fast)
    k = 300
    latched = torch.zeros(k, dtype=torch.bool) if fast else torch.as_tensor(rng.random(k) < 0.3)
    tfar = torch.as_tensor(rng.uniform(1.0, 4.0, k).astype(np.float32))
    state_c = (torch.full((k,), bvh8.INF), torch.full((k,), -1, dtype=torch.int64))
    state_t = state_c
    taken = refused = 0
    for leaf in range(12):
        best = state_t[0]
        lim = torch.minimum(tfar, best) * (bvh8.ONE_PLUS_E_T if fast else 1.0)
        t = torch.as_tensor(rng.uniform(0.0, 4.0, (k, bvh8.LEAF)).astype(np.float32))
        t[:, :8] = best[:, None]  # slots that tie with the best so far
        h = (t < lim[:, None]) & torch.as_tensor(rng.random((k, bvh8.LEAF)) < 0.05)
        t_win, slot = bvh8.coop_leaf_step(t, h, latched)
        done_c = state_c[0] == 0.0
        new_c = bvh8.coop_merge(t_win, slot, latched, *state_c, leaf * bvh8.LEAF, fast)
        new_t = bvh8.leaf_merge(t, h, latched, *state_t, leaf * bvh8.LEAF)
        # a latched ray that is done walks no further leaves
        state_c = tuple(torch.where(done_c & latched, a, b) for a, b in zip(state_c, new_c[:2]))
        state_t = tuple(torch.where(done_c & latched, a, b) for a, b in zip(state_t, new_t[:2]))
        assert torch.equal(state_c[0], state_t[0]) and torch.equal(state_c[1], state_t[1])
        taken += int((slot >= 0).sum())
        refused += int(((slot >= 0) & (t_win >= best) & ~latched).sum())
    assert taken > k and bool((state_t[1] >= 0).any())
    # the fast rule's slack lets a leaf offer a hit no nearer than the best:
    # both refuse it; the exact rule never offers one
    assert (refused > 0) == fast


def test_cuda_walks_refuse_other_leaf_widths(case):
    """The warp-cooperative kernels are built for 128-slot leaves; a pack of
    another width is refused before anything launches."""
    _, _, pack, _, rays = case
    narrow = dataclasses.replace(pack, leaf=64)
    for walk in (bvh8.walk_cuda, bvh8.walk_fast_cuda):
        with pytest.raises(ValueError, match="128"):
            walk(narrow, *_t(rays))
