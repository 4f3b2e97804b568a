"""The port's binary walk (K4) against the real Pallas kernels and brute force.

On the CPU the port's walk is its plain twin (`walk3_twin`); it is held
against the JAX package's three K4 kernels run unchanged in Pallas interpret
mode: `_walk_kernel4` through intersect_bvh_pallas3(rt=128, walks=2),
`_walk_kernel3` through _launch3(ordered=False) and `_walk_kernel3_any`
through occluded_bvh_pallas3(rt=128), on a pack built by the JAX package's
build_bvh_pack3. Both packages use the numpy BVH builder. Bars: prim (or
leaf slot) agrees on >= 99.9% of rays (expected 100%), t within rtol 1e-5
plus atol 1e-6 where it agrees (the plane form's numerator cancels to the
point-plane distance, so its error is absolute), occlusion on >= 99.9%.

The CUDA kernel itself is held against the twin in test_torch_cuda.py.
Its closest-hit walks test the BVH8 pack's plane leaves with K3's leaf
step, so here the twin's ordered and skip walks are held against K3's twin
(bvh8.walk_twin, no latch) on the same rays: the slot on all lanes but at
most one (a hit on an edge shared across leaves may tie), t bit for bit
where it agrees. The new kernel's bookkeeping (lanes park leaves, 32-lane
groups run leaf rounds, each member tested against its lim at that step)
is emulated in plain torch (`bvh2.coop_walk3`) and held bit for bit to the
twin in all three modes ("any" with every lane latched).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tungsten_tpu_torch.ops import bvh2, bvh8
from tungsten_tpu_torch.ops.intersect import TriangleSoA, intersect_brute
from test_torch_bvh8 import BAR, T_ATOL, T_RTOL, _agree_closest, _rays, _scene, _t


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    import tungsten_tpu.accel.bvh as jbvh
    import tungsten_tpu_torch.accel.bvh as tbvh
    from tungsten_tpu.ops.intersect import TriangleSoA as JTris
    from tungsten_tpu.ops.pallas_bvh2 import build_bvh_pack3 as jbuild3

    rng = np.random.default_rng(0xB2)
    v0, e1, e2 = _scene(rng)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbvh, "_NATIVE", False)
        mp.setattr(tbvh, "_NATIVE", False)
        mp.setattr(jbvh, "_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
        jpack = jbuild3(v0, e1, e2, leaf_size=128)
        tree = bvh8.tri_tree(v0, e1, e2, 128)
    arrays8 = bvh8.build_bvh_pack8(v0, e1, e2, tree, 128)
    arrays3 = bvh2.build_bvh_pack3(tree)
    pack8 = bvh8.Bvh8Pack.from_arrays(arrays8, torch.device("cpu"))
    pack = bvh2.Bvh3Pack.from_arrays(arrays3, pack8)
    jtris = JTris(v0=jnp.asarray(v0), e1=jnp.asarray(e1), e2=jnp.asarray(e2))
    tris = TriangleSoA(*(torch.as_tensor(a) for a in (v0, e1, e2)))
    return dict(jpack=jpack, arrays8=arrays8, arrays3=arrays3, pack8=pack8, pack=pack,
                jtris=jtris, tris=tris, rays=_rays(rng))


def test_pack_matches_jax_build_bvh_pack3(case):
    jpack, arrays3, arrays8, pack = case["jpack"], case["arrays3"], case["arrays8"], case["pack"]
    np.testing.assert_array_equal(arrays3["nf"], np.asarray(jpack.nf))
    np.testing.assert_array_equal(arrays3["ni"], np.asarray(jpack.ni))
    assert arrays3["nf"].dtype == np.float32 and arrays3["ni"].dtype == np.int32
    assert pack.n_nodes == jpack.n_nodes and pack.leaf == jpack.leaf == 128
    # the plane slabs and prim_map are pbvh8's, and equal to the JAX pack's
    np.testing.assert_array_equal(arrays8["planes"], np.asarray(jpack.planes))
    np.testing.assert_array_equal(arrays8["prim_map"], np.asarray(jpack.prim_map))
    p8 = case["pack8"]
    assert pack.prim_map is p8.prim_map and pack.tri_planes is p8.tri_planes
    # the walk's node-major copies
    np.testing.assert_array_equal(pack.box_t[:, :6].numpy(), arrays3["nf"].T)
    np.testing.assert_array_equal(pack.ni_t.numpy(), arrays3["ni"].T)


def test_twin_ordered_matches_pallas_k4(case):
    from jax.experimental.pallas import tpu as pltpu
    from tungsten_tpu.ops.pallas_bvh2 import intersect_bvh_pallas3

    rays = case["rays"]
    with pltpu.force_tpu_interpret_mode():
        hk = intersect_bvh_pallas3(case["jpack"], case["jtris"],
                                   *(jnp.asarray(a) for a in rays), rt=128, walks=2)
    ht = bvh2.intersect_bvh3(case["pack"], case["tris"], *_t(rays))
    _agree_closest(ht.prim.numpy(), ht.t.numpy(), np.asarray(hk.prim), np.asarray(hk.t),
                   "ordered vs _walk_kernel4")
    np.testing.assert_allclose(ht.u.numpy(), np.asarray(hk.u), rtol=T_RTOL, atol=1e-6)
    np.testing.assert_allclose(ht.v.numpy(), np.asarray(hk.v), rtol=T_RTOL, atol=1e-6)
    assert 0.2 < (ht.prim.numpy() >= 0).mean() < 0.9  # both outcomes occur


def test_twin_skip_matches_pallas_k4(case):
    from jax.experimental.pallas import tpu as pltpu
    from tungsten_tpu.ops.pallas_bvh2 import _launch3, _pack_rays

    jpack, rays = case["jpack"], case["rays"]
    n = rays[0].shape[0]
    rays_m, _, _ = _pack_rays(*(jnp.asarray(a) for a in rays), 128)
    with pltpu.force_tpu_interpret_mode():
        out = np.asarray(_launch3(rays_m, jpack.nf, jpack.ni, jpack.planes, jpack.n_nodes,
                                  leaf=jpack.leaf, rt=128, ordered=False))
    tk, lk = out[0, :n], out[1, :n].astype(np.int64)
    tt, lt = bvh2.walk3_twin(case["pack"], *_t(rays), mode="skip")
    _agree_closest(lt.numpy(), tt.numpy(), lk, tk, "skip vs _walk_kernel3")


def test_twin_any_matches_pallas_k4(case):
    from jax.experimental.pallas import tpu as pltpu
    from tungsten_tpu.ops.pallas_bvh2 import occluded_bvh_pallas3

    rays = case["rays"]
    with pltpu.force_tpu_interpret_mode():
        occ_k = np.asarray(occluded_bvh_pallas3(case["jpack"], *(jnp.asarray(a) for a in rays),
                                                rt=128))
    occ_t = bvh2.occluded_bvh3(case["pack"], *_t(rays)).numpy()
    assert (occ_t == occ_k).mean() >= BAR
    assert 0.2 < occ_t.mean() < 0.9


@pytest.mark.parametrize("mode", bvh2.MODES)
def test_twin_matches_brute_force(case, mode):
    rays = _t(case["rays"])
    hb = intersect_brute(case["tris"], *rays)
    if mode == "any":
        occ = bvh2.occluded_bvh3(case["pack"], *rays).numpy()
        assert (occ == (hb.prim.numpy() >= 0)).mean() >= BAR
        hit = occ
    else:
        ht = bvh2.intersect_bvh3(case["pack"], case["tris"], *rays, ordered=mode == "ordered")
        _agree_closest(ht.prim.numpy(), ht.t.numpy(), hb.prim.numpy(), hb.t.numpy(),
                       f"{mode} vs brute")
        hit = ht.prim.numpy() >= 0
    dead = case["rays"][3] <= case["rays"][2]
    assert dead.any() and not hit[dead].any()  # dead lanes do no work and miss


def test_any_hit_reports_a_hit_in_range(case):
    """The any walk's (t, slot) is a real hit of its ray within (tnear, tfar),
    and its slot hits wherever the closest walk found one."""
    o, d, tn, tf = _t(case["rays"])
    pack = case["pack"]
    t_any, l_any = bvh2.walk3_twin(pack, o, d, tn, tf, "any")
    _, l_cls = bvh2.walk3_twin(pack, o, d, tn, tf, "ordered")
    assert torch.equal(l_any >= 0, l_cls >= 0)
    got = l_any >= 0
    assert ((t_any[got] > tn[got]) & (t_any[got] < tf[got])).all()
    hb = intersect_brute(case["tris"], o, d, tn, tf)
    assert (t_any[got] >= hb.t[got] * (1 - T_RTOL) - T_ATOL).all()


def test_walk3_dispatches_by_device(case):
    """CPU tensors run the twin and count its launch; the kernel refuses
    them and its count does not move."""
    pack, rays = case["pack"], _t(case["rays"])
    k0, t0 = dict(bvh2.walk3_cuda.launches), dict(bvh2.walk3_twin.launches)
    for mode in bvh2.MODES:
        bvh2.walk3(pack, *rays, mode)
        assert bvh2.walk3_twin.launches[mode] == t0[mode] + 1
    assert bvh2.walk3_cuda.launches == k0
    with pytest.raises(ValueError):
        bvh2.walk3_cuda(pack, *rays)
    with pytest.raises(ValueError, match="mode"):
        bvh2.walk3(pack, *rays, "nearest")


@pytest.mark.parametrize("mode", ["ordered", "skip"])
def test_twin_matches_k3_twin(case, mode):
    """K4's closest-hit twin and K3's on one tree's plane leaves: the same
    slot on all lanes but at most one, t bit for bit where it agrees."""
    rays = _t(case["rays"])
    t4, l4 = bvh2.walk3_twin(case["pack"], *rays, mode)
    t3, l3 = bvh8.walk_twin(case["pack8"], *rays)
    same = l4 == l3
    assert int((~same).sum()) <= 1, f"{mode}: {int((~same).sum())} lanes differ"
    hit = same & (l4 >= 0)
    assert 0.2 < hit.float().mean().item() < 0.9
    assert torch.equal(t4[hit].view(torch.int32), t3[hit].view(torch.int32))


@pytest.mark.parametrize("mode", bvh2.MODES)
def test_coop_walk_matches_twin(case, mode):
    """The new kernel's schedule (park, then leaf rounds per 32-lane group
    with each member's lim at its step; "any" with every lane latched, its
    lim tfar, a member with a hit leaving its walk with its leaf's lowest
    hit slot and that slot's t) gives the twin's t and slot bit for bit,
    with the twin's box and slot tests: no node is tested before the leaf
    step it waits on, so every visit has the twin's limit. An unknown mode
    raises."""
    rays = _t(case["rays"])
    tc, lc = bvh2.coop_walk3(case["pack"], *rays, mode)
    tt, lt = bvh2.walk3_twin(case["pack"], *rays, mode)
    assert bvh2.coop_walk3.work == bvh2.walk3_twin.work
    assert torch.equal(lc, lt)
    assert torch.equal(tc.view(torch.int32), tt.view(torch.int32))
    assert 0.2 < (lc >= 0).float().mean().item() < 0.9
    with pytest.raises(ValueError, match="mode"):
        bvh2.coop_walk3(case["pack"], *rays, "nearest")


def test_kernels_refuse_cpu_tensors_and_other_leaf_widths(case):
    """The kernel and its first form refuse CPU tensors in every mode, and
    the kernel a pack whose leaves are not 128 wide; no count moves."""
    pack, rays = case["pack"], _t(case["rays"])
    k0, v0 = dict(bvh2.walk3_cuda.launches), dict(bvh2.walk3_cuda_v1.launches)
    for mode in bvh2.MODES:
        with pytest.raises(ValueError, match="CUDA"):
            bvh2.walk3_cuda_v1(pack, *rays, mode)
        with pytest.raises(ValueError, match="128"):
            bvh2.walk3_cuda(dataclasses.replace(pack, leaf=64), *rays, mode)
    assert bvh2.walk3_cuda.launches == k0 and bvh2.walk3_cuda_v1.launches == v0


def _chain(depth):
    """A binary chain: every inner node has one leaf child and one inner child."""
    from tungsten_tpu_torch.accel.bvh import BvhArrays

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
    return BvhArrays(node_min=np.zeros((m, 3), np.float32), node_max=np.ones((m, 3), np.float32),
                     first=np.zeros(m, np.int32), count=count, skip=skip,
                     prim_order=np.zeros(1, np.int32))


def test_stack_depth_is_checked(case):
    """The ordered walk's stack holds STACK_DEPTH entries: a tree deeper
    than that is refused when the pack is made (pallas_bvh2.py has no such
    check), one just within it is taken."""
    pack8 = case["pack8"]

    def pack_of(depth):
        arrays = bvh2.build_bvh_pack3(_chain(depth))
        arrays["ni"][0] = 0  # every leaf reads block 0 of pack8's planes
        return bvh2.Bvh3Pack.from_arrays(arrays, pack8)

    assert bvh2.tree_depth(_chain(7).count, _chain(7).skip) == 7
    assert pack_of(bvh2.STACK_DEPTH).n_nodes == 2 * bvh2.STACK_DEPTH + 1
    with pytest.raises(ValueError, match="STACK_DEPTH"):
        pack_of(bvh2.STACK_DEPTH + 1)


def test_malformed_node_table_is_refused(case):
    arrays = dict(case["arrays3"])
    ni = arrays["ni"].copy()
    ni[2, 1] = 1  # a skip pointer that does not move forward
    with pytest.raises(ValueError, match="malformed"):
        bvh2.Bvh3Pack.from_arrays({**arrays, "ni": ni}, case["pack8"])
    ni = arrays["ni"].copy()
    ni[0, ni[1] > 0] = 10 ** 6  # leaf blocks past the planes
    with pytest.raises(ValueError, match="leaf blocks"):
        bvh2.Bvh3Pack.from_arrays({**arrays, "ni": ni}, case["pack8"])
