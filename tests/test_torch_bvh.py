"""The port's packet-pack walk (K5) against the real Pallas kernel and brute force.

On the CPU the port's walk is its plain twin (`walk_packet_twin`); it is held
against the JAX package's K5-v2 kernel `_walk_kernel2` run unchanged in
Pallas interpret mode (intersect_bvh_pallas, V2 = True), and in its v1 mode
(prune=False) against `_walk_kernel` (intersect_bvh_pallas with V2
monkeypatched to False in the test only), on a pack built by the JAX
package's build_bvh_pack; both packages use the numpy BVH builder.
Bars: prim agrees on >= 99.9% of rays (expected 100%: the lockstep tile and
the per-ray walk differ only where rounding puts a hit on a box boundary),
t within rtol 1e-5 plus atol 1e-6 and u / v within atol 1e-5 where it
agrees. Both compute Moller-Trumbore in the same order of operations, but
u = (tv . p) / det cancels: its rounding error is about eps |tv| |p| / |det|,
~4e-6 for the camera rays here, whose origins lie ~6 units from the
triangles. The twin rounds every operation as IEEE f32 does (it equals a
numpy f32 evaluation bit for bit); XLA's interpret run contracts
multiply-adds, and the port's brute force sums in another order. The
largest u / v difference measured here is 2.0e-6.

The CUDA kernel itself is held against the twin in test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tungsten_tpu_torch.ops import bvh, bvh8
from tungsten_tpu_torch.ops.intersect import TriangleSoA, intersect_brute
from test_torch_bvh8 import BAR, _agree_closest, _rays, _scene, _t

UV_ATOL = 1e-5


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    import tungsten_tpu.accel.bvh as jbvh
    import tungsten_tpu_torch.accel.bvh as tbvh
    from tungsten_tpu.ops.pallas_bvh import build_bvh_pack as jbuild

    rng = np.random.default_rng(0xB5)
    v0, e1, e2 = _scene(rng)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbvh, "_NATIVE", False)
        mp.setattr(tbvh, "_NATIVE", False)
        mp.setattr(jbvh, "_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
        jpack = jbuild(v0, e1, e2)
        arrays = bvh.build_bvh_pack(v0, e1, e2, bvh8.tri_tree(v0, e1, e2, bvh.LEAF))
    pack = bvh.BvhPack.from_arrays(arrays, jpack.n_nodes, torch.device("cpu"))
    tris = TriangleSoA(*(torch.as_tensor(a) for a in (v0, e1, e2)))
    return dict(jpack=jpack, arrays=arrays, pack=pack, tris=tris, rays=_rays(rng))


def test_pack_matches_jax_build_bvh_pack(case):
    jpack, arrays, pack = case["jpack"], case["arrays"], case["pack"]
    for k in ("nodes", "tris", "prim_map"):
        a, b = arrays[k], np.asarray(getattr(jpack, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    # the walk's copies: node-major rows with integer fields, leaf-major slots
    m = jpack.n_nodes
    node16 = arrays["nodes"].reshape(-1, 16, 128).transpose(0, 2, 1).reshape(-1, 16)[:m]
    np.testing.assert_array_equal(pack.box_t[:, :6].numpy(), node16[:, :6])
    np.testing.assert_array_equal(pack.ni_t[:, :3].numpy(), node16[:, 6:9].astype(np.int32))
    assert pack.n_nodes == m and (pack.ni_t[:, 2] > torch.arange(m)).all()
    n_leaves = arrays["tris"].shape[0] // 16
    assert tuple(pack.tri_t.shape) == (n_leaves, 128, 9)
    np.testing.assert_array_equal(pack.tri_t[:, :, 3:6].numpy(),
                                  arrays["tris"].reshape(n_leaves, 16, 128)[:, 3:6].transpose(0, 2, 1))


def test_twin_matches_pallas_k5(case):
    from jax.experimental.pallas import tpu as pltpu
    from tungsten_tpu.ops import pallas_bvh

    assert pallas_bvh.V2  # the kernel intersect_bvh_pallas runs is _walk_kernel2
    rays = case["rays"]
    with pltpu.force_tpu_interpret_mode():
        hk = pallas_bvh.intersect_bvh_pallas(case["jpack"], *(jnp.asarray(a) for a in rays))
    ht = bvh.intersect_bvh(case["pack"], *_t(rays))
    pk, pt = np.asarray(hk.prim), ht.prim.numpy()
    _agree_closest(pt, ht.t.numpy(), pk, np.asarray(hk.t), "vs _walk_kernel2")
    same = pk == pt
    np.testing.assert_allclose(ht.u.numpy()[same], np.asarray(hk.u)[same], rtol=0, atol=UV_ATOL)
    np.testing.assert_allclose(ht.v.numpy()[same], np.asarray(hk.v)[same], rtol=0, atol=UV_ATOL)
    assert 0.2 < (pt >= 0).mean() < 0.9  # both outcomes occur


def test_twin_v1_matches_pallas_k5_v1(case, monkeypatch):
    """K5-v1 (no best-t pruning in the box tests): the same closest hit, by
    more leaf visits."""
    from jax.experimental.pallas import tpu as pltpu
    from tungsten_tpu.ops import pallas_bvh

    monkeypatch.setattr(pallas_bvh, "V2", False)  # intersect_bvh_pallas runs _walk_kernel
    monkeypatch.setattr(bvh, "V2", False)  # and intersect_bvh its v1 mode
    rays = case["rays"]
    with pltpu.force_tpu_interpret_mode():
        hk = pallas_bvh.intersect_bvh_pallas(case["jpack"], *(jnp.asarray(a) for a in rays))
    v1_0 = bvh.walk_packet_twin.launches["v1"]
    ht = bvh.intersect_bvh(case["pack"], *_t(rays))
    assert bvh.walk_packet_twin.launches["v1"] == v1_0 + 1
    leaves_v1 = bvh.walk_packet_twin.work["tri"]
    pk, pt = np.asarray(hk.prim), ht.prim.numpy()
    _agree_closest(pt, ht.t.numpy(), pk, np.asarray(hk.t), "vs _walk_kernel")
    same = pk == pt
    np.testing.assert_allclose(ht.u.numpy()[same], np.asarray(hk.u)[same], rtol=0, atol=UV_ATOL)
    np.testing.assert_allclose(ht.v.numpy()[same], np.asarray(hk.v)[same], rtol=0, atol=UV_ATOL)
    # the same hits as v2, with at least as many leaf slots tested
    monkeypatch.setattr(bvh, "V2", True)
    h2 = bvh.intersect_bvh(case["pack"], *_t(rays))
    np.testing.assert_array_equal(h2.prim.numpy(), pt)
    assert leaves_v1 >= bvh.walk_packet_twin.work["tri"] > 0


def test_twin_matches_brute_force(case):
    rays = _t(case["rays"])
    ht = bvh.intersect_bvh(case["pack"], *rays)
    hb = intersect_brute(case["tris"], *rays)
    _agree_closest(ht.prim.numpy(), ht.t.numpy(), hb.prim.numpy(), hb.t.numpy(), "vs brute")
    same = (ht.prim == hb.prim).numpy()
    np.testing.assert_allclose(ht.u.numpy()[same], hb.u.numpy()[same], rtol=0, atol=UV_ATOL)
    np.testing.assert_allclose(ht.v.numpy()[same], hb.v.numpy()[same], rtol=0, atol=UV_ATOL)
    dead = case["rays"][3] <= case["rays"][2]
    assert dead.any() and (ht.prim.numpy()[dead] == -1).all()
    assert (ht.u.numpy()[dead] == 0).all() and (ht.t.numpy()[dead] == 3.0e38).all()


def test_padding_slots_never_win(case):
    """No ray reports a padding slot, which prim_map would send to triangle 0."""
    pack, arrays = case["pack"], case["arrays"]
    _, local, _, _ = bvh.walk_packet_twin(pack, *_t(case["rays"]))
    n_leaves = arrays["tris"].shape[0] // 16
    filled = np.abs(arrays["tris"].reshape(n_leaves, 16, 128)[:, 3:9]).sum(1).ravel() > 0
    got = local.numpy()[local.numpy() >= 0]
    assert filled[got].all()


def test_walk_packet_dispatches_by_device(case):
    pack, rays = case["pack"], _t(case["rays"])
    k0, t0 = dict(bvh.walk_packet_cuda.launches), dict(bvh.walk_packet_twin.launches)
    bvh.walk_packet(pack, *rays)
    bvh.walk_packet(pack, *rays, prune=False)
    assert bvh.walk_packet_twin.launches == {"v1": t0["v1"] + 1, "v2": t0["v2"] + 1}
    assert bvh.walk_packet_cuda.launches == k0
    for prune in (True, False):
        with pytest.raises(ValueError):
            bvh.walk_packet_cuda(pack, *rays, prune=prune)


def test_from_arrays_checks_the_node_table(case):
    arrays, m = case["arrays"], case["jpack"].n_nodes
    with pytest.raises(ValueError):
        bvh.BvhPack.from_arrays(arrays, m + 200, torch.device("cpu"))  # past the padding
    nodes = arrays["nodes"].copy()
    nodes[8, 1] = 0.0  # node 1's skip points backwards
    with pytest.raises(ValueError, match="malformed"):
        bvh.BvhPack.from_arrays({**arrays, "nodes": nodes}, m, torch.device("cpu"))
