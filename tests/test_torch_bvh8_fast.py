"""The port's fast BVH8 walk (K3-fast) against the real Pallas kernel.

On the CPU the port's fast walk is its plain twin (`walk_fast_twin`): the
bf16x3 leaf product without the lo.lo pass, the slack on the accept rule and
on the prune. It is held against the JAX package's `_walk_kernel8` with
fast=True, run unchanged in Pallas interpret mode, on the pack that the JAX
package's build_bvh_pack8 makes of the `small` scene (the 2,000-triangle
ball, the floor and the cube), for random incoherent rays and camera rays.

Bars. The matrix unit's order of additions is not the twin's, so the raw
comparison is statistical: the raw slot agrees on >= 99.9% of the rays on
which neither walk's winner is a phantom, and the raw t within 1e-3
relative where it does. Phantoms are where the two walks differ by design:
the Pallas kernel evaluates a leaf for its whole 128-ray tile once any ray
of the tile enters the leaf's box, so a ray that passes outside the box but
inside the edge slack (0.02 of a 12-unit floor quad is 0.24 units) finds a
phantom there that the per-ray walk, which never enters that box, does not.
Over all rays the raw slot agrees on >= 99.5% (99.79% measured), and every
lane that differs holds a phantom in one of the two walks. (Phantom winners
are common on a convex mesh, about 4% of these rays: a neighbour's plane,
extended past the shared edge, lies in front of the surface.) The queries
(validate the winner in exact f32, re-trace the phantoms with the exact walk) return exact f32
recomputations on both sides: prim agrees on >= 99.9%, and t, u, v within
1e-5 where prim agrees (absolute floor 1e-6 on t, the rounding of the
Moller-Trumbore numerator at this scene's extent). fast=True against
fast=False: >= 99.99% of prim; the fast query may keep a validated hit up
to 1e-3 relative farther than the nearest one (the prune's slack).

The CUDA kernel itself is held against the twin in test_torch_cuda.py. Its
tensor-core operands are emulated here from the kernel's own fragment
indexing (`bvh8.ray_words`, `bvh8.mma_leaf_products`): the product of the A
rows [c_hi | c_hi | c_lo | 0] and the B columns [r_hi | r_lo | r_hi | 0]
must give `_dot3`'s six dot products of every slot, each read back at the
slot and plane the kernel reads it as, to f32 rounding of the sum (rtol
1e-6 of the sum of the terms' magnitudes: the tensor core sums in its own
order, the twin in a fixed one).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tungsten_tpu_torch.ops import bvh8
from tungsten_tpu_torch.ops.intersect import INF, TriangleSoA, intersect_brute

BAR = 0.999


def _rays(rng, scene, n_random=768):
    """Random incoherent rays around the scene plus the camera's rays (one
    per pixel of 64x48), with dead lanes and bounded segments."""
    from tungsten_tpu_torch.models.cameras.pinhole import camera_rays_w

    o = rng.uniform(-4.0, 4.0, (n_random, 3)) + np.array([0.0, 2.0, 0.0])
    d = rng.normal(size=(n_random, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    meta = scene.meta
    py, px = np.divmod(np.arange(meta.res_x * meta.res_y), meta.res_x)
    oc, dc, _ = camera_rays_w(scene.camera, meta, torch.as_tensor(px), torch.as_tensor(py),
                              torch.as_tensor(rng.uniform(size=(len(px), 2)), dtype=torch.float32))
    o = np.concatenate([o, oc.numpy()])
    d = np.concatenate([d, dc.numpy()])
    n = len(o)
    tfar = np.full(n, 3.0e38)
    tfar[::9] = 0.0  # dead lanes
    tfar[5::9] = rng.uniform(2.0, 9.0, len(tfar[5::9]))  # bounded segments
    return [np.ascontiguousarray(a, np.float32) for a in (o, d, np.full(n, 1e-4), tfar)]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    import tungsten_tpu.accel.bvh as jbvh
    import tungsten_tpu_torch.accel.bvh as tbvh
    from tungsten_tpu.ops.intersect import TriangleSoA as JTris
    from tungsten_tpu.ops.pallas_bvh8 import build_bvh_pack8
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    mp = pytest.MonkeyPatch()
    mp.setattr(jbvh, "_NATIVE", False)
    mp.setattr(tbvh, "_NATIVE", False)
    mp.setattr(jbvh, "_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    path = synth.write_scene(str(tmp_path_factory.mktemp("small")), "small")
    scene = flatten_scene(load_scene(path), torch.device("cpu"))
    v0, e1, e2 = (x.numpy() for x in (scene.tris.v0, scene.tris.e1, scene.tris.e2))
    jpack = build_bvh_pack8(v0, e1, e2, leaf_size=128)
    mp.undo()
    arrays = {k: np.asarray(getattr(jpack, k)) for k in ("boxes", "kid", "order", "planes", "prim_map")}
    bits = {k: np.asarray(getattr(jpack, k)).view(np.uint16) for k in ("planes_hi", "planes_lo")}
    jtris = JTris(v0=jnp.asarray(v0), e1=jnp.asarray(e1), e2=jnp.asarray(e2))
    return dict(jpack=jpack, jtris=jtris, arrays=arrays, bits=bits, scene=scene,
                pack=bvh8.Bvh8Pack.from_arrays(arrays, torch.device("cpu")), tris=scene.tris,
                rays=_rays(np.random.default_rng(0xF8), scene))


def _t(arrs):
    return [torch.as_tensor(a) for a in arrs]


def _bits(x):
    return x.view(torch.int16).numpy().view(np.uint16)


def test_plane_split_is_bit_equal_to_jax(case):
    """hi = bf16(p), lo = bf16(p - f32(hi)), round to nearest even: the
    port's split of the f32 planes, the scene's own pack, and the JAX
    tables carried across as uint16 bit patterns are the same bits."""
    L = case["pack"].leaf
    n_leaves = case["arrays"]["planes"].shape[0] // 8

    def per_slot(bits):
        return bits.reshape(n_leaves, 8, 3, L)[:, :4].transpose(0, 3, 2, 1).reshape(n_leaves, L, 12)

    carried = bvh8.Bvh8Pack.from_arrays({**case["arrays"], **case["bits"]}, torch.device("cpu"))
    for pack in (case["pack"], case["scene"].pbvh8, carried):
        assert pack.tri_planes_hi.dtype == pack.tri_planes_lo.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(pack.tri_planes_hi), per_slot(case["bits"]["planes_hi"]))
        np.testing.assert_array_equal(_bits(pack.tri_planes_lo), per_slot(case["bits"]["planes_lo"]))
    assert (_bits(case["pack"].tri_planes_lo) != 0).mean() > 0.3  # the split is not trivial


def _repair_lanes(case, rays, slot):
    """The lanes the query walks again when its fast walk returns `slot`:
    those it hands to the exact walk with their tfar left above 0."""
    seen = []

    def exact_walk(pack, o, d, tnear, tfar):
        seen.append(tfar)
        return bvh8.walk_twin(pack, o, d, tnear, tfar)

    bvh8.intersect(case["pack"], case["tris"], *_t(rays),
                   walks=(lambda *a: (None, torch.as_tensor(slot)), exact_walk))
    return (seen[0] > 0).numpy()


def test_fast_twin_matches_pallas_k3_fast_raw(case):
    """The raw walks: winner slot and bf16x3 t, before any validation."""
    from jax.experimental.pallas import tpu as pltpu
    from tungsten_tpu.ops.pallas_bvh2 import _pack_rays
    from tungsten_tpu.ops.pallas_bvh8 import _launch8

    jpack, rays = case["jpack"], case["rays"]
    n = len(rays[0])
    rays_m, _, _ = _pack_rays(*(jnp.asarray(a) for a in rays), 128)
    with pltpu.force_tpu_interpret_mode():
        out = np.asarray(_launch8(rays_m, jpack.boxes, jpack.kid, jpack.order,
                                  (jpack.planes_hi, jpack.planes_lo), jpack.n_nodes,
                                  leaf=jpack.leaf, rt=128, walks=1, fast=True))
    t_k, slot_k = out[0, :n], out[1, :n].astype(np.int64)
    t0 = bvh8.walk_fast_twin.launches
    t_t, slot_t = (x.numpy() for x in bvh8.walk_fast_twin(case["pack"], *_t(rays)))
    assert bvh8.walk_fast_twin.launches == t0 + 1
    same = slot_k == slot_t
    # phantoms: winners that fail the exact validation, in either walk
    phantom = np.zeros(n, bool)
    for slot in (slot_k, slot_t):
        phantom |= _repair_lanes(case, rays, slot)
    assert 0 < phantom.mean() < 0.1
    assert same[~phantom].mean() >= BAR, f"raw slot agrees on {same[~phantom].mean():.4%}"
    assert same.mean() >= 0.995 and phantom[~same].all(), f"{same.mean():.4%}"
    hit = same & (slot_t >= 0)
    assert 0.3 < hit.mean() < 0.95
    np.testing.assert_allclose(t_t[hit], t_k[hit], rtol=1e-3)
    dead = rays[3] <= rays[2]
    assert (slot_t[dead] == -1).all()


def _agree(h, prim, t, u, v, label, bar=BAR):
    same = h.prim.numpy() == prim
    assert same.mean() >= bar, f"{label}: prim agrees on {same.mean():.4%}"
    hit = same & (prim >= 0)
    np.testing.assert_allclose(h.t.numpy()[hit], t[hit], rtol=1e-5, atol=1e-6, err_msg=label)
    if u is not None:
        np.testing.assert_allclose(h.u.numpy()[hit], u[hit], rtol=0, atol=1e-5, err_msg=label)
        np.testing.assert_allclose(h.v.numpy()[hit], v[hit], rtol=0, atol=1e-5, err_msg=label)
    assert np.all(h.t.numpy()[h.prim.numpy() < 0] == np.float32(INF))


def test_fast_query_matches_pallas_query_and_brute_force(case):
    from jax.experimental.pallas import tpu as pltpu
    from tungsten_tpu.ops.pallas_bvh8 import intersect_bvh_pallas8

    rays = case["rays"]
    with pltpu.force_tpu_interpret_mode():
        hk = intersect_bvh_pallas8(case["jpack"], case["jtris"], *(jnp.asarray(a) for a in rays),
                                   rt=128, walks=1, fast=True)
    ht = bvh8.intersect(case["pack"], case["tris"], *_t(rays))  # fast is the default
    _agree(ht, *(np.asarray(x) for x in (hk.prim, hk.t, hk.u, hk.v)), "vs K3-fast query")
    hb = intersect_brute(case["tris"], *_t(rays))
    _agree(ht, hb.prim.numpy(), hb.t.numpy(), hb.u.numpy(), hb.v.numpy(), "vs brute force")


def test_fast_and_exact_queries_agree(case):
    """fast=True against fast=False: the same prim on >= 99.99% of rays."""
    rays = _t(case["rays"])
    k_fast, k_exact = bvh8.walk_fast_twin.launches, bvh8.walk_twin.launches
    hf = bvh8.intersect(case["pack"], case["tris"], *rays, fast=True)
    assert bvh8.walk_fast_twin.launches == k_fast + 1  # the fast walk ...
    assert bvh8.walk_twin.launches == k_exact + 1  # ... and one exact repair launch
    he = bvh8.intersect(case["pack"], case["tris"], *rays, fast=False)
    assert bvh8.walk_fast_twin.launches == k_fast + 1 and bvh8.walk_twin.launches == k_exact + 2
    _agree(hf, he.prim.numpy(), he.t.numpy(), he.u.numpy(), he.v.numpy(), "fast vs exact", 0.9999)


def test_phantom_winner_is_repaired():
    """A ray that passes 0.01 (in barycentric units) outside an edge of a
    near triangle, in front of a far one: the raw fast walk accepts the near
    triangle through the edge slack (a phantom, which prunes the far hit);
    the query validates it, finds it false, and re-traces to the far one."""
    rng = np.random.default_rng(3)
    n_fill = 200  # filler far away, so the pack has more than one leaf
    v0 = np.concatenate([[[0.0, 0.0, 1.0], [-5.0, -5.0, 3.0]],
                         rng.uniform(20.0, 30.0, (n_fill, 3))]).astype(np.float32)
    e1 = np.concatenate([[[1.0, 0.0, 0.0], [20.0, 0.0, 0.0]],
                         rng.normal(0, 0.3, (n_fill, 3))]).astype(np.float32)
    e2 = np.concatenate([[[0.0, 1.0, 0.0], [0.0, 20.0, 0.0]],
                         rng.normal(0, 0.3, (n_fill, 3))]).astype(np.float32)
    tree = bvh8.tri_tree(v0, e1, e2)
    pack = bvh8.Bvh8Pack.from_arrays(bvh8.build_bvh_pack8(v0, e1, e2, tree), torch.device("cpu"))
    tris = TriangleSoA(*(torch.as_tensor(a) for a in (v0, e1, e2)))
    # x = -0.01: u = -0.01 on triangle 0 (outside, inside the 0.02 slack)
    o = torch.tensor([[-0.01, 0.3, 0.0], [0.2, 0.3, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    near, far = torch.full((2,), 1e-4), torch.full((2,), INF)
    t_raw, slot_raw = bvh8.walk_fast_twin(pack, o, d, near, far)
    prim_raw = pack.prim_map[slot_raw].numpy()
    assert list(prim_raw) == [0, 0]  # lane 0: the phantom; lane 1: a true hit
    np.testing.assert_allclose(t_raw.numpy(), [1.0, 1.0], rtol=1e-3)
    h = bvh8.intersect(pack, tris, o, d, near, far)
    assert list(h.prim.numpy()) == [1, 0]
    np.testing.assert_allclose(h.t.numpy(), [3.0, 1.0], rtol=1e-6)
    hb = intersect_brute(tris, o, d, near, far)
    assert list(hb.prim.numpy()) == [1, 0]


def test_walk_fast_dispatches_by_device(case):
    """CPU tensors run the twin and count its launch; the kernel's count
    moves only where it launches, and it refuses CPU tensors."""
    rays = _t(case["rays"])
    k0, t0 = bvh8.walk_fast_cuda.launches, bvh8.walk_fast_twin.launches
    bvh8.walk_fast(case["pack"], *rays)
    assert bvh8.walk_fast_twin.launches == t0 + 1 and bvh8.walk_fast_cuda.launches == k0
    with pytest.raises(ValueError):
        bvh8.walk_fast_cuda(case["pack"], *rays)


def test_ray_words_are_the_split_rays():
    """The fast kernel's B-column words of a ray: [o_hi, 1], [o_lo, 0],
    [d_hi, 0], [d_lo, 0] as bf16 pairs, the split of split_bf16."""
    rng = np.random.default_rng(21)
    o = torch.as_tensor(rng.uniform(-50, 50, (64, 3)).astype(np.float32))
    d = torch.as_tensor(rng.normal(size=(64, 3)).astype(np.float32))
    vals = bvh8._unpack(bvh8.ray_words(o, d)).reshape(64, 4, 4)
    (oh, ol), (dh, dl) = ([h.float() for h in bvh8.split_bf16(x)] for x in (o, d))
    one, zero = torch.ones(64, 1), torch.zeros(64, 1)
    want = torch.stack([torch.cat([oh, one], 1), torch.cat([ol, zero], 1),
                        torch.cat([dh, zero], 1), torch.cat([dl, zero], 1)], 1)
    assert torch.equal(vals, want)
    assert bool((ol != 0).any())  # the split is not trivial


@pytest.mark.parametrize("k", [1, 3, 4])
def test_mma_operands_give_the_dot3_products(case, k):
    """One leaf of the `small` pack (planes of every scale, padding slots)
    and a group of k rays: the emulated tensor-core products equal _dot3's
    to rtol 1e-6 of the sum of |terms|, at every slot and plane."""
    pack = case["pack"]
    rng = np.random.default_rng(k)
    o = torch.as_tensor(rng.uniform(-4, 4, (k, 3)).astype(np.float32)) + torch.tensor([0.0, 2.0, 0.0])
    d = torch.as_tensor(rng.normal(size=(k, 3)).astype(np.float32))
    (oh, ol), (dh, dl) = ([h.float() for h in bvh8.split_bf16(x)] for x in (o, d))
    for leaf in range(pack.tri_planes.shape[0]):
        ph, pl = pack.tri_planes_hi[leaf], pack.tri_planes_lo[leaf]
        ao, ad = bvh8.mma_leaf_products(ph, pl, bvh8.ray_words(o, d))
        Ph, Pl = (x.float()[None].expand(k, -1, -1) for x in (ph, pl))
        for c, j in enumerate((0, 4, 8)):
            for got, (rh, rl, affine) in ((ao, (oh, ol, True)), (ad, (dh, dl, False))):
                ch, cl = Ph[..., j:j + 4], Pl[..., j:j + 4]
                want = bvh8._dot3(ch, cl, rh, rl, affine)
                mag = bvh8._dot3(ch.abs(), cl.abs(), rh.abs(), rl.abs(), affine)
                assert bool((torch.abs(got[:, c] - want) <= 1e-6 * mag).all()), (leaf, c)
        empty = (pack.tri_planes[leaf] == 0).all(dim=1)
        assert bool((ao[:, :, empty] == 0).all() and (ad[:, :, empty] == 0).all())
