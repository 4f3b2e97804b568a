"""The port's streaming brute force (K2) against the real Pallas kernel and brute force.

On the CPU the port's K2 is its plain twin (`stream_twin`); it is held
against the JAX package's `_mt_kernel` run unchanged in Pallas interpret
mode (intersect_pallas), on a pack built by the JAX package's
PallasTriScene. The scene has ~5,000 triangles in 3 chunks, each chunk a
spatial cluster, and the rays come in tiles that aim at one cluster, so the
tile-level chunk cull fires.

Bars: prim agrees on >= 99.9% of rays (expected 100%), and where it agrees t
within rtol 1e-5 plus atol 1e-6 and u / v within atol 1e-5, the bars of
test_torch_bvh.py: both compute Moller-Trumbore in the same order, the twin
rounding every operation as IEEE f32, XLA's interpret run contracting
multiply-adds; u = (tv . p) / det cancels, so its rounding shows most
(about eps |tv| |p| / |det|: the eye sits ~6 units from the clusters, and
the largest u / v difference measured here is 8.1e-6).

The CUDA kernel itself is held against the twin in test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tungsten_tpu_torch.ops import intersect_stream as k2
from tungsten_tpu_torch.ops.intersect import INF, TriangleSoA, intersect_brute
from test_torch_bvh8 import BAR, _agree_closest, _t

UV_ATOL = 1e-5
CENTERS = np.array([[-4.0, 0.0, 0.0], [0.0, 0.0, 0.0], [4.0, 0.0, 0.0]], np.float32)


def _scene(rng, n_tris=5000):
    """Triangles in three spatial clusters of up to one chunk each, in chunk
    order, with a few degenerate ones."""
    c = np.minimum(np.arange(n_tris) // k2.CHUNK, 2)
    v0 = (CENTERS[c] + rng.uniform(-1.2, 1.2, (n_tris, 3))).astype(np.float32)
    e1 = rng.normal(0, 0.5, (n_tris, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.5, (n_tris, 3)).astype(np.float32)
    e2[::50] = e1[::50] * 2.0  # degenerate: det = 0
    return v0, e1, e2


def _rays(rng, n_tiles=6, n_random=300, eye_z=6.0):
    """Camera-like tiles of 256 rays, each tile aimed at one cluster (so it
    misses the others' boxes), then random rays; n is not a multiple of 256.
    Every ninth ray is dead, every ninth from the sixth a bounded segment."""
    eye = np.array([0.0, 0.5, eye_z])
    o, d = [], []
    for i in range(n_tiles):
        tgt = CENTERS[i % 3] + rng.uniform(-1.0, 1.0, (k2.RAY_TILE, 3))
        o.append(np.broadcast_to(eye, (k2.RAY_TILE, 3)))
        d.append(tgt - eye)
    o.append(rng.uniform(-6.0, 6.0, (n_random, 3)))
    d.append(rng.normal(size=(n_random, 3)))
    o, d = np.concatenate(o), np.concatenate(d)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    n = len(o)
    tnear = np.full(n, 1e-4)
    tfar = np.full(n, 3.0e38)
    tfar[::9] = 0.0
    tfar[5::9] = rng.uniform(2.0, 12.0, len(tfar[5::9]))
    return [np.ascontiguousarray(a, np.float32) for a in (o, d, tnear, tfar)]


@pytest.fixture(scope="module")
def case():
    from tungsten_tpu.ops.pallas_intersect import PallasTriScene

    rng = np.random.default_rng(0x2C)
    v0, e1, e2 = _scene(rng)
    jscene = PallasTriScene(v0, e1, e2)
    arrays = k2.build_tri_pack(v0, e1, e2)
    pack = k2.TriPack.from_arrays(arrays, torch.device("cpu"))
    tris = TriangleSoA(*(torch.as_tensor(a) for a in (v0, e1, e2)))
    return dict(jscene=jscene, arrays=arrays, pack=pack, tris=tris, rays=_rays(rng))


def test_pack_matches_pallas_tri_scene(case):
    jscene, arrays, pack = case["jscene"], case["arrays"], case["pack"]
    for k in ("tris_t", "clusters"):
        a, b = arrays[k], np.asarray(getattr(jscene, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert arrays["n_tris"] == jscene.n_tris == 5000
    assert pack.n_chunks == jscene.n_chunks == 3
    # the kernel's copy: triangle-major rows [v0 | e1 | e2] per chunk
    assert tuple(pack.tri_c.shape) == (3, k2.CHUNK, 9)
    np.testing.assert_array_equal(pack.tri_c.reshape(-1, 9).numpy(), arrays["tris_t"][:9].T)
    # the last chunk's AABB leaves out its padding triangles (zeros at the origin)
    assert arrays["clusters"][2, 0] > 1.0


def test_twin_matches_pallas_k2(case):
    from jax.experimental.pallas import tpu as pltpu
    from tungsten_tpu.ops.pallas_intersect import intersect_pallas

    rays = case["rays"]
    with pltpu.force_tpu_interpret_mode():
        hk = intersect_pallas(case["jscene"], *(jnp.asarray(a) for a in rays))
    ht = k2.intersect_stream(case["pack"], *_t(rays))
    pk, pt = np.asarray(hk.prim), ht.prim.numpy()
    _agree_closest(pt, ht.t.numpy(), pk, np.asarray(hk.t), "vs _mt_kernel")
    same = pk == pt
    np.testing.assert_allclose(ht.u.numpy()[same], np.asarray(hk.u)[same], rtol=0, atol=UV_ATOL)
    np.testing.assert_allclose(ht.v.numpy()[same], np.asarray(hk.v)[same], rtol=0, atol=UV_ATOL)
    assert 0.2 < (pt >= 0).mean() < 0.9  # both outcomes occur
    # the cull fired: fewer (tile, chunk) pairs were tested than all of them;
    # the rays' own box hits need fewer tests still than their tiles run
    n_tiles = -(-len(rays[0]) // k2.RAY_TILE)
    work = k2.stream_twin.work
    tested = work["tri_tile"] // (k2.RAY_TILE * k2.CHUNK)
    assert 0 < tested < n_tiles * 3
    assert 0 < work["tri"] < work["tri_tile"] and work["tri"] % k2.CHUNK == 0


def test_twin_matches_brute_force(case):
    rays = _t(case["rays"])
    ht = k2.intersect_stream(case["pack"], *rays)
    hb = intersect_brute(case["tris"], *rays)
    _agree_closest(ht.prim.numpy(), ht.t.numpy(), hb.prim.numpy(), hb.t.numpy(), "vs brute")
    same = (ht.prim == hb.prim).numpy()
    np.testing.assert_allclose(ht.u.numpy()[same], hb.u.numpy()[same], rtol=0, atol=UV_ATOL)
    np.testing.assert_allclose(ht.v.numpy()[same], hb.v.numpy()[same], rtol=0, atol=UV_ATOL)


def test_dead_and_padding_rays_never_hit(case):
    """Dead rays report a miss; the ragged last tile computes nothing for
    lanes past n; no ray reports a padding triangle, although one lies on the
    origin of every ray through the origin below."""
    o, d, tn, tf = _t(case["rays"])
    n = o.shape[0]
    assert n % k2.RAY_TILE
    t, prim, u, v = k2.stream_twin(case["pack"], o, d, tn, tf)
    dead = (tf <= tn).numpy()
    assert dead.any() and (prim.numpy()[dead] == -1).all()
    assert (t.numpy()[dead] == INF).all() and (u.numpy()[dead] == 0).all()
    assert (prim.numpy() < case["pack"].n_tris).all()
    zo = torch.zeros((64, 3))  # rays through the padding triangles' point
    h = k2.intersect_stream(case["pack"], zo, d[:64], torch.full((64,), -1.0),
                            torch.full((64,), INF))
    assert (h.prim < case["pack"].n_tris).all()


def test_ties_keep_the_lowest_index(case):
    """Within a chunk the lowest index wins an exact tie (argmin); across
    chunks a later chunk needs a strictly smaller t (pallas_intersect.py:124)."""
    from jax.experimental.pallas import tpu as pltpu
    from tungsten_tpu.ops.pallas_intersect import PallasTriScene, intersect_pallas

    tri = (np.array([[-1.0, -1.0, 0.0]]), np.array([[3.0, 0.0, 0.0]]), np.array([[0.0, 3.0, 0.0]]))
    v0, e1, e2 = (np.zeros((2 * k2.CHUNK + 10, 3), np.float32) for _ in range(3))
    v0[:] = 50.0  # far away filler
    e1[:, 0] = e2[:, 1] = 0.1
    for i in (7, 300, k2.CHUNK + 5):  # three copies of one triangle
        v0[i], e1[i], e2[i] = (a[0] for a in tri)
    pack = k2.TriPack.from_arrays(k2.build_tri_pack(v0, e1, e2), torch.device("cpu"))
    o = np.array([[0.0, 0.0, 5.0], [0.1, 0.2, 5.0], [0.5, 0.1, 3.0], [0.2, 0.3, 1.0]])
    d = np.array([[0.0, 0.0, -1.0]] * 4)
    rays = [a.astype(np.float32) for a in (o, d, np.full(4, 1e-4), np.full(4, 3.0e38))]
    h = k2.intersect_stream(pack, *_t(rays))
    with pltpu.force_tpu_interpret_mode():
        hj = intersect_pallas(PallasTriScene(v0, e1, e2), *(jnp.asarray(a) for a in rays))
    np.testing.assert_array_equal(h.prim.numpy(), [7, 7, 7, 7])
    np.testing.assert_array_equal(np.asarray(hj.prim), h.prim.numpy())


def test_stream_dispatches_by_device(case):
    pack, rays = case["pack"], _t(case["rays"])
    k0, t0 = k2.stream_cuda.launches, k2.stream_twin.launches
    k2.stream(pack, *rays)
    assert k2.stream_twin.launches == t0 + 1 and k2.stream_cuda.launches == k0
    with pytest.raises(ValueError):
        k2.stream_cuda(pack, *rays)  # CPU tensors are refused, not served


@pytest.mark.parametrize("bad", ["tris_t width", "clusters rows", "n_tris"])
def test_from_arrays_checks_shapes(case, bad):
    arrays = dict(case["arrays"])
    if bad == "tris_t width":
        arrays["tris_t"] = arrays["tris_t"][:, :-1]
    elif bad == "clusters rows":
        arrays["clusters"] = arrays["clusters"][:-1]
    else:
        arrays["n_tris"] = arrays["tris_t"].shape[1] + 1
    with pytest.raises(ValueError):
        k2.TriPack.from_arrays(arrays, torch.device("cpu"))
