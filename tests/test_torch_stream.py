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


@pytest.mark.parametrize("n_tris", [5000, 4096, 2100],
                         ids=["three-chunks", "two-full-chunks", "partial-chunk"])
def test_sub_boxes_of_the_jax_pack(case, n_tris):
    """The kernel's sub-box table, built from the JAX PallasTriScene's own
    arrays (of the case's first n_tris triangles): each sub-box holds every
    real triangle of its run (its three vertices, rounded as `clusters`
    rounds them) and no more, lies inside its chunk's box, and leaves the
    padding out."""
    from tungsten_tpu.ops.pallas_intersect import PallasTriScene

    tt0 = case["arrays"]["tris_t"]
    jscene = PallasTriScene(*(np.ascontiguousarray(tt0[r:r + 3, :n_tris].T) for r in (0, 3, 6)))
    arrays = {k: np.asarray(getattr(jscene, k)) for k in ("tris_t", "clusters", "n_tris")}
    pack = k2.TriPack.from_arrays(arrays, torch.device("cpu"))
    table = pack.sub_boxes.numpy()
    n_chunks = jscene.n_chunks
    assert jscene.n_tris == n_tris and n_chunks == -(-n_tris // k2.CHUNK)
    assert table.shape == (n_chunks, k2.CHUNK // k2.SUB, 8)
    tt = arrays["tris_t"]
    v0 = tt[0:3].T
    pts = np.stack([v0, v0 + tt[3:6].T, v0 + tt[6:9].T], axis=1)  # (Tpad, 3, 3) f32
    run = np.arange(tt.shape[1]) // k2.SUB  # each triangle's sub-box, chunk major
    flat = table.reshape(-1, 8)
    real = np.arange(tt.shape[1]) < n_tris
    lo, hi = flat[run[real], None, 0:3], flat[run[real], None, 3:6]
    assert ((pts[real] >= lo) & (pts[real] <= hi)).all()
    # tight: every face of a real run's box touches one of its real vertices
    n_real_runs = -(-n_tris // k2.SUB)
    for r in range(n_real_runs):
        p = pts[r * k2.SUB:min((r + 1) * k2.SUB, n_tris)].reshape(-1, 3)
        np.testing.assert_array_equal(flat[r, 0:3], p.min(0))
        np.testing.assert_array_equal(flat[r, 3:6], p.max(0))
    # inside the chunk's box
    chunk_of = np.arange(len(flat)) // (k2.CHUNK // k2.SUB)
    used = np.arange(len(flat)) < n_real_runs
    cl = arrays["clusters"][chunk_of[used]]
    assert (flat[used, 0:3] >= cl[:, 0:3]).all() and (flat[used, 3:6] <= cl[:, 3:6]).all()
    # padding left out: runs of padding only hold empty boxes, and no kernel
    # reads them (n_subs); with 5000 triangles the last real run stops at
    # n_tris, and the padding's zeros at the origin lie outside the third
    # cluster, so a box that took them in would differ
    if n_tris == 5000:
        last = flat[n_real_runs - 1]
        assert n_tris % k2.SUB and ((last[0:3] > 0) | (last[3:6] < 0)).any()
    assert (flat[~used, 0:3] == np.inf).all() and (flat[~used, 3:6] == -np.inf).all()
    assert (~used).any() == bool(n_tris % k2.CHUNK)
    np.testing.assert_array_equal(
        pack.n_subs, np.minimum(k2.CHUNK // k2.SUB,
                                -(-(n_tris - np.arange(n_chunks) * k2.CHUNK) // k2.SUB)))
    assert pack.n_subs.sum() == n_real_runs


def _mt_stage_np(T, o, d, tnear):
    """numpy f32: the index in k2.MT_STAGES at which the kernel's `mt_exact`
    leaves each pair (triangle T (k, 9), ray o, d (k, 3), tnear (k,))."""
    f32 = np.float32
    e1, e2 = T[:, 3:6], T[:, 6:9]
    tv = o - T[:, 0:3]

    def cross(a, b):
        return np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                         a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                         a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], axis=1)

    def dot(a, b):
        return (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) + a[:, 2] * b[:, 2]

    p, q = cross(d, e2), cross(tv, e1)
    det = dot(e1, p)

    def negative(num):
        return (np.signbit(num) != np.signbit(det)) & (np.abs(num) > np.abs(det) * f32(2.0 ** -100))

    return np.select([~(np.abs(det) > f32(1e-12)), negative(dot(tv, p)), negative(dot(d, q)),
                      (tnear >= 0) & negative(dot(e2, q))], [0, 1, 2, 3], 4)


def test_sub_box_work_counts(case):
    """sub_box_work against a count in numpy: for every chunk in order, each
    live ray that hits the chunk's box against min(tfar, best so far) tests
    the chunk's real sub-boxes against the same limit, and Moller-Trumbore on
    the real triangles of those its ray hits, each pair counted at the stage
    where `mt_exact` leaves it. best comes from the twin's own per-chunk
    results (the twin on the chunks before)."""
    pack = case["pack"]
    work = k2.sub_box_work(pack, *_t(case["rays"]))
    t, _, _, _ = k2.stream_twin(pack, *_t(case["rays"]))
    twin_work = dict(k2.stream_twin.work)
    assert 0 < work["tri_sub"] < twin_work["tri"] < twin_work["tri_tile"]
    assert work["box"] == twin_work["box"] and work["box_sub"] > 0
    assert sum(work[f"mt_{s}"] for s in k2.MT_STAGES) == work["tri_sub"]
    f32 = np.float32
    o32, d32, tn32, tf32 = (np.asarray(a, f32) for a in case["rays"])
    inv = (f32(1.0) / np.where(d32 == 0, f32(1e-30), d32)).astype(f32)
    n = len(o32)
    best = np.full(n, f32(INF))
    alive = tn32 < tf32

    def slab(b, lim):  # b (m, 8) against every ray: (n, m)
        t0 = (b[None, :, 0:3] - o32[:, None]) * inv[:, None]
        t1 = (b[None, :, 3:6] - o32[:, None]) * inv[:, None]
        lo, hi = np.fmin(t0, t1), np.fmax(t0, t1)
        tmin = np.fmax(np.fmax(lo[..., 0], lo[..., 1]), lo[..., 2])
        tmax = np.fmin(np.fmin(hi[..., 0], hi[..., 1]), hi[..., 2])
        return (tmin <= tmax) & (tmax > tn32[:, None]) & (tmin < lim[:, None])

    box_sub = tri_sub = 0
    stages = np.zeros(len(k2.MT_STAGES), np.int64)
    table = pack.sub_boxes.numpy()
    tri_c = pack.tri_c.numpy()
    for j in range(pack.n_chunks):
        lim = np.minimum(tf32, best)
        hit = slab(pack.clusters.numpy()[j:j + 1], lim)[:, 0] & alive
        m = int(pack.n_subs[j])
        box_sub += int(hit.sum()) * m
        sh = slab(table[j, :m], lim) & hit[:, None]  # (n, m)
        pair = np.repeat(sh, k2.SUB, axis=1) & (j * k2.CHUNK + np.arange(m * k2.SUB)
                                               < pack.n_tris)
        ri, ti = np.nonzero(pair)
        tri_sub += len(ri)
        stages += np.bincount(_mt_stage_np(tri_c[j, ti], o32[ri], d32[ri], tn32[ri]),
                              minlength=len(k2.MT_STAGES))
        # the twin's best after chunk j: its closest hit among chunks <= j
        tj, _, _, _ = k2.stream_twin(
            k2.TriPack.from_arrays({"tris_t": pack.tris_t.numpy()[:, :(j + 1) * k2.CHUNK],
                                    "clusters": pack.clusters.numpy()[:j + 1],
                                    "n_tris": min(pack.n_tris, (j + 1) * k2.CHUNK)},
                                   torch.device("cpu")), *_t(case["rays"]))
        best = tj.numpy()
    np.testing.assert_array_equal(best, t.numpy())
    assert (work["box_sub"], work["tri_sub"]) == (box_sub, tri_sub)
    assert [work[f"mt_{s}"] for s in k2.MT_STAGES] == stages.tolist()
    assert (stages > 0).all()  # every stage occurs on the case's rays


def test_mt_stage_drops_only_pairs_the_accept_rule_rejects(case):
    """Every pair `mt_exact` rejects before the division (mt_stage < 4), the
    twin's rule (mt_leaf) rejects too, rounding included: the case's rays
    against all its triangles, and pairs whose u, v or t numerator is so
    small against det that the quotient rounds to -0, which passes u >= 0:
    those must not be dropped early."""
    rng = np.random.default_rng(5)
    o, d, tn, _ = case["rays"]
    tri = case["pack"].tri_c.numpy().reshape(-1, 9)[:case["pack"].n_tris]
    ri = rng.integers(0, len(o), 200_000)
    ti = rng.integers(0, len(tri), 200_000)
    T, O, D, TN = tri[ti], o[ri], d[ri], tn[ri]
    # a triangle of side s = 1e15 in z = 0 (det = s^2 = 1e30) under rays
    # straight down from z = 1; u = x / s, v = y / s, t = 1
    k = 4096
    s = np.float32(1e15)
    xy = -np.exp(rng.uniform(np.log(1e-33), np.log(1e-27), (k, 2))).astype(np.float32)
    xy[: k // 2, 1] = 0.25  # only u tiny
    xy[k // 2:, 0] = 0.25  # only v tiny
    T2 = np.zeros((k, 9), np.float32)
    T2[:, 3], T2[:, 7] = s, s
    O2 = np.concatenate([xy, np.ones((k, 1), np.float32)], axis=1)
    D2 = np.tile(np.array([0.0, 0.0, -1.0], np.float32), (k, 1))
    T, O, D = np.concatenate([T, T2]), np.concatenate([O, O2]), np.concatenate([D, D2])
    TN = np.concatenate([TN, np.full(k, 1e-4, np.float32)])
    stage = k2.mt_stage(*_t([T, O, D, TN]))
    np.testing.assert_array_equal(stage.numpy(), _mt_stage_np(T, O, D, TN))
    t, u, v, h = k2.mt_leaf(torch.as_tensor(T)[:, None], *_t([O, D, TN, np.full(len(T), INF,
                                                                                np.float32)]))
    h = h[:, 0].numpy()
    assert not h[stage.numpy() < 4].any()
    assert h.any() and (stage.numpy() == 4).any()
    # the quotients that round to -0 pass the rule, and mt_stage keeps them
    tiny = h[-k:] & ((u[-k:, 0] == 0) & torch.signbit(u[-k:, 0])
                     | (v[-k:, 0] == 0) & torch.signbit(v[-k:, 0])).numpy()
    assert tiny.any()
