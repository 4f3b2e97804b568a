"""The port's gather walk (K1) against the JAX package's, on the CPU.

On the CPU the port's walk is its plain twin (`gather_bvh.walk_twin`, `_phase`
run to a full drain). It is held against tungsten_tpu/ops/gather_bvh.py run
as its own tests run it (plain XLA on the CPU, `tests/test_gather_bvh.py`),
on the JAX package's pack carried across through `GatherBvhPack.from_arrays`:

  * the port's `build_gather_pack` gives the JAX build's rows and statics
    exactly, both on the numpy BVH build;
  * `intersect_bvh_gather`, `intersect_bvh_gather_mixed` and
    `occluded_bvh_gather`: prim equal on >= 99.99% of lanes (expected all),
    t, u and v within rtol 1e-6 on >= 99% of the lanes where prim agrees
    (absolute floors of 1e-6 on t and 1e-5 on u and v), within 1e-4 plus
    1e-4 on all (RTOL says why), occlusion equal on
    >= 99.99%; random scenes, finite tfar, a single leaf, mixed latch masks,
    dead lanes;
  * at N = 8,192 the JAX walk runs its straggler compaction (N >= 2 *
    MIN_PHASE), which the port does not carry: the results stay the same;
  * the twin's and the JAX walk's t, u and v differ only by XLA's fused
    multiply-adds: a numpy leaf test reproduces each bit for bit;
  * the refusal of a tree deeper than the kernel's bitstack, and of a leaf
    size other than the row's 8 slots;
  * both builds number node rows first: `from_arrays` records n_nodes (the
    rows whose flag is 0), on which the kernel tells a leaf by its id, and
    refuses a pack whose rows are not nodes first or whose ids are not whole
    numbers; the kernel sources' constants are the module's;
  * a scalar walk in numpy float32, written from `_phase` apart from the
    twin, gives the twin's t, prim, u and v bit for bit and its counts of
    node and leaf rounds, of the rounds that re-run a row after a pruned
    pop ("prune_node", "prune_leaf") and of the other staged-row rounds
    ("top");
  * the render's dispatch takes K1 where pbvh8 is absent: `small` with
    pbvh8 = None against the JAX package's render (2e-3 relative on the
    channel means, >= 98% of pixels within 1e-3 + 1e-3 |ref|).

The CUDA kernel is held against the twin bit for bit in test_torch_cuda.py.
"""
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tungsten_tpu_torch.ops import gather_bvh
from tungsten_tpu_torch.ops.intersect import INF
from test_torch_lockstep_area import check_image, one_torch_thread  # noqa: F401

BAR = 0.9999
# t, u and v where prim agrees: within RTOL on >= CLOSE_BAR of the lanes,
# within RTOL_ALL on all. XLA's CPU backend fuses a * b - c * d into
# fma(a, b, -(c * d)); the port rounds every product on its own (so does its
# kernel, bit for bit with the twin). The cross products' terms cancel, so a
# hit's t moves by more than 1e-6 on ~0.5% of the hit lanes. u and v cancel
# once more in their numerators (tv . p, d . q): there the two differ by an
# absolute amount, up to ~3e-6 on these scenes: UV_ATOL. The error of t is
# absolute too where a hit lies close to the origin (~eps * scene extent):
# T_ATOL. A thin triangle (small det) amplifies the difference further: the
# all-lanes bar is RTOL_ALL plus ATOL_ALL (one lane's v of 4,096 moved by
# 2e-5 in the dense case). test_lane_differences_are_xla_fma shows the cause:
# a numpy leaf test rounding every operation on its own gives the twin's t, u
# and v bit for bit, and one with XLA's contractions gives the JAX ones.
RTOL, CLOSE_BAR, RTOL_ALL, ATOL_ALL = 1e-6, 0.99, 1e-4, 1e-4
UV_ATOL, T_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def numpy_bvh(tmp_path, monkeypatch):
    """Both packages on the numpy BVH build (the native one gives another
    valid tree), the JAX build cache in a fresh directory."""
    import tungsten_tpu.accel.bvh as jbvh
    import tungsten_tpu_torch.accel.bvh as tbvh

    monkeypatch.setattr(jbvh, "_NATIVE", False)
    monkeypatch.setattr(tbvh, "_NATIVE", False)
    monkeypatch.setattr(jbvh, "_CACHE_DIR", str(tmp_path / "bvh_cache"))


def _scene(seed, n_tris=200, spread=2.0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.4, (n_tris, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.4, (n_tris, 3)).astype(np.float32)
    e2[::40] = e1[::40] * 2.0  # degenerate triangles: det = 0
    return v0, e1, e2


def _rays(seed, n, scene, spread=4.0, finite=False, dead=True):
    """Random origins; half the directions random, half aimed near a
    triangle of the scene."""
    rng = np.random.default_rng(seed)
    v0, e1, e2 = scene
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    k = rng.integers(0, len(v0), n // 2)
    aim = v0[k] + 0.3 * e1[k] + 0.3 * e2[k] + rng.normal(0, 0.05, (n // 2, 3))
    d[: n // 2] = aim - o[: n // 2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[3::97, 1] = 0.0  # axis-parallel components: inv = 1 / 1e-30
    tnear = np.full(n, 1e-4, np.float32)
    tfar = (rng.uniform(0.5, 6.0, n) if finite else np.full(n, INF)).astype(np.float32)
    if dead:
        tfar[::11] = 0.0  # dead lanes: tfar <= tnear
    return o, d, tnear, tfar


def _packs(v0, e1, e2):
    from tungsten_tpu.ops.gather_bvh import build_gather_pack as jbuild

    jp = jbuild(v0, e1, e2)
    arrays = {"rows": np.asarray(jp.rows), "root": jp.root, "n_rows": jp.n_rows,
              "depth": jp.depth, "n_tris": jp.n_tris}
    return jp, gather_bvh.GatherBvhPack.from_arrays(arrays, torch.device("cpu"))


def _check_hits(h, ref):
    prim, rprim = h.prim.numpy(), np.asarray(ref.prim)
    same = prim == rprim
    assert same.mean() >= BAR, f"prim agree {same.mean():.6f}"
    for name, atol in (("t", T_ATOL), ("u", UV_ATOL), ("v", UV_ATOL)):
        a, b = getattr(h, name).numpy()[same], np.asarray(getattr(ref, name))[same]
        close = np.isclose(a, b, rtol=RTOL, atol=atol)
        assert close.mean() >= CLOSE_BAR, f"{name}: {close.mean():.6f} within rtol {RTOL}"
        np.testing.assert_allclose(a, b, rtol=RTOL_ALL, atol=ATOL_ALL, err_msg=name)


@pytest.mark.parametrize("n_tris", [5, 200, 700])
def test_build_matches_jax(n_tris):
    """The port's host build gives the JAX rows and statics exactly (5
    triangles: a single leaf under the root)."""
    v0, e1, e2 = _scene(n_tris, n_tris)
    jp, _ = _packs(v0, e1, e2)
    mine = gather_bvh.build_gather_pack(v0, e1, e2)
    np.testing.assert_array_equal(mine["rows"], np.asarray(jp.rows))
    assert (mine["root"], mine["n_rows"], mine["depth"], mine["n_tris"]) == (
        jp.root, jp.n_rows, jp.depth, jp.n_tris)
    assert gather_bvh.build_gather_pack(v0[:0], e1[:0], e2[:0]) is None


CASES = {  # name: (scene seed, triangles, rays, finite tfar)
    "random": (0, 200, 2048, False),
    "finite_tfar": (1, 300, 2048, True),
    "single_leaf": (2, 5, 512, False),
    "dense": (3, 700, 4096, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_queries_match_jax(case):
    """Closest hit, occlusion and a mixed latch mask against the JAX walk."""
    from tungsten_tpu.ops import gather_bvh as jg

    seed, n_tris, n, finite = CASES[case]
    v0, e1, e2 = _scene(seed, n_tris)
    jp, pack = _packs(v0, e1, e2)
    rays = _rays(seed + 10, n, (v0, e1, e2), finite=finite)
    jr = [jnp.asarray(a) for a in rays]
    tr = [torch.as_tensor(a) for a in rays]
    h = gather_bvh.intersect_bvh_gather(pack, *tr)
    ref = jg.intersect_bvh_gather(jp, *jr)
    _check_hits(h, ref)
    assert (h.prim >= 0).float().mean() > 0.2  # the aimed rays hit
    dead = tr[3] <= tr[2]
    assert bool((h.prim[dead] < 0).all()) and bool((h.t[dead] == INF).all())
    occ = gather_bvh.occluded_bvh_gather(pack, *tr).numpy()
    jocc = np.asarray(jg.occluded_bvh_gather(jp, *jr))
    assert (occ == jocc).mean() >= BAR
    np.testing.assert_array_equal(occ, h.prim.numpy() >= 0)
    latch = np.random.default_rng(seed).random(n) < 0.5
    hm = gather_bvh.intersect_bvh_gather_mixed(pack, *tr, torch.as_tensor(latch))
    jm = jg.intersect_bvh_gather_mixed(jp, *jr, jnp.asarray(latch))
    assert ((hm.prim.numpy() >= 0) == (np.asarray(jm.prim) >= 0)).mean() >= BAR
    closest = ~latch
    np.testing.assert_array_equal(hm.prim.numpy()[closest], h.prim.numpy()[closest])
    np.testing.assert_array_equal(hm.t.numpy()[closest], h.t.numpy()[closest])
    _check_hits(gather_bvh.Hit(*(getattr(hm, k)[torch.as_tensor(closest)]
                                 for k in ("t", "prim", "u", "v"))),
                gather_bvh.Hit(*(np.asarray(getattr(jm, k))[closest]
                                 for k in ("t", "prim", "u", "v"))))


def _leaf_np(v0, e1, e2, o, d, fused):
    """One Moller-Trumbore test a lane in numpy float32, in `_phase`'s order
    of operations -> (t, u, v). fused=False rounds every operation on its own,
    as the twin and the kernel do; fused=True contracts as XLA's CPU backend
    does: a * b - c * d into fma(a, b, -(c * d)) and a * x + b * y + c * z
    into fma(c, z, fma(a, x, b * y)). The fma is computed in float64 (the
    product is exact there) and rounded once to float32."""
    f8, f4 = np.float64, np.float32
    if fused:
        def cross(a, b, c, e):
            return (f8(a) * f8(b) - f8(c * e)).astype(f4)

        def dot(a, b, c, x, y, z):
            return (f8(c) * f8(z) + f8((f8(a) * f8(x) + f8(b * y)).astype(f4))).astype(f4)
    else:
        def cross(a, b, c, e):
            return a * b - c * e

        def dot(a, b, c, x, y, z):
            return a * x + b * y + c * z
    (ox, oy, oz), (dx, dy, dz) = o.T, d.T
    (v0x, v0y, v0z), (e1x, e1y, e1z), (e2x, e2y, e2z) = v0.T, e1.T, e2.T
    px, py, pz = cross(dy, e2z, dz, e2y), cross(dz, e2x, dx, e2z), cross(dx, e2y, dy, e2x)
    det = dot(e1x, e1y, e1z, px, py, pz)
    inv_det = np.where(np.abs(det) > 1e-12, f4(1.0) / np.where(det == 0, f4(1.0), det),
                       f4(0.0)).astype(f4)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    qx, qy, qz = cross(ty, e1z, tz, e1y), cross(tz, e1x, tx, e1z), cross(tx, e1y, ty, e1x)
    return (dot(e2x, e2y, e2z, qx, qy, qz) * inv_det, dot(tx, ty, tz, px, py, pz) * inv_det,
            dot(dx, dy, dz, qx, qy, qz) * inv_det)


@pytest.mark.parametrize("case", list(CASES))
def test_lane_differences_are_xla_fma(case):
    """Where the twin and the JAX walk hit the same triangle but t, u or v
    differ, the difference is XLA's fused multiply-adds: the hit triangle's
    test rounded op by op gives the twin's values bit for bit on every such
    lane, and the same test with XLA's contractions gives the JAX values."""
    from tungsten_tpu.ops import gather_bvh as jg

    seed, n_tris, n, finite = CASES[case]
    v0, e1, e2 = _scene(seed, n_tris)
    jp, pack = _packs(v0, e1, e2)
    o, d, tnear, tfar = _rays(seed + 10, n, (v0, e1, e2), finite=finite)
    h = gather_bvh.intersect_bvh_gather(pack, *(torch.as_tensor(a) for a in (o, d, tnear, tfar)))
    ref = jg.intersect_bvh_gather(jp, *(jnp.asarray(a) for a in (o, d, tnear, tfar)))
    prim = h.prim.numpy()
    k = (prim == np.asarray(ref.prim)) & (prim >= 0)
    tri = prim[k]
    plain = _leaf_np(v0[tri], e1[tri], e2[tri], o[k], d[k], fused=False)
    fused = _leaf_np(v0[tri], e1[tri], e2[tri], o[k], d[k], fused=True)
    moved = 0
    for name, a, b in zip("tuv", plain, fused):
        mine, theirs = getattr(h, name).numpy()[k], np.asarray(getattr(ref, name))[k]
        np.testing.assert_array_equal(mine, a, err_msg=f"twin {name}")
        np.testing.assert_array_equal(theirs, b, err_msg=f"JAX {name}")
        moved += int((mine != theirs).sum())
    assert moved > 0  # the witness sees lanes that moved


def test_compaction_changes_no_result():
    """At N = 8,192 the JAX walk compacts its stragglers into narrower
    phases (`_traverse`, N >= 2 * MIN_PHASE); the port drains one phase.
    Closest hit and a mixed latch mask give the same results."""
    from tungsten_tpu.ops import gather_bvh as jg

    n = 8192
    assert n >= 2 * jg.MIN_PHASE
    v0, e1, e2 = _scene(4, 900, spread=3.0)
    jp, pack = _packs(v0, e1, e2)
    rays = _rays(14, n, (v0, e1, e2))
    jr = [jnp.asarray(a) for a in rays]
    tr = [torch.as_tensor(a) for a in rays]
    _check_hits(gather_bvh.intersect_bvh_gather(pack, *tr), jg.intersect_bvh_gather(jp, *jr))
    latch = np.arange(n) % 3 == 0
    hm = gather_bvh.intersect_bvh_gather_mixed(pack, *tr, torch.as_tensor(latch))
    jm = jg.intersect_bvh_gather_mixed(jp, *jr, jnp.asarray(latch))
    assert ((hm.prim.numpy() >= 0) == (np.asarray(jm.prim) >= 0)).mean() >= BAR
    work = gather_bvh.walk_twin.work
    assert work["node"] > n and work["leaf"] > 0


def test_twin_walk_state():
    """The twin's result does not depend on which lanes walk beside it, and
    its counts follow the call: a lane walked alone gives its result in the
    batch."""
    v0, e1, e2 = _scene(5, 300)
    _, pack = _packs(v0, e1, e2)
    tr = [torch.as_tensor(a) for a in _rays(15, 256, (v0, e1, e2))]
    before = gather_bvh.walk_twin.launches
    full = gather_bvh.walk_twin(pack, *tr)
    assert gather_bvh.walk_twin.launches == before + 1
    for i in (0, 7, 100):
        one = gather_bvh.walk_twin(pack, *(x[i:i + 1] for x in tr))
        for a, b in zip(one, full):
            assert torch.equal(a[0], b[i])


def test_depth_is_checked():
    """A tree whose bitstack (depth + 2 levels) exceeds the kernel's
    MAX_LEVELS is refused on the host."""
    v0, e1, e2 = _scene(6, 200)
    arrays = gather_bvh.build_gather_pack(v0, e1, e2)
    gather_bvh.GatherBvhPack.from_arrays(arrays, torch.device("cpu"))
    deep = dict(arrays, depth=gather_bvh.MAX_LEVELS - 1)
    with pytest.raises(ValueError, match="bitstack"):
        gather_bvh.GatherBvhPack.from_arrays(deep, torch.device("cpu"))
    with pytest.raises(ValueError, match="8 triangles"):  # a leaf row holds 8
        gather_bvh.build_gather_pack(v0, e1, e2, leaf_size=16)
    bad = dict(arrays, rows=arrays["rows"][:, :-1])
    with pytest.raises(ValueError):
        gather_bvh.GatherBvhPack.from_arrays(bad, torch.device("cpu"))


@pytest.mark.parametrize("n_tris", [8, 200, 700])
def test_from_arrays_records_n_nodes(n_tris):
    """Both packages number their node rows first: n_nodes is the count of
    rows whose flag is 0, on the JAX pack carried across and on the port's
    own build, and the kernel stages min(TOP_ROWS, n_nodes) of them."""
    v0, e1, e2 = _scene(n_tris + 1, n_tris)
    jp, pack = _packs(v0, e1, e2)
    flags = np.asarray(jp.rows)[gather_bvh.COL_FLAG]
    assert pack.n_nodes == int((flags == 0.0).sum()) > 0
    assert (flags[:pack.n_nodes] == 0.0).all() and (flags[pack.n_nodes:] == 1.0).all()
    mine = gather_bvh.GatherBvhPack.from_arrays(gather_bvh.build_gather_pack(v0, e1, e2),
                                                torch.device("cpu"))
    assert mine.n_nodes == pack.n_nodes
    assert pack.top == min(gather_bvh.TOP_ROWS, pack.n_nodes)


def test_from_arrays_refuses_packs_not_nodes_first():
    """A pack whose rows were permuted so that a leaf comes before a node is
    refused, and so is one with a child or prim id that is not a whole
    number: the kernel knows a leaf by its id and keeps ids as floats."""
    v0, e1, e2 = _scene(8, 200)
    arrays = gather_bvh.build_gather_pack(v0, e1, e2)
    gather_bvh.GatherBvhPack.from_arrays(arrays, torch.device("cpu"))
    m = arrays["n_rows"]
    perm = np.arange(m)
    perm[[1, m - 1]] = perm[[m - 1, 1]]  # the last leaf row where the second node was
    with pytest.raises(ValueError, match="nodes"):
        gather_bvh.GatherBvhPack.from_arrays(dict(arrays, rows=arrays["rows"][:, perm]),
                                             torch.device("cpu"))
    for col, value in ((48, 1.5), (48, float("nan")), (72, -2.0)):
        rows = arrays["rows"].copy()
        rows[col, 0 if col == 48 else m - 1] = value
        with pytest.raises(ValueError, match="whole numbers"):
            gather_bvh.GatherBvhPack.from_arrays(dict(arrays, rows=rows), torch.device("cpu"))


def test_kernel_constants_match_the_module():
    """The kernels' row width, staged rows, bitstack and round limit are the
    module's ROW, TOP_ROWS, MAX_LEVELS and MAX_ROUNDS."""
    csrc = os.path.join(os.path.dirname(gather_bvh.__file__), os.pardir, "csrc")
    want = {"kRow": gather_bvh.ROW, "kMaxLevels": gather_bvh.MAX_LEVELS,
            "kMaxRounds": gather_bvh.MAX_ROUNDS}
    for name, extra in (("gather_walk.cu", {"kTopRows": gather_bvh.TOP_ROWS}),
                        ("gather_walk_v1.cu", {})):
        with open(os.path.join(csrc, name)) as f:
            src = f.read()
        for const, value in {**want, **extra}.items():
            assert re.search(rf"constexpr int {const} = {value};", src), (name, const)


def _pmin(a, b):  # torch.minimum / maximum on scalars: NaN wherever either is
    return a if (a < b or a != a) else b


def _pmax(a, b):
    return a if (a > b or a != a) else b


def _walk_scalar(rows, root, levels, o, d, tnear, tfar, latched):
    """One lane of `_phase` in numpy float32 scalars, round by round, written
    from the JAX loop and not from the twin: the nearest hit child (lowest
    slot on ties) is the cursor and the second nearest is stored on the
    pushed level; a pop descends to the stored child (direct), consumes it
    and re-runs the row (prune), or re-gathers the parent. -> (t, prim, u,
    v, (the row, whether it re-runs after a prune) of each round)."""
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        return _walk_scalar_f32(rows, root, levels, o, d, tnear, tfar, latched)


def _walk_scalar_f32(rows, root, levels, o, d, tnear, tfar, latched):
    f4 = np.float32
    inv = [f4(1.0) / (x if x != 0.0 else f4(1e-30)) for x in d]
    best, prim, bu, bv = tfar, -1, f4(0.0), f4(0.0)
    cur, pend, stack, visited = (root if tfar > tnear else -1), 0xFF, [], []
    rerun = False
    for _ in range(gather_bvh.MAX_ROUNDS):
        if cur < 0:
            break
        visited.append((cur, rerun))
        rerun = False
        r = rows[cur]
        pop = True
        if r[gather_bvh.COL_FLAG] <= 0.5:
            hits = []
            for j in range(8):
                t0 = [(r[8 * a + j] - o[a]) * inv[a] for a in range(3)]
                t1 = [(r[24 + 8 * a + j] - o[a]) * inv[a] for a in range(3)]
                lo = _pmax(_pmax(_pmin(t0[0], t1[0]), _pmin(t0[1], t1[1])), _pmin(t0[2], t1[2]))
                hi = _pmin(_pmin(_pmax(t0[0], t1[0]), _pmax(t0[1], t1[1])), _pmax(t0[2], t1[2]))
                code = int(r[48 + j])
                if (pend >> j) & 1 and code >= 0 and lo <= hi and hi >= tnear and lo < best:
                    hits.append((lo, j, code))
            if hits:
                first = min(hits)  # by tmin, then slot
                rest = [h for h in hits if h[1] != first[1]]
                if rest:
                    second = min(rest)
                    mask = sum(1 << h[1] for h in rest if h[1] != second[1])
                    if len(stack) < levels:
                        stack.append([cur, mask, second[2], second[0]])
                cur, pend, pop = first[2], 0xFF, False
        else:
            found = []
            for j in range(8):
                v0, e1, e2 = ([r[8 * (3 * q + a) + j] for a in range(3)] for q in range(3))
                p = [d[1] * e2[2] - d[2] * e2[1], d[2] * e2[0] - d[0] * e2[2],
                     d[0] * e2[1] - d[1] * e2[0]]
                det = e1[0] * p[0] + e1[1] * p[1] + e1[2] * p[2]
                if not abs(det) > f4(1e-12):
                    continue
                inv_det = f4(1.0) / det
                tv = [o[a] - v0[a] for a in range(3)]
                u = (tv[0] * p[0] + tv[1] * p[1] + tv[2] * p[2]) * inv_det
                q = [tv[1] * e1[2] - tv[2] * e1[1], tv[2] * e1[0] - tv[0] * e1[2],
                     tv[0] * e1[1] - tv[1] * e1[0]]
                v = (d[0] * q[0] + d[1] * q[1] + d[2] * q[2]) * inv_det
                t = (e2[0] * q[0] + e2[1] * q[1] + e2[2] * q[2]) * inv_det
                if (r[72 + j] >= 0 and u >= 0 and v >= 0 and u + v <= f4(1.0) and t > tnear
                        and t < best):
                    found.append((t, j, u, v, int(r[72 + j])))
            if found:
                best, _, bu, bv, prim = min(found, key=lambda h: (h[0], h[1]))
            if latched and prim >= 0:
                cur, pop = -1, False
        if not pop:
            continue
        if not stack:
            cur = -1
        elif stack[-1][2] >= 0:
            parent, mask, child, tmin = stack[-1]
            stack[-1][2] = -1
            if mask == 0:
                stack.pop()
            if tmin < best:
                cur, pend = child, 0xFF
            else:
                rerun = True
        else:
            cur, pend = stack[-1][0], stack[-1][1]
            stack.pop()
    return best, prim, bu, bv, visited


def test_twin_against_a_scalar_walk():
    """The twin's t, prim, u and v equal a scalar walk's bit for bit, lane by
    lane, in a mixed latch batch with finite, infinite and dead lanes, and its
    `.work` counts equal the scalar walk's rounds: node and leaf; the node
    and leaf rounds that re-run a row after a pruned pop ("prune_node",
    "prune_leaf"); and "top", the other rounds on the rows the kernel stages
    (id < min(TOP_ROWS, n_nodes))."""
    v0, e1, e2 = _scene(9, 400)
    _, pack = _packs(v0, e1, e2)
    assert pack.n_nodes > gather_bvh.TOP_ROWS  # the staged rows are a proper part
    o, d, tnear, tfar = _rays(19, 96, (v0, e1, e2))
    tfar[1::5] = np.random.default_rng(19).uniform(0.5, 4.0, len(tfar[1::5]))
    latch = np.arange(96) % 3 == 0
    out = gather_bvh.walk_twin(pack, *(torch.as_tensor(a) for a in (o, d, tnear, tfar)),
                               torch.as_tensor(latch))
    work = dict(gather_bvh.walk_twin.work)
    rows = pack.rows.numpy()
    node = leaf = top = prune_node = prune_leaf = 0
    for i in range(96):
        t, prim, u, v, visited = _walk_scalar(rows, pack.root, pack.depth + 2, o[i], d[i],
                                              tnear[i], tfar[i], bool(latch[i]))
        for got, want in zip((x[i] for x in out), (t, prim, u, v)):
            assert np.asarray(got.item(), got.numpy().dtype).tobytes() == \
                np.asarray(want, got.numpy().dtype).tobytes(), (i, got, want)
        node += sum(c < pack.n_nodes for c, _ in visited)
        leaf += sum(c >= pack.n_nodes for c, _ in visited)
        prune_node += sum(c < pack.n_nodes for c, again in visited if again)
        prune_leaf += sum(c >= pack.n_nodes for c, again in visited if again)
        top += sum(c < pack.top for c, again in visited if not again)
    assert (work["node"], work["leaf"], work["prune_node"], work["prune_leaf"], work["top"]) \
        == (node, leaf, prune_node, prune_leaf, top)
    assert 0 < top < node and leaf > 0 and prune_node + prune_leaf > 0


def test_walk_picks_by_device():
    """On CPU tensors `walk` runs the twin; the kernel's count stays."""
    v0, e1, e2 = _scene(7, 100)
    _, pack = _packs(v0, e1, e2)
    tr = [torch.as_tensor(a) for a in _rays(17, 64, (v0, e1, e2))]
    k0, t0 = gather_bvh.walk_cuda.launches, gather_bvh.walk_twin.launches
    gather_bvh.walk(pack, *tr)
    assert gather_bvh.walk_cuda.launches == k0 and gather_bvh.walk_twin.launches == t0 + 1
    with pytest.raises(ValueError):
        gather_bvh.walk_cuda(pack, *tr)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """`small` in both packages on the numpy BVH build: the JAX render and
    the port's scene and the JAX scene's arrays."""
    import tungsten_tpu.accel.bvh as jbvh
    import tungsten_tpu_torch.accel.bvh as tbvh
    from tungsten_tpu.renderer.render import DEFAULT_SEED, render_flat as jrender
    from tungsten_tpu.scene.flatten import flatten_scene as jflatten
    from tungsten_tpu.scene.load import load_scene as jload
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene
    from test_torch_host import jax_arrays

    mp = pytest.MonkeyPatch()
    mp.setattr(jbvh, "_NATIVE", False)
    mp.setattr(tbvh, "_NATIVE", False)
    mp.setattr(jbvh, "_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    path = synth.write_scene(str(tmp_path_factory.mktemp("small")), "small")
    js = jflatten(jload(path))
    out = dict(ref=np.asarray(jrender(js, seed=DEFAULT_SEED)), seed=DEFAULT_SEED,
               scene=flatten_scene(load_scene(path), torch.device("cpu")),
               arrays=jax_arrays(js), meta=js.meta)
    mp.undo()
    return out


def test_jax_scene_gbvh_carries_across(small):
    """A JAX FlatScene's gbvh comes through from_arrays, and the port's
    flatten builds the same pack."""
    from tungsten_tpu_torch.scene.flatten import from_arrays

    scene = from_arrays(small["arrays"], small["meta"], torch.device("cpu"))
    mine = small["scene"].gbvh
    assert scene.gbvh is not None and mine is not None
    assert torch.equal(scene.gbvh.rows, mine.rows)
    assert (scene.gbvh.n_rows, scene.gbvh.depth, scene.gbvh.n_tris) == (
        mine.n_rows, mine.depth, mine.n_tris)


def test_render_dispatch_takes_k1(small):
    """Without pbvh8 every walk of the render goes to K1 (closest hit, the
    regen 2N mixed walk, any-hit) and the image matches the JAX render."""
    from tungsten_tpu_torch.ops import bvh, bvh2, bvh8
    from tungsten_tpu_torch.renderer.render import render_flat

    scene = dataclasses.replace(small["scene"], pbvh8=None)

    def counts():
        return (gather_bvh.walk_twin.launches, bvh8.walk_twin.launches,
                bvh8.walk_fast_twin.launches, sum(bvh2.walk3_twin.launches.values()),
                sum(bvh.walk_packet_twin.launches.values()))

    before = counts()
    img = render_flat(scene, seed=small["seed"])
    k1, *others = (a - b for a, b in zip(counts(), before))
    assert k1 > 0 and not any(others), (k1, others)
    check_image(img, small["ref"], "small regen on K1")
