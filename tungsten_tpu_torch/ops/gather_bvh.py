"""Per-lane gather walk over an 8-ary tree of 8-triangle leaves (K1): the
host pack, the CUDA walk and its twin.

Host half: `build_gather_pack` is a numpy copy of the JAX package's
`build_gather_pack` (tungsten_tpu/ops/gather_bvh.py:74-209): a binary SAH
tree at 8-triangle leaves (accel/bvh.py `build_bvh_best`, which keeps no disk
cache), the greedy largest-area collapse to 8-ary, and unified rows of
K_ROW = 81 floats, stored transposed (K_ROW, M) as the JAX pack stores them:

  node row  [0:8] minx [8:16] miny [16:24] minz [24:32] maxx [32:40] maxy
            [40:48] maxz [48:56] child row ids (-1 none) [56:64] octant
            orders (24-bit packed, exact in f32) [80] = 0
  leaf row  [0:8] v0x .. [64:72] e2z (v0, e1, e2 of 8 triangles)
            [72:80] prim ids (-1 empty) [80] = 1

`GatherBvhPack.from_arrays` takes those rows and the pack's statics (root,
n_rows, depth, n_tris) and keeps them row-major, (M, 84): one row is 21
16-byte pieces, which the kernel reads with vector loads. Both builds number
the node rows first (breadth first from the root) and the leaf rows after
them, so `from_arrays` records `n_nodes`, the count of node rows, and the
kernel knows a leaf by its id (>= n_nodes) without reading its flag; it
refuses a pack whose rows are not nodes first, and one whose bitstack
(depth + 2 levels, `_phase`'s L) would not fit the kernel's MAX_LEVELS.

Kernel half: `walk_twin` is `_phase` (:216-466) in plain PyTorch, run to a
full drain: every lane on its own cursor, one row a round. A node round
slab-tests the pending children against best t, descends to the nearest
(exact blo, the lowest slot on ties) and pushes a bitstack level: the parent
row, the mask of the other hit children, the second-nearest child and its
tmin. A pop descends straight to the stored child while its tmin is below
best t (direct), consumes it and pops again next round where it is not
(prune; the current row re-runs and changes nothing), or re-gathers the
parent and re-tests its mask. A leaf round runs 8 Moller-Trumbore tests
(|det| > 1e-12, tnear < t < best t, the lowest slot on equal t). A latched
lane ends on its first hit; active = tfar > tnear; at most 16,384 rounds.
`walk_cuda` launches csrc/gather_walk.cu, which computes the same thing per
thread and agrees with the twin bit for bit: one row load a round, the top
TOP_ROWS node rows (the root and its children) served from shared memory,
a persistent grid whose threads take a new lane from a counter when theirs
ends. `walk_cuda_v1` launches its first form (csrc/gather_walk_v1.cu: the
row's flag read before the row, 124 registers), kept for measurement: no
query launches it, and it equals the new form bit for bit. `walk` picks by
the rays' device (CUDA: the kernel or an error, CPU: the twin). Each keeps
a `.launches` count, the twin also `.work`: its node and leaf rounds, those
of them that re-run a row after a pruned pop ("prune_node", "prune_leaf"),
and the other rounds on the kernel's staged rows ("top").

Not carried: `_traverse`'s straggler compaction (`_compact_indices`, its
phases and the TUNGSTEN_PHASE_DIV / MIN_PHASE / TRAV_UNROLL knobs), a TPU
workaround. A compacted lane resumes its walk with its state, so the
compaction changes no result (tests/test_torch_gather_bvh.py holds the twin
against the compacting JAX walk).

The queries (`intersect_bvh_gather`, `intersect_bvh_gather_mixed`,
`occluded_bvh_gather`) map a miss to t = INF, u = v = 0, as :586-618 do.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import _build
from .intersect import INF, Hit

TRIS_PER_LEAF = 8
K_ROW = 81  # unified row width
COL_FLAG = 80
ROW = 84  # the kernel's row: K_ROW padded to 16-byte pieces
MAX_LEVELS = 32  # the kernel's bitstack (csrc/gather_walk.cu kMaxLevels)
TOP_ROWS = 9  # node rows the kernel serves from shared memory (kTopRows): the root, 8 children
MAX_ROUNDS = 16384  # _traverse's max_rounds (csrc/gather_walk.cu kMaxRounds)
DEAD = -1


# ---------------------------------------------------------------------------
# host half
# ---------------------------------------------------------------------------

def build_gather_pack(v0, e1, e2, leaf_size: int = TRIS_PER_LEAF):
    """Binary SAH -> 8-ary collapse -> rows: {"rows" (K_ROW, M) f32, "root",
    "n_rows", "depth", "n_tris"}, or None without triangles. A leaf row holds
    TRIS_PER_LEAF triangles, so that is the only leaf size (the parameter
    mirrors the JAX signature)."""
    from ..accel.bvh import build_bvh_best

    if leaf_size != TRIS_PER_LEAF:
        raise ValueError(f"gather leaf rows hold {TRIS_PER_LEAF} triangles, not {leaf_size}")

    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    t = len(v0)
    if t == 0:
        return None
    p1, p2 = v0 + e1, v0 + e2
    lo = np.minimum(np.minimum(v0, p1), p2)
    hi = np.maximum(np.maximum(v0, p1), p2)
    bvh = build_bvh_best(lo, hi, leaf_size=TRIS_PER_LEAF)
    count, skip = bvh.count, bvh.skip
    nmin, nmax = bvh.node_min, bvh.node_max
    area = np.prod(np.maximum(nmax - nmin, 0.0), axis=1)
    leaf_mask = count > 0
    n_leaves = int(leaf_mask.sum())

    def children(b):
        left = b + 1
        return left, int(skip[left])

    # the 8-ary collapse: greedy largest-area expansion of inner slots
    nodes8 = []  # binary ids per slot
    memo = {}

    def build8(b):
        if b in memo:
            return memo[b]
        id8 = len(nodes8)
        nodes8.append(None)
        memo[b] = id8
        if count[b] > 0:
            slots = [b]
        else:
            slots = list(children(b))
            while len(slots) < 8:
                inner = [s for s in slots if count[s] == 0]
                if not inner:
                    break
                s = max(inner, key=lambda x: area[x])
                slots.remove(s)
                slots.extend(children(s))
        nodes8[id8] = slots
        return id8

    build8(0)
    i = 0
    while i < len(nodes8):
        for s in list(nodes8[i]):
            if count[s] == 0:
                build8(s)
        i += 1
    m8 = len(nodes8)

    # row ids: nodes first [0, m8), then leaf rows [m8, m8 + n_leaves)
    leaf_row = np.cumsum(leaf_mask) - 1 + m8
    m = m8 + n_leaves
    assert m < (1 << 24) and t < (1 << 24)
    rows = np.zeros((m, K_ROW), np.float32)
    centers = 0.5 * (nmin + nmax)
    # octant bit layout: (dx >= 0) << 2 | (dy >= 0) << 1 | (dz >= 0)
    sgn = np.array([[1 if o & 4 else -1, 1 if o & 2 else -1, 1 if o & 1 else -1]
                    for o in range(8)], np.float32)

    depth8 = np.zeros(m8, np.int32)
    for id8 in range(m8 - 1, -1, -1):
        slots = nodes8[id8]
        r = rows[id8]
        r[0:24] = 3e38  # absent child: an inverted box, never hit
        r[24:48] = -3e38
        r[48:56] = -1.0
        cs = []
        dmax = 0
        for c, s in enumerate(slots):
            r[0 + c], r[8 + c], r[16 + c] = nmin[s]
            r[24 + c], r[32 + c], r[40 + c] = nmax[s]
            if count[s] > 0:
                r[48 + c] = float(leaf_row[s])
            else:
                r[48 + c] = float(memo[s])
                dmax = max(dmax, int(depth8[memo[s]]))
            cs.append(centers[s])
        depth8[id8] = 1 + dmax
        cs = np.asarray(cs, np.float32)
        for o in range(8):
            perm = list(np.argsort(cs @ sgn[o], kind="stable")) + list(range(len(slots), 8))
            packed = 0
            for kk, c in enumerate(perm):
                packed |= int(c) << (3 * kk)
            r[56 + o] = float(packed)  # < 2^24, exact in f32

    for b in np.where(leaf_mask)[0]:
        r = rows[int(leaf_row[b])]
        f, c = int(bvh.first[b]), int(count[b])
        gid = bvh.prim_order[f: f + c]
        r[72:80] = -1.0
        for i2, g in enumerate(gid):
            r[0 + i2], r[8 + i2], r[16 + i2] = v0[g]
            r[24 + i2], r[32 + i2], r[40 + i2] = e1[g]
            r[48 + i2], r[56 + i2], r[64 + i2] = e2[g]
            r[72 + i2] = float(g)
        r[COL_FLAG] = 1.0

    return {"rows": np.ascontiguousarray(rows.T), "root": 0, "n_rows": m,
            "depth": max(1, int(depth8[0])), "n_tris": t}


@dataclass
class GatherBvhPack:
    """The K1 pack on one device: the rows row-major, (M, ROW) f32."""

    rows: torch.Tensor  # (M, ROW) f32: K_ROW floats a row, then 3 of padding
    root: int
    n_rows: int
    depth: int  # 8-ary depth: the bitstack takes depth + 2 levels
    n_tris: int
    n_nodes: int  # rows [0, n_nodes) are nodes, the rest leaves

    @property
    def top(self) -> int:
        """The node rows the kernel serves from shared memory, [0, top): the
        twin's work count and chip_smoke's reports read it; the kernel's
        launcher computes the same from n_nodes."""
        return min(TOP_ROWS, self.n_nodes)

    @staticmethod
    def from_arrays(arrays: dict, device) -> "GatherBvhPack":
        """From the JAX pack's transposed rows (K_ROW, M) and its statics
        (root, n_rows, depth, n_tris), under those names. Raises on a pack
        the kernel cannot walk: its bitstack deeper than MAX_LEVELS, its rows
        not nodes first, or child ids and prim ids that are not whole numbers
        in range."""
        rows_t = np.asarray(arrays["rows"], np.float32)
        root, m = int(np.asarray(arrays["root"])), int(np.asarray(arrays["n_rows"]))
        depth, n_tris = int(np.asarray(arrays["depth"])), int(np.asarray(arrays["n_tris"]))
        if rows_t.shape != (K_ROW, m) or not 0 <= root < m or m >= 1 << 24:
            raise ValueError(f"gather pack rows {rows_t.shape}, n_rows {m}, root {root}")
        if depth + 2 > MAX_LEVELS:
            raise ValueError(f"gather pack of depth {depth} needs a bitstack of {depth + 2} "
                             f"levels; the kernel keeps {MAX_LEVELS}")
        rows = np.zeros((m, ROW), np.float32)
        rows[:, :K_ROW] = rows_t.T
        leaf = rows[:, COL_FLAG] > 0.5
        n_nodes = int((rows[:, COL_FLAG] == 0.0).sum())
        if leaf[:n_nodes].any() or not leaf[n_nodes:].all():
            raise ValueError(f"gather pack: rows [0, {n_nodes}) must be its {n_nodes} nodes "
                             f"and the rest leaves")
        kids, prims = rows[~leaf, 48:56], rows[leaf, 72:80]
        if not (_whole_in(kids, m) and _whole_in(prims, n_tris)):
            raise ValueError("gather pack: child rows or prim ids not whole numbers in range")
        return GatherBvhPack(rows=torch.as_tensor(rows, device=device), root=root, n_rows=m,
                             depth=depth, n_tris=n_tris, n_nodes=n_nodes)


def _whole_in(ids, hi):
    """Every id a whole number in [-1, hi)."""
    return bool(((ids == np.round(ids)) & (ids >= -1) & (ids < hi)).all())


# ---------------------------------------------------------------------------
# kernel half
# ---------------------------------------------------------------------------

def _latch_lanes(latch, n, device):
    """A per-lane latch mask from None (closest hit), True (any-hit) or a
    bool tensor."""
    if latch is None:
        return torch.zeros((n,), dtype=torch.bool, device=device)
    if latch is True:
        return torch.ones((n,), dtype=torch.bool, device=device)
    return latch.to(torch.bool)


def _node_step(r, o, inv, tnear, best, pend):
    """The node round of `_phase` on k lanes with rows r (k, ROW): (descend,
    child, hit mask, the mask the pushed level keeps, the second child, its
    tmin, push)."""
    j8 = torch.arange(8, device=r.device)
    t0x = (r[:, 0:8] - o[:, 0:1]) * inv[:, 0:1]
    t1x = (r[:, 24:32] - o[:, 0:1]) * inv[:, 0:1]
    t0y = (r[:, 8:16] - o[:, 1:2]) * inv[:, 1:2]
    t1y = (r[:, 32:40] - o[:, 1:2]) * inv[:, 1:2]
    t0z = (r[:, 16:24] - o[:, 2:3]) * inv[:, 2:3]
    t1z = (r[:, 40:48] - o[:, 2:3]) * inv[:, 2:3]
    blo = torch.maximum(torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                        torch.minimum(t0z, t1z))
    bhi = torch.minimum(torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                        torch.maximum(t0z, t1z))
    code = r[:, 48:56].to(torch.int64)
    h = (((pend[:, None] >> j8) & 1) > 0) & (code >= 0) & (blo <= bhi) \
        & (bhi >= tnear[:, None]) & (blo < best[:, None])
    hitbits = torch.sum(torch.where(h, 1 << j8, 0), dim=1)
    tj = torch.where(h, blo, float("inf"))
    tsel = tj.min(dim=1).values
    sel = torch.where(h & (tj == tsel[:, None]), j8, 8).min(dim=1).values
    one = j8 == sel[:, None]
    child = torch.sum(torch.where(one, code, 0), dim=1)
    descend = sel < 8
    remaining = hitbits & ~(1 << sel)
    # the second-nearest hit child, stored on the pushed level so that the
    # next pop descends to it without re-gathering the parent
    tj2 = torch.where(h & ~one, blo, float("inf"))
    tsel2 = tj2.min(dim=1).values
    sel2 = torch.where(h & ~one & (tj2 == tsel2[:, None]), j8, 8).min(dim=1).values
    child2 = torch.sum(torch.where(j8 == sel2[:, None], code, 0), dim=1)
    push = descend & (remaining != 0)
    remaining2 = remaining & ~(1 << torch.clamp(sel2, max=7))
    return descend, child, remaining2, child2, tsel2, push


def _leaf_step(r, o, d, tnear, best):
    """The leaf round of `_phase` on k lanes: the 8 Moller-Trumbore tests in
    its order of operations -> (hit, t, prim, u, v) of the nearest accepted
    slot (the lowest on equal t)."""
    j8 = torch.arange(8, device=r.device)
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    v0x, v0y, v0z = r[:, 0:8], r[:, 8:16], r[:, 16:24]
    e1x, e1y, e1z = r[:, 24:32], r[:, 32:40], r[:, 40:48]
    e2x, e2y, e2z = r[:, 48:56], r[:, 56:64], r[:, 64:72]
    tid = r[:, 72:80]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = ((tid >= 0.0) & (torch.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (tt > tnear[:, None]) & (tt < best[:, None]))
    ttm = torch.where(ok, tt, float("inf"))
    tk = ttm.min(dim=1).values
    ksel = torch.where(ok & (ttm == tk[:, None]), j8, 8).min(dim=1).values
    k = torch.clamp(ksel, max=7)[:, None]
    return (ksel < 8, tk, tid.gather(1, k)[:, 0].to(torch.int64), u.gather(1, k)[:, 0],
            v.gather(1, k)[:, 0])


def walk_twin(pack: GatherBvhPack, o, d, tnear, tfar, latch=None):
    """Plain PyTorch `_phase` to a full drain. latch: None (closest hit), True
    (every lane latched) or a per-lane bool tensor. Returns (t, prim (i64,
    -1 = miss), u, v): t = tfar and u = v = 0 where no hit was found.
    `.work` records the call's node and leaf rounds (lane-rounds), the
    slab and triangle tests they run, 8 a round ("box", "tri"), the node
    and leaf rounds among them that re-run a row after a pruned pop
    ("prune_node", "prune_leaf": they change nothing, and the kernel counts
    them without running them), and the other rounds on the rows the kernel
    stages in shared memory, id < pack.top ("top")."""
    walk_twin.launches += 1
    n, dev = o.shape[0], o.device
    L = pack.depth + 2
    rows = pack.rows
    inv = 1.0 / torch.where(d == 0.0, 1e-30, d)
    lat = _latch_lanes(latch, n, dev)
    best = tfar.clone()
    prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros((n,), dtype=torch.float32, device=dev)
    bv = torch.zeros((n,), dtype=torch.float32, device=dev)
    cur = torch.where(tfar > tnear, pack.root, DEAD).to(torch.int64)
    pend = torch.full((n,), 0xFF, dtype=torch.int64, device=dev)
    lvl = torch.zeros((n,), dtype=torch.int64, device=dev)
    pid = torch.zeros((n, L), dtype=torch.int64, device=dev)
    pmask = torch.zeros((n, L), dtype=torch.int64, device=dev)
    nc = torch.full((n, L), -1, dtype=torch.int64, device=dev)
    nt = torch.zeros((n, L), dtype=torch.float32, device=dev)
    rerun = torch.zeros((n,), dtype=torch.bool, device=dev)  # the row re-runs after a prune
    node_rounds = leaf_rounds = top_rounds = prune_node = prune_leaf = 0
    for _ in range(MAX_ROUNDS):
        live = torch.nonzero(cur >= 0).squeeze(1)
        if live.numel() == 0:
            break
        top_rounds += int(((cur[live] < pack.top) & ~rerun[live]).sum())
        r = rows[cur[live]]
        is_leaf = r[:, COL_FLAG] > 0.5
        ni, li = live[~is_leaf], live[is_leaf]
        node_rounds += ni.numel()
        leaf_rounds += li.numel()
        prune_node += int(rerun[ni].sum())
        prune_leaf += int(rerun[li].sum())
        rerun[live] = False
        pops = []
        if ni.numel():
            descend, child, rem2, child2, t2, push = _node_step(
                r[~is_leaf], o[ni], inv[ni], tnear[ni], best[ni], pend[ni])
            pi, pl = ni[push], lvl[ni][push]
            keep = pl < L  # (depth + 2 levels never overflow)
            pi, pl = pi[keep], pl[keep]
            pid[pi, pl] = cur[pi]
            pmask[pi, pl] = rem2[push][keep]
            nc[pi, pl] = child2[push][keep]
            nt[pi, pl] = t2[push][keep]
            lvl[ni[push]] += 1
            di = ni[descend]
            cur[di] = child[descend]
            pend[di] = 0xFF
            pops.append(ni[~descend])
        if li.numel():
            hit, tk, pk, uk, vk = _leaf_step(r[is_leaf], o[li], d[li], tnear[li], best[li])
            hi = li[hit]
            best[hi], prim[hi], bu[hi], bv[hi] = tk[hit], pk[hit], uk[hit], vk[hit]
            found = lat[li] & (prim[li] >= 0)  # latched lanes end on their first hit
            cur[li[found]] = DEAD
            pops.append(li[~found])
        p = torch.cat(pops)
        if p.numel() == 0:
            continue
        lv = lvl[p]
        can = lv > 0
        top = torch.clamp(lv - 1, min=0)
        top_c, top_m = pid[p, top], pmask[p, top]
        top_nc, top_nt = nc[p, top], nt[p, top]
        has_nc = can & (top_nc >= 0)
        direct = has_nc & (top_nt < best[p])  # descend straight to the stored child
        prune = has_nc & ~direct  # consume it; pop again next round
        parent = can & ~has_nc  # re-gather the parent, re-test its mask
        cur[p] = torch.where(direct, top_nc, torch.where(parent, top_c,
                                                         torch.where(can, cur[p], DEAD)))
        pend[p] = torch.where(direct, 0xFF, torch.where(parent, top_m, pend[p]))
        rerun[p] = prune
        consume = direct | prune
        ci = p[consume]
        nc[ci, top[consume]] = -1
        lvl[p] = torch.where((consume & (top_m == 0)) | parent, lv - 1, lv)
    walk_twin.work = {"node": node_rounds, "leaf": leaf_rounds, "box": 8 * node_rounds,
                      "tri": 8 * leaf_rounds, "prune_node": prune_node,
                      "prune_leaf": prune_leaf, "top": top_rounds}
    return best, prim, bu, bv


walk_twin.launches = 0
walk_twin.work = {"node": 0, "leaf": 0, "box": 0, "tri": 0, "prune_node": 0, "prune_leaf": 0,
                  "top": 0}


def check_rays(o, d, tnear, tfar):
    n = o.shape[0]
    _build.check_cuda("o", o, torch.float32, (n, 3))
    _build.check_cuda("d", d, torch.float32, (n, 3), like=o)
    _build.check_cuda("tnear", tnear, torch.float32, (n,), like=o)
    _build.check_cuda("tfar", tfar, torch.float32, (n,), like=o)


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # gather_walk(o, d, tnear, tfar, latch, mode, rows, n_rows, n_nodes, root,
    # n, next (the kernel's lane counter, one int), out_t, out_prim (int64),
    # out_u, out_v, stream) of csrc/gather_walk.cu
    "gather_walk": [_P] * 5 + [_I] + [_P] + [_I] * 4 + [_P] * 6,
    # gather_walk_v1(o, d, tnear, tfar, latch, mode, rows, n_rows, root, n,
    # out_t, out_prim (int32), out_u, out_v, stream) of csrc/gather_walk_v1.cu
    "gather_walk_v1": [_P] * 5 + [_I] + [_P] + [_I] * 3 + [_P] * 5,
}


@functools.lru_cache(maxsize=None)
def _kernel_fn(name):
    """The launcher `name` of csrc/<name>.cu, with its argument types."""
    fn = getattr(_build.load_library(name), name)
    fn.restype = _I
    fn.argtypes = _ARGTYPES[name]
    return fn


def _launch_args(pack: GatherBvhPack, o, d, tnear, tfar, latch):
    """Check the rays and the pack -> (the per-lane latch bytes or None, mode:
    0 closest hit, 1 every lane latched, 2 per lane)."""
    n = o.shape[0]
    check_rays(o, d, tnear, tfar)
    _build.check_cuda("pack.rows", pack.rows, torch.float32, (pack.n_rows, ROW), like=o)
    if pack.depth + 2 > MAX_LEVELS:
        raise ValueError(f"gather pack of depth {pack.depth}: the kernel keeps {MAX_LEVELS} levels")
    if not 0 < pack.n_nodes < pack.n_rows:
        raise ValueError(f"gather pack of {pack.n_rows} rows with {pack.n_nodes} nodes")
    if not isinstance(latch, torch.Tensor):
        return None, int(latch is True)
    lane_latch = latch.to(torch.bool).contiguous()  # one byte a lane, 0 or 1
    _build.check_cuda("latch", lane_latch, torch.bool, (n,), like=o)
    return lane_latch, 2


def walk_cuda(pack: GatherBvhPack, o, d, tnear, tfar, latch=None):
    """Launch the CUDA K1 walk (csrc/gather_walk.cu) on the current stream.
    Returns (t, prim (i64, -1 = miss), u, v), as walk_twin."""
    n = o.shape[0]
    lane_latch, mode = _launch_args(pack, o, d, tnear, tfar, latch)
    out = torch.empty((3, n), dtype=torch.float32, device=o.device)  # t, u, v
    prim = torch.empty((n,), dtype=torch.int64, device=o.device)
    counter = torch.empty((1,), dtype=torch.int32, device=o.device)  # set to 0 by the launcher
    p = _build.ptr
    err = _kernel_fn("gather_walk")(
        p(o), p(d), p(tnear), p(tfar), p(lane_latch), mode, p(pack.rows), pack.n_rows,
        pack.n_nodes, pack.root, n, p(counter), p(out[0]), p(prim), p(out[1]), p(out[2]),
        _build.stream_of(o))
    if err != 0:
        raise RuntimeError(f"gather_walk launch failed: CUDA error {err}")
    walk_cuda.launches += 1 if n else 0
    return out[0], prim, out[1], out[2]


walk_cuda.launches = 0


def walk_cuda_v1(pack: GatherBvhPack, o, d, tnear, tfar, latch=None):
    """Launch the first CUDA form of K1 (csrc/gather_walk_v1.cu), kept for
    measurement. Returns what walk_cuda returns, bit for bit."""
    n = o.shape[0]
    lane_latch, mode = _launch_args(pack, o, d, tnear, tfar, latch)
    out = torch.empty((3, n), dtype=torch.float32, device=o.device)  # t, u, v
    out_prim = torch.empty((n,), dtype=torch.int32, device=o.device)
    p = _build.ptr
    err = _kernel_fn("gather_walk_v1")(
        p(o), p(d), p(tnear), p(tfar), p(lane_latch), mode, p(pack.rows), pack.n_rows,
        pack.root, n, p(out[0]), p(out_prim), p(out[1]), p(out[2]), _build.stream_of(o))
    if err != 0:
        raise RuntimeError(f"gather_walk_v1 launch failed: CUDA error {err}")
    walk_cuda_v1.launches += 1 if n else 0
    return out[0], out_prim.long(), out[1], out[2]


walk_cuda_v1.launches = 0


def walk(pack: GatherBvhPack, o, d, tnear, tfar, latch=None):
    """K1 walk on the rays' device: CUDA -> the kernel, CPU -> the twin."""
    if o.is_cuda:
        return walk_cuda(pack, o, d, tnear, tfar, latch)
    if o.device.type == "cpu":
        return walk_twin(pack, o, d, tnear, tfar, latch)
    raise ValueError(f"no K1 walk for device {o.device}")


def intersect_bvh_gather_mixed(pack: GatherBvhPack, o, d, tnear, tfar, latch) -> Hit:
    """Mixed query: latched lanes are any-hit (only prim >= 0 means
    anything there), the others closest hit; one walk."""
    t, prim, u, v = walk(pack, o, d, tnear, tfar, latch)
    miss = prim < 0
    return Hit(t=torch.where(miss, INF, t), prim=prim, u=torch.where(miss, 0.0, u),
               v=torch.where(miss, 0.0, v))


def intersect_bvh_gather(pack: GatherBvhPack, o, d, tnear, tfar) -> Hit:
    """Closest-hit query; Hit.prim are scene triangle ids."""
    return intersect_bvh_gather_mixed(pack, o, d, tnear, tfar, None)


def occluded_bvh_gather(pack: GatherBvhPack, o, d, tnear, tfar):
    """Any-hit query -> bool per ray (every lane latched)."""
    return walk(pack, o, d, tnear, tfar, True)[1] >= 0
