"""Binary skip-BVH with plane leaves: host pack, the CUDA walk (K4) and its twin.

Host half: a numpy copy of the node tables of `build_bvh_pack3`
(tungsten_tpu/ops/pallas_bvh2.py): `nf` (6, M) boxes and `ni` (4, M)
[leaf_blk, count, skip, ordcode], bit for bit. The leaves (plane slabs and
prim_map) are the BVH8 pack's own tensors (Bvh3Pack.from_arrays takes them
from the scene's Bvh8Pack), as the JAX package shares them between pbvh8
and pbvh3: both packs come from one tree (bvh8.tri_tree).

Kernel half: the port of K4, the three walks `_launch3` selects, as one CUDA
source with a mode (csrc/bvh2_walk.cu) and `walk3_twin`, its plain PyTorch
version vectorised over the lanes still walking:
  "ordered"  `_walk_kernel4`: near child first, a private stack, per-ray
             best-t pruning (intersect_bvh_pallas3's default);
  "skip"     `_walk_kernel3`: stackless skip-pointer closest hit;
  "any"      `_walk_kernel3_any`: skip-pointer walk that stops at the first
             hit in (tnear, tfar) (occluded_bvh_pallas3).
All three walks run inner nodes per thread and test leaves per warp: a
lane parks each leaf whose box it hits, and the warp stages the leaf in
shared memory once and tests it for every lane parked on it, with K3's leaf
step (csrc/bvh8_common.cuh `ExactLeaf`); "any" latches every lane, so a
lane leaves its walk at the first leaf with a hit, reporting that leaf's
lowest hit slot and its t. The kernel takes leaves of LEAF = 128 slots
only. `walk3` picks by
the tensors' device: CUDA launches the kernel (or raises), CPU runs the
twin. Each keeps a plain launch count per mode
(`walk3_cuda.launches["ordered"]`, `walk3_twin.launches["any"]`, ...).

`walk3_cuda_v1` launches the first CUDA form (csrc/bvh2_walk_v1.cu: one
thread per ray in every mode, a serial slot loop), kept only so that a run
can measure old and new on one card: the intersector benchmark and
chip_smoke.py launch it, no query does. Its leaf arithmetic is contracted
by the compiler where the new kernel rounds as K3 does, so the two agree by
bars, not bits, in every mode. `coop_walk3` emulates the new kernel's
bookkeeping (parking, leaf rounds per 32-lane group, the warp's leaf step)
in plain torch for the CPU tests; nothing else uses it.

The ordered walk's stack holds STACK_DEPTH entries (pallas_bvh2.py
`_STACK_DEPTH`). The JAX package never checks a tree against it; the port
refuses a deeper tree in Bvh3Pack.from_arrays.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import _build
from .bvh8 import (LEAF, WARP, Bvh8Pack, box_hit, check_rays, coop_leaf_step, coop_merge,
                   hit_from_slots, plane_leaf, safe_inv)
from .intersect import INF, Hit

STACK_DEPTH = 96
MODES = ("ordered", "skip", "any")
_TWIN_LEAF_CHUNK = 16384  # leaf lanes evaluated per twin step (bounds memory)


# ---------------------------------------------------------------------------
# host half
# ---------------------------------------------------------------------------

def build_bvh_pack3(bvh) -> dict:
    """The node tables of build_bvh_pack3 for the binary tree `bvh`:
    {"nf" (6, M) f32 [min3 | max3], "ni" (4, M) i32 [leaf_blk, count, skip,
    ordcode]}. ordcode = 2 * axis + (left child is the low one along axis),
    axis the children's dominant centre separation (pallas_bvh2.py:461-471)."""
    m = len(bvh.count)
    leaf_mask = bvh.count > 0
    leaf_ids = np.cumsum(leaf_mask) - 1
    nf = np.concatenate([bvh.node_min, bvh.node_max], axis=1).astype(np.float32).T.copy()
    center = 0.5 * (bvh.node_min + bvh.node_max)
    li = np.minimum(np.arange(m) + 1, m - 1)
    ri = np.minimum(bvh.skip[li], m - 1)
    sep = center[ri] - center[li]
    axis = np.argmax(np.abs(sep), axis=1)
    left_lo = sep[np.arange(m), axis] >= 0.0
    ordcode = np.where(~leaf_mask, axis * 2 + left_lo.astype(np.int64), 0)
    ni = np.stack([np.where(leaf_mask, leaf_ids, 0), bvh.count, bvh.skip, ordcode],
                  axis=1).astype(np.int32).T.copy()
    return {"nf": nf, "ni": ni}


def tree_depth(count, skip) -> int:
    """Edges on the longest root-to-leaf path of a skip-pointer tree in DFS
    preorder (inner node i: children i + 1 and skip[i + 1]). The ordered
    walk's stack never holds more entries than this. Raises on a table
    whose pointers do not move forward (a walk over it would not end)."""
    m = len(count)
    if not np.all((skip > np.arange(m)) & (skip <= m)):
        raise ValueError("malformed skip-BVH: need i < skip[i] <= M for every node")
    depth = np.zeros(m, np.int64)
    for i in range(m):
        if count[i] == 0:
            left = i + 1
            right = int(skip[left]) if left < m else m
            if right >= m:
                raise ValueError(f"malformed skip-BVH: inner node {i} lacks a child")
            depth[left] = depth[right] = depth[i] + 1
    return int(depth.max())


@dataclass
class Bvh3Pack:
    """The binary pack on one device: the JAX layouts (nf, ni) plus the
    walk's node-major copies, and the BVH8 pack's leaf tensors (shared)."""

    nf: torch.Tensor  # (6, M) f32 node boxes [minx..maxz]
    ni: torch.Tensor  # (4, M) i32 [leaf_blk, count, skip, ordcode]
    prim_map: torch.Tensor  # (n_leaves*leaf,) i32, pbvh8.prim_map itself
    tri_planes: torch.Tensor  # (n_leaves, leaf, 12) f32, pbvh8.tri_planes itself
    box_t: torch.Tensor  # (M, 8) f32 node-major [min3 | max3 | 0 0]
    ni_t: torch.Tensor  # (M, 4) i32 node-major [leaf_blk, count, skip, ordcode]
    leaf: int

    @property
    def n_nodes(self) -> int:
        return self.nf.shape[1]

    @staticmethod
    def from_arrays(arrays: dict, pack8: Bvh8Pack) -> "Bvh3Pack":
        """From {"nf", "ni"} (build_bvh_pack3's or the JAX pack's) and the
        scene's BVH8 pack, on pack8's device. Raises on a tree deeper than
        STACK_DEPTH or whose leaves lie outside pack8's planes."""
        nf = np.asarray(arrays["nf"], np.float32)
        ni = np.asarray(arrays["ni"], np.int32)
        m = nf.shape[1]
        if nf.shape != (6, m) or ni.shape != (4, m):
            raise ValueError(f"nf {nf.shape} / ni {ni.shape}: need (6, M) and (4, M)")
        n_leaves = pack8.tri_planes.shape[0]
        leaf = ni[1] > 0
        if leaf.any() and not (0 <= ni[0][leaf].min() and ni[0][leaf].max() < n_leaves
                               and ni[1].max() <= pack8.leaf):
            raise ValueError("leaf blocks outside the BVH8 pack's planes")
        depth = tree_depth(ni[1], ni[2])
        if depth > STACK_DEPTH:
            raise ValueError(f"binary BVH depth {depth} > STACK_DEPTH={STACK_DEPTH}: the "
                             f"ordered walk's stack would overflow")
        box_t = np.zeros((m, 8), np.float32)
        box_t[:, :6] = nf.T
        dev = pack8.tri_planes.device
        return Bvh3Pack(
            nf=torch.as_tensor(nf, device=dev), ni=torch.as_tensor(ni, device=dev),
            prim_map=pack8.prim_map, tri_planes=pack8.tri_planes,
            box_t=torch.as_tensor(box_t, device=dev),
            ni_t=torch.as_tensor(np.ascontiguousarray(ni.T), device=dev), leaf=pack8.leaf,
        )


# ---------------------------------------------------------------------------
# kernel half
# ---------------------------------------------------------------------------

def _leaf_update(pack, lanes, blk, o, d, tnear, lim, best, local, first):
    """Evaluate the leaves blk for the walk's lanes and fold the hits into
    best / local. first: keep the lowest hit slot (any-hit) instead of the
    nearest. Returns the lanes that found a hit."""
    L = pack.leaf
    found = []
    for c0 in range(0, lanes.numel(), _TWIN_LEAF_CHUNK):
        ln, bk = lanes[c0:c0 + _TWIN_LEAF_CHUNK], blk[c0:c0 + _TWIN_LEAF_CHUNK]
        t, h = plane_leaf(pack.tri_planes[bk], o[ln], d[ln], tnear[ln],
                          lim[c0:c0 + _TWIN_LEAF_CHUNK])
        if first:
            slot = torch.argmax(h.to(torch.uint8), dim=1)
            tb = t.gather(1, slot[:, None])[:, 0]
        else:
            tb, slot = torch.min(torch.where(h, t, INF), dim=1)  # lowest slot wins a tie
        any_h = h.any(dim=1)
        best[ln] = torch.where(any_h, tb, best[ln])
        local[ln] = torch.where(any_h, bk * L + slot, local[ln])
        found.append(ln[any_h])
    return torch.cat(found) if found else lanes[:0]


def walk3_twin(pack: Bvh3Pack, o, d, tnear, tfar, mode: str = "ordered"):
    """Plain PyTorch K4 walk with the kernel's per-ray semantics.
    Returns (t (n,) f32, local slot (n,) i64; -1 = miss). In "any" mode t is
    the distance of the first hit found (not the nearest). `walk3_twin.work`
    records the call's box tests ("box") and leaf slot tests ("tri")."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    walk3_twin.launches[mode] += 1
    n = o.shape[0]
    dev = o.device
    m = pack.n_nodes
    tfar = torch.clamp(tfar, max=INF)
    inv = safe_inv(d)
    best = torch.full((n,), INF, dtype=torch.float32, device=dev)
    local = torch.full((n,), -1, dtype=torch.int64, device=dev)
    alive = tnear < tfar  # dead lanes do no work
    box_t, ni_t = pack.box_t, pack.ni_t.long()
    work = walk3_twin.work = {"box": 0, "tri": 0}

    if mode == "ordered":
        pos = d >= 0.0  # the ray's own direction signs pick the near child
        ptr = torch.where(alive, 0, -1)
        sp = torch.zeros(n, dtype=torch.int64, device=dev)
        stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
        while True:
            act = torch.nonzero(ptr >= 0).squeeze(1)
            if act.numel() == 0:
                break
            p = ptr[act]
            nd = ni_t[p]
            is_leaf = nd[:, 1] > 0
            oa, ia, tn = o[act], inv[act], tnear[act]
            lim = torch.minimum(tfar[act], best[act])
            # children of an inner node (clamped, so a leaf's reads stay in range)
            left = torch.clamp(p + 1, max=m - 1)
            right = torch.clamp(ni_t[left, 2], max=m - 1)
            hl = box_hit(box_t[left], oa, ia, tn, lim) & ~is_leaf
            hr = box_hit(box_t[right], oa, ia, tn, lim) & ~is_leaf
            code = nd[:, 3]
            left_near = ((code & 1) == 1) == pos[act].gather(1, (code // 2)[:, None])[:, 0]
            near = torch.where(left_near, left, right)
            far = torch.where(left_near, right, left)
            both = hl & hr
            sp_a = sp[act]
            stack[act[both], sp_a[both]] = far[both]
            sp_a = sp_a + both.long()
            nxt = torch.where(both, near, torch.where(hl, left, torch.where(hr, right, -1)))
            # a leaf is evaluated when its own box is hit (hitS, :286)
            ev = is_leaf & box_hit(box_t[p], oa, ia, tn, lim)
            work["box"] += act.numel() + int((~is_leaf).sum())  # two children, or the leaf
            work["tri"] += int(ev.sum()) * pack.leaf
            _leaf_update(pack, act[ev], nd[ev, 0], o, d, tnear, lim[ev], best, local, False)
            pop = (nxt < 0) & (sp_a > 0)
            top = torch.clamp(sp_a - 1, min=0)
            nxt = torch.where(pop, stack[act, top], nxt)
            sp[act] = torch.where(pop, top, sp_a)
            ptr[act] = nxt
        return best, local

    any_hit = mode == "any"
    ptr = torch.where(alive, 0, m)
    while True:
        act = torch.nonzero(ptr < m).squeeze(1)
        if act.numel() == 0:
            break
        p = ptr[act]
        nd = ni_t[p]
        is_leaf = nd[:, 1] > 0
        lim = tfar[act] if any_hit else torch.minimum(tfar[act], best[act])
        hit = box_hit(box_t[p], o[act], inv[act], tnear[act], lim)
        ptr[act] = torch.where(hit & ~is_leaf, p + 1, nd[:, 2])
        ev = hit & is_leaf
        work["box"] += act.numel()
        work["tri"] += int(ev.sum()) * pack.leaf
        found = _leaf_update(pack, act[ev], nd[ev, 0], o, d, tnear, lim[ev], best, local,
                             any_hit)
        if any_hit:
            ptr[found] = m  # leave the walk at the first hit
    return best, local


walk3_twin.launches = dict.fromkeys(MODES, 0)
walk3_twin.work = {"box": 0, "tri": 0}


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str):
    fn = getattr(_build.load_library(name), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    return fn


def _launch(name, pack: Bvh3Pack, o, d, tnear, tfar, mode):
    """Check the inputs and launch csrc/<name>.cu in `mode` on the current
    stream: (t (n,) f32, local slot (n,) i64; -1 = miss)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    n = o.shape[0]
    check_rays(o, d, tnear, tfar)
    _build.check_cuda("pack.box_t", pack.box_t, torch.float32, (pack.n_nodes, 8), like=o)
    _build.check_cuda("pack.ni_t", pack.ni_t, torch.int32, (pack.n_nodes, 4), like=o)
    _build.check_cuda("pack.tri_planes", pack.tri_planes, torch.float32, like=o)
    out_t = torch.empty((n,), dtype=torch.float32, device=o.device)
    out_local = torch.empty((n,), dtype=torch.int32, device=o.device)
    p = _build.ptr
    err = _kernel_fn(name)(p(o), p(d), p(tnear), p(tfar), p(pack.box_t), p(pack.ni_t),
                           p(pack.tri_planes), pack.n_nodes, MODES.index(mode), n, pack.leaf,
                           p(out_t), p(out_local), _build.stream_of(o))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out_t, out_local.long()


def walk3_cuda(pack: Bvh3Pack, o, d, tnear, tfar, mode: str = "ordered"):
    """Launch the CUDA K4 walk (csrc/bvh2_walk.cu) on the current stream.
    Returns (t (n,) f32, local slot (n,) i64; -1 = miss), as walk3_twin.
    All three modes test their leaves per warp. Raises on a pack whose
    leaves are not LEAF wide: the leaf step splits exactly that many slots
    across a warp."""
    if pack.leaf != LEAF:
        raise ValueError(f"the K4 kernel takes leaves of {LEAF} slots; the pack's are "
                         f"{pack.leaf} wide")
    out = _launch("bvh2_walk", pack, o, d, tnear, tfar, mode)
    walk3_cuda.launches[mode] += 1
    return out


walk3_cuda.launches = dict.fromkeys(MODES, 0)


def walk3_cuda_v1(pack: Bvh3Pack, o, d, tnear, tfar, mode: str = "ordered"):
    """Launch the first CUDA form of the K4 walk (csrc/bvh2_walk_v1.cu: one
    thread per ray, a serial slot loop), kept to be measured beside the
    kernel; no query launches it. Its launches are counted per mode."""
    out = _launch("bvh2_walk_v1", pack, o, d, tnear, tfar, mode)
    walk3_cuda_v1.launches[mode] += 1
    return out


walk3_cuda_v1.launches = dict.fromkeys(MODES, 0)


def walk3(pack: Bvh3Pack, o, d, tnear, tfar, mode: str = "ordered"):
    """K4 walk on the rays' device: CUDA -> the kernel, CPU -> the twin."""
    if o.is_cuda:
        return walk3_cuda(pack, o, d, tnear, tfar, mode)
    if o.device.type == "cpu":
        return walk3_twin(pack, o, d, tnear, tfar, mode)
    raise ValueError(f"no K4 walk for device {o.device}")


def intersect_bvh3(pack: Bvh3Pack, tris, o, d, tnear, tfar, ordered: bool = True) -> Hit:
    """Closest hit (intersect_bvh_pallas3; ordered=False is the skip walk of
    _launch3(ordered=False)): prim = scene tri id, u/v in exact f32."""
    t, local = walk3(pack, o, d, tnear, tfar, "ordered" if ordered else "skip")
    return hit_from_slots(pack.prim_map, tris, o, d, t, local)


def occluded_bvh3(pack: Bvh3Pack, o, d, tnear, tfar):
    """Any-hit query -> bool per ray (occluded_bvh_pallas3)."""
    _, local = walk3(pack, o, d, tnear, tfar, "any")
    return local >= 0


# ---------------------------------------------------------------------------
# the new kernel's bookkeeping, emulated for the CPU tests
# ---------------------------------------------------------------------------

def coop_walk3(pack: Bvh3Pack, o, d, tnear, tfar, mode: str = "ordered"):
    """csrc/bvh2_walk.cu's three walks as the kernel schedules them, in
    plain torch. Lanes form groups of WARP. Every lane descends by the
    kernel's rules until it parks a leaf whose box it hits or its walk
    ends: the skip and any walks move on to skip[ptr], the ordered walk pops
    its next pointer, and none tests that node's box before the leaf step.
    Then each group runs leaf steps while a lane is parked: the lowest
    parked lane leads, the lanes parked on its leaf are the members, and
    each member's leaf is tested against the lim it has at that step,
    min(tfar, best), through the warp's leaf step (bvh8.coop_leaf_step).
    The closest-hit walks latch no lane and merge with coop_merge. "any"
    latches every lane: best stays INF until its walk ends, so its lim is
    tfar, and a member with a hit takes its leaf's lowest hit slot with that
    slot's t and ends its walk. Returns (t, local) as walk3_twin; the slot
    test is the twin's (bvh8.plane_leaf). `coop_walk3.work` counts box and
    slot tests as walk3_twin.work does."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    n, m, L = o.shape[0], pack.n_nodes, pack.leaf
    tfar = torch.clamp(tfar, max=INF)
    inv = safe_inv(d)
    pos = d >= 0.0
    box_t, ni_t = pack.box_t, pack.ni_t.long()
    best = torch.full((n,), INF)
    local = torch.full((n,), -1, dtype=torch.int64)
    ptr = torch.where(tnear < tfar, 0, -1)  # -1: the walk is over
    parked = torch.full((n,), -1, dtype=torch.int64)
    sp = torch.zeros(n, dtype=torch.int64)
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int64)
    group = torch.arange(n) // WARP
    n_groups = (n + WARP - 1) // WARP
    work = coop_walk3.work = {"box": 0, "tri": 0}
    while True:
        # descend: each lane until it parks a leaf or its walk ends
        while True:
            act = torch.nonzero((parked < 0) & (ptr >= 0)).squeeze(1)
            if act.numel() == 0:
                break
            p = ptr[act]
            nd = ni_t[p]
            is_leaf = nd[:, 1] > 0
            oa, ia, tn = o[act], inv[act], tnear[act]
            lim = torch.minimum(tfar[act], best[act])
            work["box"] += act.numel() + (int((~is_leaf).sum()) if mode == "ordered" else 0)
            if mode != "ordered":
                h = box_hit(box_t[p], oa, ia, tn, lim)
                parked[act] = torch.where(h & is_leaf, nd[:, 0], -1)
                nxt = torch.where(h & ~is_leaf, p + 1, nd[:, 2])
                ptr[act] = torch.where(nxt < m, nxt, -1)
                continue
            parked[act] = torch.where(is_leaf & box_hit(box_t[p], oa, ia, tn, lim), nd[:, 0], -1)
            left = torch.clamp(p + 1, max=m - 1)
            right = torch.clamp(ni_t[left, 2], max=m - 1)
            hl = box_hit(box_t[left], oa, ia, tn, lim) & ~is_leaf
            hr = box_hit(box_t[right], oa, ia, tn, lim) & ~is_leaf
            code = nd[:, 3]
            left_near = ((code & 1) == 1) == pos[act].gather(1, (code // 2)[:, None])[:, 0]
            both = hl & hr
            sp_a = sp[act]
            stack[act[both], sp_a[both]] = torch.where(left_near, right, left)[both]
            sp_a = sp_a + both.long()
            nxt = torch.where(both, torch.where(left_near, left, right),
                              torch.where(hl, left, torch.where(hr, right, -1)))
            pop = (nxt < 0) & (sp_a > 0)  # popped after a park too; its box waits
            top = torch.clamp(sp_a - 1, min=0)
            ptr[act] = torch.where(pop, stack[act, top], nxt)
            sp[act] = torch.where(pop, top, sp_a)
        if not bool((parked >= 0).any()):
            return best, local
        # leaf rounds of every group until none of its lanes is parked
        while True:
            want = torch.nonzero(parked >= 0).squeeze(1)
            if want.numel() == 0:
                break
            leader = torch.full((n_groups,), n).scatter_reduce(0, group[want], want, "amin")
            lead_leaf = parked[torch.clamp(leader, max=n - 1)]
            mem = want[parked[want] == lead_leaf[group[want]]]
            blk = parked[mem]
            work["tri"] += mem.numel() * L
            t, h = plane_leaf(pack.tri_planes[blk], o[mem], d[mem], tnear[mem],
                              torch.minimum(tfar[mem], best[mem]))
            latched = torch.full((mem.numel(),), mode == "any", dtype=torch.bool)
            t_win, slot = coop_leaf_step(t, h, latched)
            if mode == "any":  # BinWalker::latch_hit: best = the slot's t, the walk ends
                hit = slot >= 0
                best[mem] = torch.where(hit, t_win, best[mem])
                local[mem] = torch.where(hit, blk * L + slot, local[mem])
                ptr[mem[hit]] = -1
            else:
                best[mem], local[mem], _ = coop_merge(t_win, slot, latched, best[mem],
                                                      local[mem], blk * L, fast=False)
            parked[mem] = -1


coop_walk3.work = {"box": 0, "tri": 0}
