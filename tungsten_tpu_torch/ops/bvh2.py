"""Binary skip-BVH with plane leaves: host pack, the CUDA walk (K4) and its twin.

Host half: a numpy copy of the node tables of `build_bvh_pack3`
(tungsten_tpu/ops/pallas_bvh2.py): `nf` (6, M) boxes and `ni` (4, M)
[leaf_blk, count, skip, ordcode], bit for bit. The leaves (plane slabs and
prim_map) are the BVH8 pack's own tensors (Bvh3Pack.from_arrays takes them
from the scene's Bvh8Pack), as the JAX package shares them between pbvh8
and pbvh3: both packs come from one tree (bvh8.tri_tree).

Kernel half: the port of K4, the three walks `_launch3` selects, as one CUDA
kernel with a mode (csrc/bvh2_walk.cu, one thread per ray) and `walk3_twin`,
its plain PyTorch version vectorised over the lanes still walking:
  "ordered"  `_walk_kernel4`: near child first, a private stack, per-ray
             best-t pruning (intersect_bvh_pallas3's default);
  "skip"     `_walk_kernel3`: stackless skip-pointer closest hit;
  "any"      `_walk_kernel3_any`: skip-pointer walk that stops at the first
             hit in (tnear, tfar) (occluded_bvh_pallas3).
`walk3` picks by the tensors' device: CUDA launches the kernel (or raises),
CPU runs the twin. Each keeps a plain launch count per mode
(`walk3_cuda.launches["ordered"]`, `walk3_twin.launches["any"]`, ...).

The ordered walk's stack holds STACK_DEPTH entries (pallas_bvh2.py
`_STACK_DEPTH`). The JAX package never checks a tree against it; the port
refuses a deeper tree in Bvh3Pack.from_arrays.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import _build
from .bvh8 import Bvh8Pack, box_hit, check_rays, hit_from_slots, plane_leaf, safe_inv
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


def _kernel_fn():
    fn = _build.load_library("bvh2_walk").bvh2_walk
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    return fn


def walk3_cuda(pack: Bvh3Pack, o, d, tnear, tfar, mode: str = "ordered"):
    """Launch the CUDA K4 walk (csrc/bvh2_walk.cu) on the current stream.
    Returns (t (n,) f32, local slot (n,) i64; -1 = miss), as walk3_twin."""
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
    err = _kernel_fn()(p(o), p(d), p(tnear), p(tfar), p(pack.box_t), p(pack.ni_t),
                       p(pack.tri_planes), pack.n_nodes, MODES.index(mode), n, pack.leaf,
                       p(out_t), p(out_local), _build.stream_of(o))
    if err != 0:
        raise RuntimeError(f"bvh2_walk launch failed: CUDA error {err}")
    walk3_cuda.launches[mode] += 1
    return out_t, out_local.long()


walk3_cuda.launches = dict.fromkeys(MODES, 0)


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
