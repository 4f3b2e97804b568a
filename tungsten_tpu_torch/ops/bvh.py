"""Packet-pack skip-BVH with Moller-Trumbore leaves: host pack, the CUDA walk
(K5, both versions) and its twin.

Host half: a numpy copy of `build_bvh_pack` (tungsten_tpu/ops/pallas_bvh.py):
`nodes` (nblk*16, 128) with node j's fields [min3 | max3 | leaf_blk | count |
skip] in lane j % 128 of block j // 128, `tris` (n_leaves*16, 128) with
[v0 | e1 | e2] of leaf slot s in lane s, and `prim_map` (padding slots map
to 0), bit for bit. The tree is the scene's one binary tree (bvh8.tri_tree,
128-triangle leaves).

Kernel half: the port of K5 as the CUDA kernel csrc/bvh_walk.cu (the
stackless skip walk per thread, 128-slot Moller-Trumbore leaves with
`ray_tri`'s accept rule tested per warp from shared memory) and
`walk_packet_twin`, its plain PyTorch version,
in two modes: prune=True is K5-v2, `_walk_kernel2` (launched by
`_launch2`), whose box tests use the ray's best hit so far; prune=False is
K5-v1, `_walk_kernel` (launched by `_launch`), whose box tests use the
ray's own tfar. `intersect_bvh` picks the mode by the module constant V2,
as intersect_bvh_pallas does. The kernel reads node-major copies made once
here: the box row (M, 8) f32 and the integer fields (M, 4) i32, converted
from their exact f32 values, and the triangles leaf major (n_leaves, 128,
9). `walk_packet` picks by device: CUDA launches the kernel (or raises),
CPU runs the twin; each keeps a plain launch count per version.
`walk_packet_cuda_v1` launches the first CUDA form (csrc/bvh_walk_v1.cu, one
thread per ray; "v1" there means the first CUDA form, not the TPU's K5-v1),
kept for measurement; no query launches it. The kernel, its first form and
the twin agree bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import _build
from .bvh2 import tree_depth
from .bvh8 import box_hit, check_rays, safe_inv
from .intersect import INF, Hit

LEAF = 128  # one lane width of triangles per leaf (pallas_bvh.py LEAF)
V2 = True  # intersect_bvh walks with per-ray best-t pruning (pallas_bvh.py:264)
_TWIN_LEAF_CHUNK = 8192  # leaf lanes evaluated per twin step (bounds memory)


# ---------------------------------------------------------------------------
# host half
# ---------------------------------------------------------------------------

def build_bvh_pack(v0, e1, e2, bvh) -> dict:
    """Numpy K5 pack in the JAX package's layout, from the triangles'
    tri_tree `bvh` (128-triangle leaves): {"nodes" (nblk*16, 128),
    "tris" (n_leaves*16, 128), "prim_map" (n_leaves*128,)}."""
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    m = len(bvh.count)
    leaf_mask = bvh.count > 0
    leaf_ids = np.cumsum(leaf_mask) - 1
    n_leaves = int(leaf_mask.sum())

    tris_rows = np.zeros((n_leaves * 16, 128), np.float32)
    prim_map = np.zeros((n_leaves * 128,), np.int32)
    for n in np.where(leaf_mask)[0]:
        s = int(leaf_ids[n])
        f, c = int(bvh.first[n]), int(bvh.count[n])
        gid = bvh.prim_order[f: f + c]
        r = s * 16
        tris_rows[r + 0: r + 3, :c] = v0[gid].T
        tris_rows[r + 3: r + 6, :c] = e1[gid].T
        tris_rows[r + 6: r + 9, :c] = e2[gid].T
        prim_map[s * 128: s * 128 + c] = gid

    mpad = ((m + 127) // 128) * 128
    nodes16 = np.zeros((16, mpad), np.float32)
    nodes16[0:3, :m] = bvh.node_min.T
    nodes16[3:6, :m] = bvh.node_max.T
    nodes16[6, :m] = np.where(leaf_mask, leaf_ids, 0)
    nodes16[7, :m] = bvh.count
    nodes16[8, :m] = bvh.skip
    nblk = mpad // 128
    nodes_rows = nodes16.reshape(16, nblk, 128).transpose(1, 0, 2).reshape(nblk * 16, 128)
    return {"nodes": nodes_rows, "tris": tris_rows, "prim_map": prim_map}


@dataclass
class BvhPack:
    """The K5 pack on one device: the JAX layouts plus the walk's copies."""

    nodes: torch.Tensor  # (nblk*16, 128) f32 field rows per 128-node block
    tris: torch.Tensor  # (n_leaves*16, 128) f32 [v0 | e1 | e2 | 0] rows per leaf
    prim_map: torch.Tensor  # (n_leaves*128,) i32 leaf slot -> scene tri id
    box_t: torch.Tensor  # (M, 8) f32 node-major [min3 | max3 | 0 0]
    ni_t: torch.Tensor  # (M, 4) i32 node-major [leaf_blk, count, skip, 0]
    tri_t: torch.Tensor  # (n_leaves, 128, 9) f32 [v0 | e1 | e2] per slot

    @property
    def n_nodes(self) -> int:
        return self.box_t.shape[0]

    @staticmethod
    def from_arrays(arrays: dict, n_nodes: int, device) -> "BvhPack":
        """From {"nodes", "tris", "prim_map"} and the tree's node count, which
        the padded `nodes` does not record (the JAX pack keeps it as a static
        field). Raises on node fields that would send a walk out of range."""
        nodes = np.asarray(arrays["nodes"], np.float32)
        tris = np.asarray(arrays["tris"], np.float32)
        nblk, n_leaves = nodes.shape[0] // 16, tris.shape[0] // 16
        if nodes.shape != (nblk * 16, 128) or tris.shape != (n_leaves * 16, 128) \
                or not 0 < n_nodes <= nblk * 128:
            raise ValueError(f"nodes {nodes.shape} / tris {tris.shape} / n_nodes {n_nodes}")
        node16 = nodes.reshape(nblk, 16, 128).transpose(0, 2, 1).reshape(-1, 16)[:n_nodes]
        box_t = np.zeros((n_nodes, 8), np.float32)
        box_t[:, :6] = node16[:, :6]
        ni_t = np.zeros((n_nodes, 4), np.int32)
        ni_t[:, :3] = node16[:, 6:9]  # exact f32 integers below 2^24
        tree_depth(ni_t[:, 1], ni_t[:, 2])
        leaf = ni_t[:, 1] > 0
        if leaf.any() and not (ni_t[leaf, 0].min() >= 0 and ni_t[leaf, 0].max() < n_leaves
                               and ni_t[:, 1].max() <= LEAF):
            raise ValueError("leaf blocks outside the pack's triangles")
        tri_t = tris.reshape(n_leaves, 16, 128)[:, :9].transpose(0, 2, 1)

        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=device)

        return BvhPack(nodes=t(nodes), tris=t(tris),
                       prim_map=t(np.asarray(arrays["prim_map"], np.int32)),
                       box_t=t(box_t), ni_t=t(ni_t), tri_t=t(tri_t))


# ---------------------------------------------------------------------------
# kernel half
# ---------------------------------------------------------------------------

def mt_leaf(T, o, d, tnear, lim):
    """k rays against their leaves' triangles T (k, 128, 9) = v0 | e1 | e2,
    Moller-Trumbore in `_walk_kernel2`'s order of operations and with
    `ray_tri`'s accept rule: (t, u, v, hit), each (k, 128). All-zero padding
    slots have det = 0 and never hit."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (T[..., j] for j in range(9))
    ox, oy, oz = (o[:, j:j + 1] for j in range(3))
    dx, dy, dz = (d[:, j:j + 1] for j in range(3))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > tnear[:, None]) & (t < lim[:, None]))
    return t, u, v, hit


def _version(prune: bool) -> str:
    return "v2" if prune else "v1"


def walk_packet_twin(pack: BvhPack, o, d, tnear, tfar, prune: bool = True):
    """Plain PyTorch K5 walk with the kernel's per-ray semantics (prune: box
    tests against min(tfar, best), else against tfar). Returns (t (n,) f32,
    local slot (n,) i64 (-1 = miss), u (n,), v (n,)). `walk_packet_twin.work`
    records the call's box tests ("box") and leaf slot tests ("tri")."""
    walk_packet_twin.launches[_version(prune)] += 1
    n = o.shape[0]
    dev = o.device
    m = pack.n_nodes
    inv = safe_inv(d)
    best = torch.full((n,), INF, dtype=torch.float32, device=dev)
    local = torch.full((n,), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros((n,), dtype=torch.float32, device=dev)
    bv = torch.zeros((n,), dtype=torch.float32, device=dev)
    ni_t = pack.ni_t.long()
    ptr = torch.where(tnear < tfar, 0, m)  # dead lanes do no work
    boxes = slots = 0
    while True:
        act = torch.nonzero(ptr < m).squeeze(1)
        if act.numel() == 0:
            break
        p = ptr[act]
        nd = ni_t[p]
        is_leaf = nd[:, 1] > 0
        lim = torch.minimum(tfar[act], best[act])
        hit = box_hit(pack.box_t[p], o[act], inv[act], tnear[act], lim if prune else tfar[act])
        ptr[act] = torch.where(hit & ~is_leaf, p + 1, nd[:, 2])
        ev = hit & is_leaf
        lanes_all, blk_all, lim_all = act[ev], nd[ev, 0], lim[ev]
        boxes += act.numel()
        slots += lanes_all.numel() * LEAF
        for c0 in range(0, lanes_all.numel(), _TWIN_LEAF_CHUNK):
            lanes = lanes_all[c0:c0 + _TWIN_LEAF_CHUNK]
            blk = blk_all[c0:c0 + _TWIN_LEAF_CHUNK]
            t, u, v, h = mt_leaf(pack.tri_t[blk], o[lanes], d[lanes], tnear[lanes],
                                 lim_all[c0:c0 + _TWIN_LEAF_CHUNK])
            tb, slot = torch.min(torch.where(h, t, INF), dim=1)  # lowest slot wins a tie
            any_h = h.any(dim=1)
            best[lanes] = torch.where(any_h, tb, best[lanes])
            local[lanes] = torch.where(any_h, blk * LEAF + slot, local[lanes])
            bu[lanes] = torch.where(any_h, u.gather(1, slot[:, None])[:, 0], bu[lanes])
            bv[lanes] = torch.where(any_h, v.gather(1, slot[:, None])[:, 0], bv[lanes])
    walk_packet_twin.work = {"box": boxes, "tri": slots}
    return best, local, bu, bv


walk_packet_twin.launches = {"v1": 0, "v2": 0}
walk_packet_twin.work = {"box": 0, "tri": 0}


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str):
    fn = getattr(_build.load_library(name), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
    return fn


def _launch(name, pack: BvhPack, o, d, tnear, tfar, prune):
    n = o.shape[0]
    check_rays(o, d, tnear, tfar)
    _build.check_cuda("pack.box_t", pack.box_t, torch.float32, (pack.n_nodes, 8), like=o)
    _build.check_cuda("pack.ni_t", pack.ni_t, torch.int32, (pack.n_nodes, 4), like=o)
    _build.check_cuda("pack.tri_t", pack.tri_t, torch.float32,
                      (pack.tri_t.shape[0], LEAF, 9), like=o)
    if pack.tri_t.data_ptr() % 16:
        raise ValueError("pack.tri_t: the kernel copies leaves in 16-byte pieces; need a "
                         "16-byte aligned tensor")
    out = torch.empty((3, n), dtype=torch.float32, device=o.device)  # t, u, v
    out_local = torch.empty((n,), dtype=torch.int32, device=o.device)
    p = _build.ptr
    err = _kernel_fn(name)(p(o), p(d), p(tnear), p(tfar), p(pack.box_t), p(pack.ni_t),
                           p(pack.tri_t), pack.n_nodes, n, int(prune), p(out[0]), p(out_local),
                           p(out[1]), p(out[2]), _build.stream_of(o))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out[0], out_local.long(), out[1], out[2]


def walk_packet_cuda(pack: BvhPack, o, d, tnear, tfar, prune: bool = True):
    """Launch the CUDA K5 walk (csrc/bvh_walk.cu) on the current stream.
    Returns (t, local slot (i64, -1 = miss), u, v), as walk_packet_twin."""
    out = _launch("bvh_walk", pack, o, d, tnear, tfar, prune)
    walk_packet_cuda.launches[_version(prune)] += 1
    return out


walk_packet_cuda.launches = {"v1": 0, "v2": 0}


def walk_packet_cuda_v1(pack: BvhPack, o, d, tnear, tfar, prune: bool = True):
    """Launch the first CUDA form of the K5 walk (csrc/bvh_walk_v1.cu: one
    thread per ray, a serial slot loop), kept to be measured beside the
    kernel; no query launches it. Its launches are counted per TPU version
    ("v1": prune=False, "v2": prune=True)."""
    out = _launch("bvh_walk_v1", pack, o, d, tnear, tfar, prune)
    walk_packet_cuda_v1.launches[_version(prune)] += 1
    return out


walk_packet_cuda_v1.launches = {"v1": 0, "v2": 0}


def walk_packet(pack: BvhPack, o, d, tnear, tfar, prune: bool = True):
    """K5 walk on the rays' device: CUDA -> the kernel, CPU -> the twin."""
    if o.is_cuda:
        return walk_packet_cuda(pack, o, d, tnear, tfar, prune)
    if o.device.type == "cpu":
        return walk_packet_twin(pack, o, d, tnear, tfar, prune)
    raise ValueError(f"no K5 walk for device {o.device}")


def hit_from_local(pack: BvhPack, t, local, u, v) -> Hit:
    """The Hit of a K5 walk's (t, local slot, u, v): slot -> scene tri id
    through prim_map; t, u and v are the walk's own, t = INF on a miss."""
    prim_map = pack.prim_map
    prim = torch.where(
        local >= 0, prim_map[torch.clamp(local, 0, prim_map.shape[0] - 1)].long(), -1)
    return Hit(t=torch.where(prim >= 0, t, INF), prim=prim, u=u, v=v)


def intersect_bvh(pack: BvhPack, o, d, tnear, tfar) -> Hit:
    """Closest hit (intersect_bvh_pallas): K5-v2 when V2, else K5-v1."""
    return hit_from_local(pack, *walk_packet(pack, o, d, tnear, tfar, V2))
