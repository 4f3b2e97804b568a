"""Streaming brute-force closest hit with a tile-level chunk cull: host pack,
the CUDA kernel (K2) and its twin.

Host half: a numpy copy of `PallasTriScene` (tungsten_tpu/ops/pallas_intersect.py
:171-204), bit for bit: `tris_t` (12, Tpad) with rows [v0 | e1 | e2 | 0 0 0],
Tpad a multiple of CHUNK = 2048 (zero padding triangles), and `clusters`
(n_chunks, 8) = [min3 | max3 | 0 0], the AABB of each chunk's real
triangles. TriPack adds the node-major copy (n_chunks, CHUNK, 9) that the
kernel stages from and the twin reads.

Kernel half: the port of K2, `_mt_kernel` (launched by `_launch`; API
intersect_pallas), as csrc/intersect_stream.cu and `stream_twin`, its plain
PyTorch version. Both compute, per 256-ray tile and per 2048-triangle chunk
in order: the tile's vote, any live ray hitting the chunk's AABB with
tfar = min(ray tfar, best t so far) (slab test, inv = 1 / (d == 0 ? 1e-30 :
d)); where the tile votes, Moller-Trumbore of every ray of the tile
against every triangle of the chunk with `ray_tri`'s accept rule, the
lowest index winning a tie inside the chunk and a strictly smaller t
needed across chunks. A dead ray (tnear >= tfar) votes no, as the packet
walk's `ray_ok` rule has it (pallas_bvh.py:63): it can hit nothing, but
the TPU kernel lets it vote when its origin lies inside the box. `stream`
picks by device: CUDA launches the kernel (or raises), CPU runs the twin;
each keeps a plain launch count.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import _build
from .bvh import mt_leaf
from .bvh8 import box_hit, check_rays, safe_inv
from .intersect import INF, Hit

RAY_TILE = 256  # rays per tile: one CUDA block (pallas_intersect.py RAY_TILE)
CHUNK = 2048  # triangles per chunk (pallas_intersect.py CHUNK)
_TWIN_RAYS = 8192  # rays per twin Moller-Trumbore step (bounds memory)


# ---------------------------------------------------------------------------
# host half
# ---------------------------------------------------------------------------

def build_tri_pack(v0, e1, e2) -> dict:
    """Numpy K2 pack in the JAX package's layout: {"tris_t" (12, Tpad),
    "clusters" (n_chunks, 8), "n_tris"}."""
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    t = len(v0)
    pad = (-t) % CHUNK
    if pad:
        z = np.zeros((pad, 3), np.float32)
        v0, e1, e2 = (np.concatenate([a, z]) for a in (v0, e1, e2))
    tp = len(v0)
    n_chunks = tp // CHUNK
    data = np.zeros((12, tp), np.float32)
    data[0:3] = v0.T
    data[3:6] = e1.T
    data[6:9] = e2.T
    p1 = v0 + e1
    p2 = v0 + e2
    lo = np.minimum(np.minimum(v0, p1), p2).reshape(n_chunks, CHUNK, 3)
    hi = np.maximum(np.maximum(v0, p1), p2).reshape(n_chunks, CHUNK, 3)
    cl = np.zeros((n_chunks, 8), np.float32)
    valid = (np.arange(tp).reshape(n_chunks, CHUNK) < t)[..., None]  # no padding in the AABB
    cl[:, 0:3] = np.where(valid, lo, np.inf).min(axis=1)
    cl[:, 3:6] = np.where(valid, hi, -np.inf).max(axis=1)
    return {"tris_t": data, "clusters": cl, "n_tris": t}


@dataclass
class TriPack:
    """The K2 pack on one device: the JAX layouts plus the kernel's copy."""

    tris_t: torch.Tensor  # (12, Tpad) f32 rows [v0 | e1 | e2 | 0 0 0]
    clusters: torch.Tensor  # (n_chunks, 8) f32 [min3 | max3 | 0 0]
    tri_c: torch.Tensor  # (n_chunks, CHUNK, 9) f32 [v0 | e1 | e2] per triangle
    n_tris: int

    @property
    def n_chunks(self) -> int:
        return self.clusters.shape[0]

    @staticmethod
    def from_arrays(arrays: dict, device) -> "TriPack":
        """From {"tris_t", "clusters", "n_tris"} (build_tri_pack's, or the JAX
        pack's attributes). Raises on shapes the kernel cannot take."""
        tris_t = np.asarray(arrays["tris_t"], np.float32)
        clusters = np.asarray(arrays["clusters"], np.float32)
        n_tris = int(np.asarray(arrays["n_tris"]))
        tp = tris_t.shape[1]
        if tris_t.shape != (12, tp) or tp % CHUNK or clusters.shape != (tp // CHUNK, 8) \
                or not 0 < n_tris <= tp:
            raise ValueError(f"tris_t {tris_t.shape} / clusters {clusters.shape} / "
                             f"n_tris {n_tris}: need (12, k*{CHUNK}), (k, 8), 0 < n_tris <= Tpad")
        tri_c = tris_t[:9].T.reshape(tp // CHUNK, CHUNK, 9)

        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=device)

        return TriPack(tris_t=t(tris_t), clusters=t(clusters), tri_c=t(tri_c), n_tris=n_tris)


# ---------------------------------------------------------------------------
# kernel half
# ---------------------------------------------------------------------------

def stream_twin(pack: TriPack, o, d, tnear, tfar):
    """Plain PyTorch K2 with the kernel's tile votes and accept rules.
    Returns (t (n,) f32 (INF = miss), prim (n,) i64 (-1 = miss), u, v).
    `stream_twin.work` records the call's slab tests ("box"), the
    ray-triangle tests its rays need ("tri": 2048 per live ray and chunk
    whose box that ray hits) and those the tile cull runs ("tri_tile": 256
    rays x 2048 triangles per tile and chunk it keeps)."""
    stream_twin.launches += 1
    n = o.shape[0]
    dev = o.device
    n_tiles = -(-n // RAY_TILE)
    inv = safe_inv(d)
    best = torch.full((n,), INF, dtype=torch.float32, device=dev)
    prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros((n,), dtype=torch.float32, device=dev)
    bv = torch.zeros((n,), dtype=torch.float32, device=dev)
    alive = tnear < tfar
    edge = torch.zeros((n_tiles * RAY_TILE - n,), dtype=torch.bool, device=dev)  # vote no
    votes = ray_hits = 0
    for j in range(pack.n_chunks):
        lim = torch.minimum(tfar, best)
        hit = box_hit(pack.clusters[j], o, inv, tnear, lim) & alive
        vote = torch.cat([hit, edge]).view(n_tiles, RAY_TILE).any(dim=1)
        lanes = torch.nonzero(vote.repeat_interleave(RAY_TILE)[:n]).squeeze(1)
        votes += int(vote.sum())
        ray_hits += int(hit.sum())
        tri = pack.tri_c[j][None]  # (1, CHUNK, 9)
        for s in range(0, lanes.numel(), _TWIN_RAYS):
            ln = lanes[s:s + _TWIN_RAYS]
            t, u, v, h = mt_leaf(tri, o[ln], d[ln], tnear[ln], lim[ln])
            tb, k = torch.min(torch.where(h, t, INF), dim=1)  # lowest index wins a tie
            take = h.any(dim=1)  # every hit is below lim = min(tfar, best): strictly better
            best[ln] = torch.where(take, tb, best[ln])
            prim[ln] = torch.where(take, j * CHUNK + k, prim[ln])
            bu[ln] = torch.where(take, u.gather(1, k[:, None])[:, 0], bu[ln])
            bv[ln] = torch.where(take, v.gather(1, k[:, None])[:, 0], bv[ln])
    stream_twin.work = {"box": int(alive.sum()) * pack.n_chunks, "tri": ray_hits * CHUNK,
                        "tri_tile": votes * RAY_TILE * CHUNK}
    return best, prim, bu, bv


stream_twin.launches = 0
stream_twin.work = {"box": 0, "tri": 0, "tri_tile": 0}


def _kernel_fn():
    fn = _build.load_library("intersect_stream").intersect_stream
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
    return fn


def stream_cuda(pack: TriPack, o, d, tnear, tfar):
    """Launch the CUDA K2 (csrc/intersect_stream.cu) on the current stream.
    Returns (t, prim (i64, -1 = miss), u, v), as stream_twin."""
    n = o.shape[0]
    check_rays(o, d, tnear, tfar)
    _build.check_cuda("pack.tri_c", pack.tri_c, torch.float32, (pack.n_chunks, CHUNK, 9), like=o)
    _build.check_cuda("pack.clusters", pack.clusters, torch.float32, (pack.n_chunks, 8), like=o)
    out = torch.empty((3, n), dtype=torch.float32, device=o.device)  # t, u, v
    out_prim = torch.empty((n,), dtype=torch.int32, device=o.device)
    p = _build.ptr
    err = _kernel_fn()(p(o), p(d), p(tnear), p(tfar), p(pack.tri_c), p(pack.clusters),
                       pack.n_chunks, n, p(out[0]), p(out_prim), p(out[1]), p(out[2]),
                       _build.stream_of(o))
    if err != 0:
        raise RuntimeError(f"intersect_stream launch failed: CUDA error {err}")
    stream_cuda.launches += 1
    return out[0], out_prim.long(), out[1], out[2]


stream_cuda.launches = 0


def stream(pack: TriPack, o, d, tnear, tfar):
    """K2 on the rays' device: CUDA -> the kernel, CPU -> the twin."""
    if o.is_cuda:
        return stream_cuda(pack, o, d, tnear, tfar)
    if o.device.type == "cpu":
        return stream_twin(pack, o, d, tnear, tfar)
    raise ValueError(f"no K2 for device {o.device}")


def intersect_stream(pack: TriPack, o, d, tnear, tfar) -> Hit:
    """Closest hit (intersect_pallas): prim = scene tri id, kept where t < INF
    and prim < n_tris; t = INF on a miss; u and v are the kernel's own (not
    clipped, not recomputed)."""
    t, prim, u, v = stream(pack, o, d, tnear, tfar)
    prim = torch.where((t < INF) & (prim < pack.n_tris), prim, -1)
    return Hit(t=torch.where(prim >= 0, t, INF), prim=prim, u=u, v=v)
