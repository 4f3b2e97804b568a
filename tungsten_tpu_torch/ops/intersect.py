"""Ray-triangle intersection: the Hit record and the brute-force reference.

Port of tungsten_tpu/ops/intersect.py:24-154. `intersect_brute` is the plain
all-pairs Moller-Trumbore that every walk is held against, and the render's
intersector at 64 triangles or fewer. Above that the render falls through
the scene's packs (integrators/path_tracer.py `_intersect_tris`): the BVH8
walk (ops/bvh8.py, K3), the gather walk (ops/gather_bvh.py, K1), the packet
walk (ops/bvh.py, K5) or the streaming brute force (ops/intersect_stream.py,
K2). The XLA binary skip-walk
`intersect_bvh`, the JAX package's intersector off the TPU, is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..math import vecops as vo

INF = 3.0e38


@dataclass
class TriangleSoA:
    v0: torch.Tensor  # (T, 3)
    e1: torch.Tensor  # (T, 3)  p1 - p0
    e2: torch.Tensor  # (T, 3)  p2 - p0


@dataclass
class Hit:
    t: torch.Tensor  # (N,) hit distance (INF if miss)
    prim: torch.Tensor  # (N,) int64 triangle index, -1 if miss
    u: torch.Tensor  # (N,) barycentric of the e1 vertex
    v: torch.Tensor  # (N,) barycentric of the e2 vertex


def ray_tri(o, d, v0, e1, e2, tnear, tfar):
    """Moller-Trumbore on broadcastable (..., 3) / (...,) tensors.
    Returns (t, u, v, hit)."""
    pvec = vo.cross(d, e2)
    det = vo.dot(e1, pvec)
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tvec = o - v0
    u = vo.dot(tvec, pvec) * inv_det
    qvec = vo.cross(tvec, e1)
    v = vo.dot(d, qvec) * inv_det
    t = vo.dot(e2, qvec) * inv_det
    hit = (
        (torch.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > tnear) & (t < tfar)
    )
    return t, u, v, hit


def intersect_brute(tris: TriangleSoA, o, d, tnear, tfar, chunk: int = 512) -> Hit:
    """Chunked all-pairs closest hit; the lowest index wins an exact tie."""
    n = o.shape[0]
    dev = o.device
    bt = torch.full((n,), INF, dtype=torch.float32, device=dev)
    bp = torch.full((n,), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros((n,), dtype=torch.float32, device=dev)
    bv = torch.zeros((n,), dtype=torch.float32, device=dev)
    for s in range(0, tris.v0.shape[0], chunk):
        t, u, v, hit = ray_tri(
            o[:, None, :], d[:, None, :], tris.v0[None, s:s + chunk],
            tris.e1[None, s:s + chunk], tris.e2[None, s:s + chunk],
            tnear[:, None], tfar[:, None],
        )
        t = torch.where(hit, t, INF)
        tbest, j = torch.min(t, dim=1)
        better = tbest < bt
        bt = torch.where(better, tbest, bt)
        bp = torch.where(better, s + j, bp)
        bu = torch.where(better, u.gather(1, j[:, None])[:, 0], bu)
        bv = torch.where(better, v.gather(1, j[:, None])[:, 0], bv)
    bp = torch.where(bt < INF, bp, -1)
    return Hit(t=bt, prim=bp, u=bu, v=bv)
