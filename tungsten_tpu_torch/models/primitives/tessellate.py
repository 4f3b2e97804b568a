"""Host-side tessellation of quads, cubes and curves into the triangle soup.

Numpy copy of the quad() / cube() / curve_tubes() part of
tungsten_tpu/models/primitives/tessellate.py (same corners, uvs, rings and
winding, so the flattened tables match the JAX package's exactly). Results
are in LOCAL space; flatten_scene applies the primitive transform.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class TriSoup:
    pos: np.ndarray  # (V, 3)
    normal: Optional[np.ndarray]  # (V, 3) shading normals or None -> flat
    uv: np.ndarray  # (V, 2)
    indices: np.ndarray  # (F, 3)
    tangent: Optional[np.ndarray] = None  # (V, 3) fiber tangents (curves)


def quad() -> TriSoup:
    # corners: base, base+e0, base+e0+e1, base+e1 in local space where
    # base = -(e0+e1)/2, e0 = x axis, e1 = z axis (Quad::prepareForRender)
    c = np.array(
        [[-0.5, 0, -0.5], [0.5, 0, -0.5], [0.5, 0, 0.5], [-0.5, 0, 0.5]], np.float32
    )
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    # winding (0,2,1),(0,3,2) makes cross(p1-p0, p2-p0) == normalize(e1 x e0)
    idx = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    return TriSoup(pos=c, normal=None, uv=uv, indices=idx)


def cube() -> TriSoup:
    pos, uv, idx = [], [], []
    # each face: (axis, sign); build so normals point outward
    for axis in range(3):
        for sign in (-1.0, 1.0):
            a = (axis + 1) % 3
            b = (axis + 2) % 3
            corners = np.zeros((4, 3), np.float32)
            quads_ab = [(-0.5, -0.5), (0.5, -0.5), (0.5, 0.5), (-0.5, 0.5)]
            for i, (ua, ub) in enumerate(quads_ab):
                corners[i, axis] = 0.5 * sign
                corners[i, a] = ua
                corners[i, b] = ub
            base = len(pos)
            pos.extend(corners)
            uv.extend([[0, 0], [1, 0], [1, 1], [0, 1]])
            if sign > 0:
                idx.append([base + 0, base + 1, base + 2])
                idx.append([base + 0, base + 2, base + 3])
            else:
                idx.append([base + 0, base + 2, base + 1])
                idx.append([base + 0, base + 3, base + 2])
    return TriSoup(
        pos=np.asarray(pos, np.float32),
        normal=None,
        uv=np.asarray(uv, np.float32),
        indices=np.asarray(idx, np.int32),
    )


def _dot3(a, b):
    """Row-wise dot of (G, 3) vectors in float64, rounded as np.dot rounds
    one pair (batched matmul goes the same BLAS way; a plain sum of the
    products does not, in the last bit)."""
    return np.matmul(a[:, None, :].astype(np.float64), b[:, :, None].astype(np.float64))[:, 0, 0]


def _norm3(a):
    return np.sqrt(_dot3(a, a))


def _strand_rings(pts, rad, taper, ca, sa):
    """The rings of G strands of m nodes each, pts (G, m, 3) float32, rad
    (G, m): the parallel transport of tessellate.py's curve_tubes run down all
    G strands at once, node by node, in its arithmetic (float32 tangents,
    float64 frames). Returns (positions, normals, tangents), each
    (G, m, sides, 3)."""
    g, m = rad.shape
    sides = len(ca)
    rad = rad.copy()
    if taper:
        rad *= np.linspace(1.0, 0.0, m, dtype=np.float32)
    tang = np.diff(pts, axis=1)
    tang = np.concatenate([tang, tang[:, -1:]], axis=1)
    tang /= np.maximum(np.linalg.norm(tang, axis=2, keepdims=True), 1e-12)
    n0 = np.cross(tang[:, 0], np.array([0.0, 1.0, 0.0]))
    side = _norm3(n0) < 1e-6
    n0[side] = np.cross(tang[side, 0], [1.0, 0.0, 0.0])
    n0 /= _norm3(n0)[:, None]
    nrm = n0
    ring_p = np.empty((g, m, sides, 3))
    ring_n = np.empty((g, m, sides, 3))
    for k in range(m):
        tk = tang[:, k]
        nrm = nrm - tk * _dot3(nrm, tk)[:, None]
        ln = _norm3(nrm)
        nrm = np.where((ln < 1e-9)[:, None], n0, nrm / ln[:, None])
        bt = np.cross(tk, nrm)
        rn = nrm[:, None, :] * ca[None, :, None] + bt[:, None, :] * sa[None, :, None]
        ring_n[:, k] = rn
        ring_p[:, k] = pts[:, k, None, :] + rn * np.maximum(rad[:, k], 1e-6)[:, None, None]
    return ring_p, ring_n, np.broadcast_to(tang[:, :, None, :], (g, m, sides, 3))


def curve_tubes(curve_ends, nodes, sides: int = 3, taper: bool = False,
                subsample: float = 1.0, max_tris: int = 1 << 20,
                seed: int = 0x5EED) -> TriSoup:
    """Tessellate curve strands (Curves.cpp modes cylinder / half_cylinder /
    bcsdf_cylinder / ribbon all become thin tubes) into `sides`-gonal tubes
    with per-node radius and optional tip taper. `subsample` keeps that
    fraction of strands, drawn from `seed` (Curves.cpp "subsample"); an
    additional stride is applied, with a warning, if the result would exceed
    max_tris.

    tessellate.py's curve_tubes walks one strand at a time; here the strands
    of one node count walk together (the frames are still transported node
    by node), and the rings, uvs and triangles are laid out in its order."""
    curve_ends = np.asarray(curve_ends, np.int64)
    nodes = np.asarray(nodes, np.float32)
    starts = np.concatenate([[0], curve_ends[:-1]])
    n_curves = len(curve_ends)
    keep = np.arange(n_curves)
    if subsample < 1.0:
        rng = np.random.default_rng(seed)
        keep = keep[rng.random(n_curves) < subsample]
    seg_total = int((curve_ends - starts - 1)[keep].clip(min=0).sum())
    est_tris = seg_total * sides * 2
    if est_tris > max_tris:
        stride = int(np.ceil(est_tris / max_tris))
        warnings.warn(
            f"curve tessellation budget: {est_tris} tris exceed max_tris="
            f"{max_tris}; keeping every {stride}-th strand "
            f"({len(keep[::stride])}/{len(keep)}). The reference renders "
            f"every strand (Curves.cpp has no such cap) — raise the "
            f"primitive's 'max_tris' to keep full geometry.",
            stacklevel=2)
        keep = keep[::stride]
    counts = (curve_ends - starts)[keep]
    keep, counts = keep[counts >= 2], counts[counts >= 2]
    if len(keep) == 0:
        return TriSoup(pos=np.zeros((0, 3), np.float32), normal=None,
                       uv=np.zeros((0, 2), np.float32),
                       indices=np.zeros((0, 3), np.int32))

    ang = np.arange(sides) * (2.0 * np.pi / sides)
    ca, sa = np.cos(ang), np.sin(ang)
    vbase = np.concatenate([[0], np.cumsum(counts * sides)[:-1]])  # each strand's first vertex
    pos = np.empty((int(counts.sum()) * sides, 3), np.float32)
    nrm = np.empty_like(pos)
    tan = np.empty_like(pos)
    uv = np.empty((len(pos), 2), np.float32)
    idx_l, at_l = [], []
    j = np.arange(sides)
    quad = np.stack([np.stack([j, (j + 1) % sides + sides, j + sides], 1),
                     np.stack([j, (j + 1) % sides, (j + 1) % sides + sides], 1)], 1)
    for m in np.unique(counts):
        sel = np.nonzero(counts == m)[0]
        rows = starts[keep[sel]][:, None] + np.arange(m)
        rp, rn, rt = _strand_rings(nodes[rows, :3], nodes[rows, 3], taper, ca, sa)
        at = (vbase[sel][:, None] + np.arange(m * sides)).ravel()
        pos[at] = rp.reshape(-1, 3)
        nrm[at] = rn.reshape(-1, 3)
        tan[at] = rt.reshape(-1, 3)
        uv[at] = np.tile(np.stack([np.tile(ang / (2 * np.pi), m),
                                   np.repeat(np.linspace(0, 1, m), sides)], 1), (len(sel), 1))
        # segment k's triangles (two per side) start at ring k of their strand
        seg = (vbase[sel][:, None] + np.arange(m - 1) * sides)[..., None, None, None] + quad
        idx_l.append(seg.reshape(-1, 3))
        at_l.append(np.repeat(vbase[sel], (m - 1) * sides * 2))
    order = np.argsort(np.concatenate(at_l), kind="stable")  # strands in keep order
    idx = np.concatenate(idx_l)[order].astype(np.int32)
    p0, p1, p2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    ng = np.cross(p1 - p0, p2 - p0)
    flip = np.einsum("ij,ij->i", ng, nrm[idx[:, 0]]) < 0
    idx[flip] = idx[flip][:, [0, 2, 1]]
    return TriSoup(pos=pos, normal=nrm, uv=uv, indices=idx, tangent=tan)
