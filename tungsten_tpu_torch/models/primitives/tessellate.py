"""Host-side tessellation of quads and cubes into the triangle soup.

Numpy copy of the quad()/cube() half of
tungsten_tpu/models/primitives/tessellate.py (same corners, uvs and winding,
so the flattened tables match the JAX package's exactly). Results are in
LOCAL space; flatten_scene applies the primitive transform.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class TriSoup:
    pos: np.ndarray  # (V, 3)
    normal: Optional[np.ndarray]  # (V, 3) shading normals or None -> flat
    uv: np.ndarray  # (V, 2)
    indices: np.ndarray  # (F, 3)


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
