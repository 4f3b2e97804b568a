"""Batched vector math on torch tensors (float32, SoA-last layout).

Port of tungsten_tpu/math/vecops.py: every function takes tensors whose last
axis is the 3-vector, so a wavefront of N rays is (N, 3).
"""
from __future__ import annotations

import torch

F32_MAX = torch.finfo(torch.float32).max


def dot(a, b, keepdims=False):
    return torch.sum(a * b, dim=-1, keepdim=keepdims)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length(v, keepdims=False):
    return torch.sqrt(torch.clamp(dot(v, v, keepdims=keepdims), min=0.0))


def length_sq(v, keepdims=False):
    return dot(v, v, keepdims=keepdims)


def normalize(v, eps=0.0):
    n = length(v, keepdims=True)
    if eps:
        n = torch.clamp(n, min=eps)
    return v / n


def reflect(wi_z_up):
    """Mirror reflection in the local frame (normal = +z): (-x, -y, z)."""
    return wi_z_up * wi_z_up.new_tensor([-1.0, -1.0, 1.0])


def lerp(a, b, t):
    return a + (b - a) * t


def avg3(v):
    return torch.mean(v, dim=-1)


def max3(v):
    return torch.amax(v, dim=-1)


def tangent_frame(n):
    """Orthonormal basis from a normal, (..., 3) -> (t, b) [Duff et al. 2017],
    the reference's TangentFrame (src/core/math/TangentFrame.hpp:23-31)."""
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]], dim=-1
    )
    bt = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, bt


def to_local(t, b, n, v):
    """World -> tangent space: (v.t, v.b, v.n)."""
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)


def to_global(t, b, n, v):
    """Tangent -> world: t*x + b*y + n*z."""
    return t * v[..., 0:1] + b * v[..., 1:2] + n * v[..., 2:3]


def where3(mask, a, b):
    """Select on a (...,) mask applied to (..., 3) operands."""
    return torch.where(mask[..., None], a, b)


def safe_rsqrt(x, eps=1e-20):
    return torch.where(x > eps, 1.0 / torch.sqrt(torch.clamp(x, min=eps)), 0.0)


def safe_div(a, b, eps=0.0):
    """a/b with `eps` where b == 0 (pdf guards)."""
    return torch.where(b != 0.0, a / torch.where(b != 0.0, b, 1.0), eps)
