"""Sampling warps on torch tensors.

Port of the warps of tungsten_tpu/sampling/warps.py that the port calls: the
forward warps, and the inverse warps of RJ-MLT's path inversion
(SampleWarp.hpp:17-146). Directions are in the local frame (+z = normal).
"""
from __future__ import annotations

import math

import torch

INV_PI = 1.0 / math.pi
INV_TWO_PI = 1.0 / (2.0 * math.pi)
INV_FOUR_PI = 1.0 / (4.0 * math.pi)


def cosine_hemisphere(u):
    phi = u[..., 0] * (2.0 * math.pi)
    r = torch.sqrt(u[..., 1])
    z = torch.sqrt(torch.clamp(1.0 - u[..., 1], min=0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def cosine_hemisphere_pdf(w):
    return torch.clamp(w[..., 2], min=0.0) * INV_PI


def uniform_hemisphere(u):
    phi = (2.0 * math.pi) * u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - u[..., 1] * u[..., 1], min=0.0))
    return torch.stack([torch.cos(phi) * r, torch.sin(phi) * r, u[..., 1]], dim=-1)


def uniform_hemisphere_pdf(w):
    return torch.full(w.shape[:-1], INV_TWO_PI, dtype=torch.float32, device=w.device)


def uniform_sphere(u):
    phi = u[..., 0] * (2.0 * math.pi)
    z = u[..., 1] * 2.0 - 1.0
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_triangle_uv(u):
    """Uniform barycentric (u, v) on a triangle (SampleWarp::uniformTriangleUv)."""
    u1 = torch.sqrt(u[..., 0])
    return torch.stack([1.0 - u1, u[..., 1] * u1], dim=-1)


def power_heuristic(pdf0, pdf1):
    """Veach power heuristic with beta=2 (SampleWarp.hpp:189)."""
    p0 = pdf0 * pdf0
    p1 = pdf1 * pdf1
    return p0 / torch.clamp(p0 + p1, min=1e-38)


def uniform_disk(u):
    phi = u[..., 0] * (2.0 * math.pi)
    r = torch.sqrt(u[..., 1])
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def tent_filter_sample(u):
    """Analytic inverse-CDF sample of the tent filter on [-1, 1]."""
    return torch.where(
        u < 0.5, torch.sqrt(2.0 * u) - 1.0,
        1.0 - torch.sqrt(torch.clamp(2.0 - 2.0 * u, min=0.0)))


def gaussian_filter_sample(u0, u1, width=2.0, alpha=2.0):
    """Box-Muller sample of the gaussian filter."""
    r = torch.sqrt(-torch.log(torch.clamp(
        1.0 - u0 * (1.0 - math.exp(-alpha * width * width)), min=1e-7)) / alpha)
    phi = 2.0 * math.pi * u1
    return r * torch.cos(phi), r * torch.sin(phi)


# ---- inverse warps (RJ-MLT path inversion, SampleWarp.hpp:17-146) ---------
# Each invert_* is a right inverse of its forward warp: forward(invert(w))
# gives w back up to rounding. `mu` is the free uniform of a degenerate
# (measure-zero) input, as the reference's untracked1D().

def invert_phi(w, mu=0.5):
    """The azimuth of w as a [0, 1) uniform (SampleWarp::invertPhi)."""
    degen = (w[..., 0] == 0.0) & (w[..., 1] == 0.0)
    res = torch.where(degen, mu * INV_TWO_PI * (2.0 * math.pi),
                      torch.atan2(w[..., 1], w[..., 0]) * INV_TWO_PI)
    return torch.where(res < 0.0, res + 1.0, res)


def invert_cosine_hemisphere(w, mu=0.5):
    return torch.stack([invert_phi(w, mu), torch.clamp(1.0 - w[..., 2] * w[..., 2], min=0.0)],
                       dim=-1)


def invert_uniform_hemisphere(w, mu=0.5):
    return torch.stack([invert_phi(w, mu), w[..., 2]], dim=-1)


def invert_uniform_sphere(w, mu=0.5):
    return torch.stack([invert_phi(w, mu), (w[..., 2] + 1.0) * 0.5], dim=-1)


def invert_uniform_disk(p, mu=0.5):
    return torch.stack([invert_phi(p, mu), p[..., 0] ** 2 + p[..., 1] ** 2], dim=-1)


def invert_uniform_spherical_cap(w, cos_theta_max, mu=0.5):
    """(u2, ok): ok is False where w lies outside the cap."""
    y = (w[..., 2] - cos_theta_max) / torch.clamp(
        torch.as_tensor(1.0 - cos_theta_max, dtype=torch.float32), min=1e-20)
    ok = (y >= 0.0) & (y < 1.0)
    return torch.stack([invert_phi(w, mu), torch.clamp(y, 0.0, 1.0)], dim=-1), ok


def invert_uniform_triangle_uv(bary):
    """The inverse of uniform_triangle_uv: barycentric (a, b) -> u2."""
    u1 = 1.0 - bary[..., 0]
    ub = bary[..., 1] / torch.clamp(u1, min=1e-20)
    return torch.stack([u1 * u1, torch.clamp(ub, 0.0, 1.0)], dim=-1)
