"""Microfacet distributions: Beckmann / Phong / GGX on torch tensors.

Port of tungsten_tpu/models/bsdfs/microfacet.py (Microfacet.hpp:14-157):
the distribution id is a per-lane parameter, dispatched with masks.
"""
from __future__ import annotations

import math

import torch

from ...sampling import warps

BECKMANN = 0
PHONG = 1
GGX = 2

_NAMES = {"beckmann": BECKMANN, "phong": PHONG, "ggx": GGX}


def dist_id(name: str) -> int:
    return _NAMES[name]


def roughness_to_alpha(dist, roughness):
    r = torch.clamp(roughness, min=1e-3)
    return torch.where(dist == PHONG, 2.0 / (r * r) - 2.0, r)


def D(dist, alpha, m):
    mz = m[..., 2]
    cos_sq = mz * mz
    tan_sq = torch.clamp(1.0 - cos_sq, min=0.0) / torch.clamp(cos_sq, min=1e-20)
    cos_qu = torch.clamp(cos_sq * cos_sq, min=1e-20)
    a_sq = alpha * alpha

    beckmann = warps.INV_PI * torch.exp(-tan_sq / torch.clamp(a_sq, min=1e-20)) / torch.clamp(
        a_sq * cos_qu, min=1e-20)
    phong = (alpha + 2.0) * warps.INV_TWO_PI * torch.pow(torch.clamp(mz, min=1e-20), alpha)
    ggx = a_sq * warps.INV_PI / torch.clamp(cos_qu * (a_sq + tan_sq) ** 2, min=1e-20)

    d = torch.where(dist == BECKMANN, beckmann, torch.where(dist == PHONG, phong, ggx))
    return torch.where(mz > 0.0, d, 0.0)


def G1(dist, alpha, v, m):
    vz = v[..., 2]
    cos_sq = vz * vz
    tan_theta = torch.abs(torch.sqrt(torch.clamp(1.0 - cos_sq, min=0.0))
                          / torch.where(vz == 0, 1e-20, vz))
    tan_theta = torch.clamp(tan_theta, min=1e-20)

    a_beck = 1.0 / (torch.clamp(alpha, min=1e-20) * tan_theta)
    a_phong = torch.sqrt(torch.clamp(0.5 * alpha + 1.0, min=0.0)) / tan_theta
    a = torch.where(dist == PHONG, a_phong, a_beck)
    rational = (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a)
    smith_approx = torch.where(a < 1.6, rational, 1.0)

    a_sq = alpha * alpha
    tan_sq = torch.clamp(1.0 - cos_sq, min=0.0) / torch.clamp(cos_sq, min=1e-20)
    ggx = 2.0 / (1.0 + torch.sqrt(1.0 + a_sq * tan_sq))

    g = torch.where(dist == GGX, ggx, smith_approx)
    side = torch.sum(v * m, dim=-1) * vz > 0.0
    return torch.where(side, g, 0.0)


def G(dist, alpha, wi, wo, m):
    return G1(dist, alpha, wi, m) * G1(dist, alpha, wo, m)


def pdf(dist, alpha, m):
    return D(dist, alpha, m) * torch.clamp(m[..., 2], min=0.0)


def sample(dist, alpha, xi):
    """xi (..., 2) -> microfacet normal m (..., 3)."""
    phi = xi[..., 1] * (2.0 * math.pi)
    x0 = torch.clamp(xi[..., 0], 0.0, 1.0 - 1e-7)

    tan_sq_beck = -alpha * alpha * torch.log1p(-x0)
    cos_beck = 1.0 / torch.sqrt(1.0 + tan_sq_beck)
    cos_phong = torch.pow(x0, 1.0 / (alpha + 2.0))
    tan_sq_ggx = alpha * alpha * x0 / (1.0 - x0)
    cos_ggx = 1.0 / torch.sqrt(1.0 + tan_sq_ggx)

    cos_theta = torch.where(
        dist == BECKMANN, cos_beck, torch.where(dist == PHONG, cos_phong, cos_ggx))
    r = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    return torch.stack([torch.cos(phi) * r, torch.sin(phi) * r, cos_theta], dim=-1)
