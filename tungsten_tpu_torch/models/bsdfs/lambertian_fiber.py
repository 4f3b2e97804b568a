"""Lambertian fiber BCSDF (src/core/bsdfs/LambertianFiberBcsdf.cpp), torch.

Port of tungsten_tpu/models/bsdfs/lambertian_fiber.py: the closed-form
far-field scattering of a perfectly Lambertian cylinder ("Light Scattering
from Filaments"; exact solution from "Importance Sampling for
Physically-Based Hair Fiber Models"):

    N(phi) = cosThetaO * |((pi - phi) cos phi + sin phi)| / (4 pi)

Frame convention as hair.py: the fiber tangent is the local y axis
(sin(theta) = dir.y) and phi, measured in the (x, z) normal plane, is the
azimuthal DIFFERENCE between wo and wi (the reference's ribbon frame puts
wi's azimuth at ~0, LambertianFiberBcsdf.cpp:21-28).
"""
from __future__ import annotations

import numpy as np
import torch

from ...sampling import warps
from .common import BsdfSample, Lobes
from .hair import _mod_2pi, _trig_inv

NAME = "lambertian_fiber"
LOBES = Lobes.DIFFUSE_R | Lobes.ANISOTROPIC

INV_FOUR_PI = 1.0 / (4.0 * np.pi)


def pack(spec, params, tex_builder):
    return params  # albedo only


def _lambertian_cylinder(wi, wo):
    """N(dphi) * cosThetaO (LambertianFiberBcsdf.cpp:20-28) with phi taken
    as the wo-wi azimuth difference wrapped to [0, 2pi)."""
    cos_to = _trig_inv(torch.clamp(wo[..., 1], -1.0, 1.0))
    phi = _mod_2pi(torch.atan2(wo[..., 0], wo[..., 2]) - torch.atan2(wi[..., 0], wi[..., 2]))
    n = cos_to * torch.abs(((np.pi - phi) * torch.cos(phi) + torch.sin(phi)) * INV_FOUR_PI)
    return torch.where(torch.isfinite(n), n, 0.0)


def eval(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):  # noqa: A001
    return albedo * _lambertian_cylinder(wi, wo)[..., None]


def pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    return _lambertian_cylinder(wi, wo)


def _rotate_by_azimuth(wo0, wi):
    """wo0 from the frame where wi's azimuth is 0 into the shading frame."""
    phi_i = torch.atan2(wi[..., 0], wi[..., 2])
    c, s = torch.cos(phi_i), torch.sin(phi_i)
    return torch.stack([wo0[..., 0] * c + wo0[..., 2] * s, wo0[..., 1],
                        -wo0[..., 0] * s + wo0[..., 2] * c], dim=-1)


def sample(ctx, params, albedo, uv, wi, u2, u1, nonspecular_only=False):
    """Exact importance sampling (LambertianFiberBcsdf.cpp:43-61): pick a
    point across the lit fiber width (h uniform), cosine-sample about that
    surface normal, then rotate the result from the wi-azimuth frame into
    the shading frame."""
    n = wi.shape[0]
    nx = u1 * 2.0 - 1.0
    nz = _trig_inv(nx)
    d = warps.cosine_hemisphere(u2)
    # reference frame (wi azimuth = 0): x' across the fiber, z' toward wi
    wo0 = torch.stack([d[..., 2] * nx + d[..., 0] * nz, d[..., 1],
                       d[..., 2] * nz - d[..., 0] * nx], dim=-1)
    wo = _rotate_by_azimuth(wo0, wi)
    p = _lambertian_cylinder(wi, wo)
    valid = p > 0.0
    return BsdfSample(
        wo=wo,
        weight=torch.where(valid[..., None], albedo, 0.0),
        pdf=p,
        lobe=torch.full((n,), LOBES, dtype=torch.int64, device=wi.device),
        valid=valid,
    )
