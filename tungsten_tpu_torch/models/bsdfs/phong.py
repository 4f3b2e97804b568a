"""Modified Phong (PhongBsdf.cpp) on torch tensors: a glossy lobe around the
mirror direction mixed with a diffuse one.

Port of tungsten_tpu/models/bsdfs/phong.py. Params: [0] exponent, [1]
diffuse_ratio.
"""
from __future__ import annotations

import math

import torch

from ...math import vecops as vo
from ...sampling import warps
from .common import BsdfSample, Lobes

NAME = "phong"
LOBES = Lobes.GLOSSY_R | Lobes.DIFFUSE_R


def pack(spec, params, tex_builder):
    params[0] = spec.get("exponent", 64.0)
    params[1] = spec.get("diffuse_ratio", 0.2)
    return params


def _glossy(params, wi, wo, norm):
    """(exponent + norm) / 2pi * cos^exponent of the angle to the mirror
    direction, 0 behind it; and the diffuse ratio."""
    exponent = params[..., 0]
    cos_theta = vo.dot(vo.reflect(wi), wo)
    g = torch.where(cos_theta > 0.0, torch.pow(torch.clamp(cos_theta, min=1e-20), exponent)
                    * ((exponent + norm) * warps.INV_TWO_PI), 0.0)
    return g, params[..., 1]


def eval(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    glossy, dr = _glossy(params, wi, wo, 2.0)
    result = dr * warps.INV_PI + glossy * (1.0 - dr)
    valid = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return torch.where(valid[..., None], albedo * (wo[..., 2] * result)[..., None], 0.0)


def pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    glossy, dr = _glossy(params, wi, wo, 1.0)
    p = glossy * (1.0 - dr) + dr * warps.cosine_hemisphere_pdf(wo)
    valid = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return torch.where(valid, p, 0.0)


def sample(ctx, params, albedo, uv, wi, u2, u1, nonspecular_only=False):
    exponent = params[..., 0]
    glossy_pick = u1 >= params[..., 1]  # nextBoolean(1 - diffuseRatio)

    phi = u2[..., 0] * (2.0 * math.pi)
    cos_t = torch.pow(torch.clamp(u2[..., 1], 1e-7, 1.0), 1.0 / (1.0 + exponent))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    wo_lobe = torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, cos_t], dim=-1)
    refl = vo.reflect(wi)
    t, b = vo.tangent_frame(refl)
    wo = torch.where(glossy_pick[..., None], vo.to_global(t, b, refl, wo_lobe),
                     warps.cosine_hemisphere(u2))

    p = pdf(ctx, params, albedo, uv, wi, wo)
    f = eval(ctx, params, albedo, uv, wi, wo)
    valid = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0) & (p > 0.0)
    return BsdfSample(
        wo=wo, weight=torch.where(valid[..., None], f / torch.clamp(p, min=1e-30)[..., None], 0.0),
        pdf=p, lobe=torch.where(glossy_pick, Lobes.GLOSSY_R, Lobes.DIFFUSE_R), valid=valid)
