"""Lambertian reflection (LambertBsdf.cpp) on torch tensors.

Port of tungsten_tpu/models/bsdfs/lambert.py.
"""
from __future__ import annotations

import torch

from ...sampling import warps
from .common import BsdfSample, Lobes

NAME = "lambert"
LOBES = Lobes.DIFFUSE_R


def pack(spec, params, tex_builder):
    return params  # no extra parameters


def eval(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    valid = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    f = albedo * (warps.INV_PI * torch.clamp(wo[..., 2], min=0.0))[..., None]
    return torch.where(valid[..., None], f, 0.0)


def pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    valid = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return torch.where(valid, warps.cosine_hemisphere_pdf(wo), 0.0)


def sample(ctx, params, albedo, uv, wi, u2, u1, nonspecular_only=False):
    wo = warps.cosine_hemisphere(u2)
    valid = wi[..., 2] > 0.0
    return BsdfSample(
        wo=wo,
        weight=torch.where(valid[..., None], albedo, 0.0),
        pdf=warps.cosine_hemisphere_pdf(wo),
        lobe=torch.full(wi.shape[:-1], Lobes.DIFFUSE_R, dtype=torch.int64, device=wi.device),
        valid=valid,
    )
