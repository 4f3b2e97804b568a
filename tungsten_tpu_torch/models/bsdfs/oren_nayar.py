"""Oren-Nayar rough diffuse reflection (OrenNayarBsdf.cpp, the improved
Fujii model) on torch tensors; sampling mixes the uniform and the cosine
hemisphere by roughness.

Port of tungsten_tpu/models/bsdfs/oren_nayar.py. Params: [0] roughness
texture id (the reference's roughness is a Texture).
"""
from __future__ import annotations

import math

import torch

from ...sampling import warps
from .common import BsdfSample, Lobes

NAME = "oren_nayar"
LOBES = Lobes.DIFFUSE_R


def pack(spec, params, tex_builder):
    from ..textures.textures import texture_from_spec

    params[0] = texture_from_spec(spec.get("roughness", 0.5), tex_builder,
                                  spec.get("_resolve_path"))
    return params


def _rough(ctx, params, uv):
    from ..textures.textures import eval_texture

    return eval_texture(ctx[1], params[..., 0].to(torch.int64), uv)[..., 0]


def _f(rough, albedo, wi, wo):
    wiz = wi[..., 2]
    woz = wo[..., 2]
    theta_r = torch.arccos(torch.clamp(woz, -1.0, 1.0))
    theta_i = torch.arccos(torch.clamp(wiz, -1.0, 1.0))
    alpha = torch.maximum(theta_r, theta_i)
    beta = torch.minimum(theta_r, theta_i)
    sin_alpha = torch.sin(alpha)
    denom = (wi[..., 0] ** 2 + wi[..., 1] ** 2) * (wo[..., 0] ** 2 + wo[..., 1] ** 2)
    cos_dphi = torch.where(
        denom == 0.0, 1.0,
        (wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1])
        / torch.sqrt(torch.clamp(denom, min=1e-30)))
    sigma = rough / math.sqrt(2.0)
    s2 = sigma * sigma
    c1 = 1.0 - 0.5 * s2 / (s2 + 0.33)
    c2 = 0.45 * s2 / (s2 + 0.09)
    c2 = c2 * torch.where(cos_dphi >= 0.0, sin_alpha,
                          sin_alpha - ((2.0 * warps.INV_PI) * beta) ** 3)
    c3 = 0.125 * (s2 / (s2 + 0.09)) * ((4.0 * warps.INV_PI * warps.INV_PI) * alpha * beta) ** 2
    fr1 = (c1 + cos_dphi * c2 * torch.tan(beta)
           + (1.0 - torch.abs(cos_dphi)) * c3 * torch.tan(0.5 * (alpha + beta)))
    fr2 = 0.17 * s2 / (s2 + 0.13) * (1.0 - cos_dphi * ((2.0 * warps.INV_PI) * beta) ** 2)
    return (albedo * fr1[..., None] + albedo * albedo * fr2[..., None]) * (
        woz * warps.INV_PI)[..., None]


def _mix_pdf(wo, ratio):
    return (warps.uniform_hemisphere_pdf(wo) * ratio
            + warps.cosine_hemisphere_pdf(wo) * (1.0 - ratio))


def eval(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    valid = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return torch.where(valid[..., None], _f(_rough(ctx, params, uv), albedo, wi, wo), 0.0)


def pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    p = _mix_pdf(wo, torch.clamp(_rough(ctx, params, uv), 0.01, 1.0))
    valid = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return torch.where(valid, p, 0.0)


def sample(ctx, params, albedo, uv, wi, u2, u1, nonspecular_only=False):
    ratio = torch.clamp(_rough(ctx, params, uv), 0.01, 1.0)
    uniform = u1 < ratio
    wo = torch.where(uniform[..., None], warps.uniform_hemisphere(u2),
                     warps.cosine_hemisphere(u2))
    p = _mix_pdf(wo, ratio)
    valid = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0) & (p > 0.0)
    # the reference evaluates f at the clamped roughness here
    w = _f(ratio, albedo, wi, wo) / torch.clamp(p, min=1e-30)[..., None]
    return BsdfSample(
        wo=wo, weight=torch.where(valid[..., None], w, 0.0), pdf=p,
        lobe=torch.full(wi.shape[:-1], Lobes.DIFFUSE_R, dtype=torch.int64, device=wi.device),
        valid=valid)
