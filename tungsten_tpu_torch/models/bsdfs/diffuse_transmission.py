"""Diffuse transmission (DiffuseTransmissionBsdf.cpp) on torch tensors: two
cosine lobes, one on each side, split by a transmittance ratio.

Port of tungsten_tpu/models/bsdfs/diffuse_transmission.py. Params: [0]
transmittance.
"""
from __future__ import annotations

import torch

from ...sampling import warps
from .common import BsdfSample, Lobes

NAME = "diffuse_transmission"
LOBES = Lobes.DIFFUSE_R | Lobes.DIFFUSE_T


def pack(spec, params, tex_builder):
    params[0] = spec.get("transmittance", 0.5)
    return params


def _factor(params, wi, wo):
    tr = params[..., 0]
    return torch.where(wi[..., 2] * wo[..., 2] < 0.0, tr, 1.0 - tr)


def eval(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    return albedo * (_factor(params, wi, wo) * warps.INV_PI * torch.abs(wo[..., 2]))[..., None]


def pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    return _factor(params, wi, wo) * warps.INV_PI * torch.abs(wo[..., 2])


def sample(ctx, params, albedo, uv, wi, u2, u1, nonspecular_only=False):
    tr = params[..., 0]
    transmit = u1 < tr
    wo = warps.cosine_hemisphere(u2)
    woz = torch.abs(wo[..., 2]) * torch.sign(wi[..., 2]) * torch.where(transmit, -1.0, 1.0)
    wo = torch.cat([wo[..., :2], woz[..., None]], dim=-1)
    return BsdfSample(
        wo=wo, weight=albedo,
        pdf=warps.INV_PI * torch.abs(woz) * torch.where(transmit, tr, 1.0 - tr),
        lobe=torch.where(transmit, Lobes.DIFFUSE_T, Lobes.DIFFUSE_R),
        valid=torch.ones(wi.shape[:-1], dtype=torch.bool, device=wi.device))
