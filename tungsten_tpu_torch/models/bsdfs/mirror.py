"""Perfect mirror (MirrorBsdf.cpp): dirac specular reflection, on torch
tensors.

Port of tungsten_tpu/models/bsdfs/mirror.py: eval() and pdf() return 0 (a
dirac lobe takes no part in MIS); sample() reports pdf = 1 as a discrete
probability with weight = albedo.
"""
from __future__ import annotations

import torch

from ...math import vecops as vo
from .common import BsdfSample, Lobes

NAME = "mirror"
LOBES = Lobes.SPECULAR_R


def pack(spec, params, tex_builder):
    return params


def eval(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    return torch.zeros(wi.shape[:-1] + (3,), dtype=torch.float32, device=wi.device)


def pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    return torch.zeros(wi.shape[:-1], dtype=torch.float32, device=wi.device)


def sample(ctx, params, albedo, uv, wi, u2, u1, nonspecular_only=False):
    if nonspecular_only:
        return BsdfSample.invalid(wi.shape[0], wi.device)
    valid = wi[..., 2] > 0.0
    shape = wi.shape[:-1]
    return BsdfSample(
        wo=vo.reflect(wi),
        weight=torch.where(valid[..., None], albedo, 0.0),
        pdf=torch.ones(shape, dtype=torch.float32, device=wi.device),
        lobe=torch.full(shape, Lobes.SPECULAR_R, dtype=torch.int64, device=wi.device),
        valid=valid,
    )
