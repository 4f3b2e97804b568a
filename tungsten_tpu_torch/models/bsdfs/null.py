"""Null BSDF (NullBsdf.cpp): absorbs everything, on torch tensors. Light
fixtures use it, so a path ends once it has collected the emission.

Port of tungsten_tpu/models/bsdfs/null.py: no lobes, so NEE skips it, and
every sample is invalid.
"""
from __future__ import annotations

import torch

from .common import BsdfSample, Lobes

NAME = "null"
LOBES = Lobes.NULL


def pack(spec, params, tex_builder):
    return params


def eval(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    return torch.zeros(wi.shape[:-1] + (3,), dtype=torch.float32, device=wi.device)


def pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    return torch.zeros(wi.shape[:-1], dtype=torch.float32, device=wi.device)


def sample(ctx, params, albedo, uv, wi, u2, u1, nonspecular_only=False):
    return BsdfSample.invalid(wi.shape[0], wi.device)
