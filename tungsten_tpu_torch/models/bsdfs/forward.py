"""Forward BSDF (ForwardBsdf.cpp) on torch tensors: pure pass-through. It
takes part only through the tracer's transparency lottery (its forward
lobe); eval, pdf and sample are empty.

Port of tungsten_tpu/models/bsdfs/forward.py.
"""
from __future__ import annotations

import torch

from .common import BsdfSample, Lobes

NAME = "forward"
LOBES = Lobes.FORWARD


def pack(spec, params, tex_builder):
    return params


def eval(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    return torch.zeros(wi.shape[:-1] + (3,), dtype=torch.float32, device=wi.device)


def forward_transparency(ctx, params, albedo, uv, wi):
    """bsdf.eval(forwardEvent): all of it passes straight through."""
    return torch.ones(wi.shape[:-1] + (3,), dtype=torch.float32, device=wi.device)


def pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    return torch.zeros(wi.shape[:-1], dtype=torch.float32, device=wi.device)


def sample(ctx, params, albedo, uv, wi, u2, u1, nonspecular_only=False):
    return BsdfSample.invalid(wi.shape[0], wi.device)
