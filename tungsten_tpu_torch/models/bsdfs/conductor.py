"""Smooth conductor (ConductorBsdf.cpp): dirac specular reflection with
complex-IOR Fresnel, on torch tensors.

Port of tungsten_tpu/models/bsdfs/conductor.py. Params: [0:3] eta, [3:6] k.
"""
from __future__ import annotations

import numpy as np
import torch

from ...math import vecops as vo
from .common import BsdfSample, Lobes
from .complex_ior import lookup
from .fresnel import conductor_reflectance

NAME = "conductor"
LOBES = Lobes.SPECULAR_R


def pack(spec, params, tex_builder):
    eta = spec.get("eta")
    k = spec.get("k")
    if eta is None or k is None:
        mat = lookup(spec.get("material", "Cu"))
        if mat is None:
            raise ValueError(f"unknown conductor material {spec.get('material')!r}")
        eta, k = mat
    params[0:3] = np.asarray(eta, np.float32)
    params[3:6] = np.asarray(k, np.float32)
    return params


def eval(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    return torch.zeros(wi.shape[:-1] + (3,), dtype=torch.float32, device=wi.device)


def pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    return torch.zeros(wi.shape[:-1], dtype=torch.float32, device=wi.device)


def sample(ctx, params, albedo, uv, wi, u2, u1, nonspecular_only=False):
    if nonspecular_only:
        return BsdfSample.invalid(wi.shape[0], wi.device)
    f = conductor_reflectance(params[..., 0:3], params[..., 3:6], wi[..., 2])
    shape = wi.shape[:-1]
    return BsdfSample(
        wo=vo.reflect(wi),
        weight=albedo * f,
        pdf=torch.ones(shape, dtype=torch.float32, device=wi.device),
        lobe=torch.full(shape, Lobes.SPECULAR_R, dtype=torch.int64, device=wi.device),
        valid=torch.ones(shape, dtype=torch.bool, device=wi.device),
    )
