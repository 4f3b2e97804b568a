"""Rough conductor (RoughConductorBsdf.cpp): microfacet reflection with
complex-IOR Fresnel, on torch tensors.

Port of tungsten_tpu/models/bsdfs/rough_conductor.py. Params: [0:3] eta rgb,
[3:6] k rgb, [6] roughness (a scalar or a texture: common.pack_roughness),
[7] distribution id.
"""
from __future__ import annotations

import numpy as np
import torch

from ...math import vecops as vo
from . import microfacet as mf
from .common import BsdfSample, Lobes, pack_roughness, resolve_roughness
from .complex_ior import lookup
from .fresnel import conductor_reflectance

NAME = "rough_conductor"
LOBES = Lobes.GLOSSY_R


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
    params[6] = pack_roughness(spec, "roughness", 0.1, tex_builder)
    params[7] = mf.dist_id(spec.get("distribution", "ggx"))
    return params


def _unpack(params):
    return params[..., 0:3], params[..., 3:6], params[..., 6], params[..., 7].to(torch.int64)


def eval(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    eta, k, rough, dist = _unpack(params)
    rough = resolve_roughness(ctx, rough, uv)
    alpha = mf.roughness_to_alpha(dist, rough)
    hr = vo.normalize(wi + wo, eps=1e-12)
    cos_m = vo.dot(wi, hr)
    f = conductor_reflectance(eta, k, cos_m)
    g = mf.G(dist, alpha, wi, wo, hr)
    d = mf.D(dist, alpha, hr)
    fr = g * d * 0.25 / torch.clamp(wi[..., 2], min=1e-20)
    valid = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return torch.where(valid[..., None], albedo * f * fr[..., None], 0.0)


def pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    _, _, rough, dist = _unpack(params)
    rough = resolve_roughness(ctx, rough, uv)
    alpha = mf.roughness_to_alpha(dist, rough)
    hr = vo.normalize(wi + wo, eps=1e-12)
    p = mf.pdf(dist, alpha, hr) * 0.25 / torch.clamp(torch.abs(vo.dot(wi, hr)), min=1e-20)
    valid = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return torch.where(valid, p, 0.0)


def sample(ctx, params, albedo, uv, wi, u2, u1, nonspecular_only=False):
    eta, k, rough, dist = _unpack(params)
    rough = resolve_roughness(ctx, rough, uv)
    alpha = mf.roughness_to_alpha(dist, rough)
    m = mf.sample(dist, alpha, u2)
    wi_dot_m = vo.dot(wi, m)
    wo = 2.0 * wi_dot_m[..., None] * m - wi
    valid = (wi[..., 2] > 0.0) & (wi_dot_m > 0.0) & (wo[..., 2] > 0.0)
    g = mf.G(dist, alpha, wi, wo, m)
    d = mf.D(dist, alpha, m)
    m_pdf = mf.pdf(dist, alpha, m)
    p = m_pdf * 0.25 / torch.clamp(wi_dot_m, min=1e-20)
    weight_s = wi_dot_m * g * d / torch.clamp(wi[..., 2] * m_pdf, min=1e-20)
    f = conductor_reflectance(eta, k, wi_dot_m)
    return BsdfSample(
        wo=wo,
        weight=torch.where(valid[..., None], albedo * f * weight_s[..., None], 0.0),
        pdf=p,
        lobe=torch.full(wi.shape[:-1], Lobes.GLOSSY_R, dtype=torch.int64, device=wi.device),
        valid=valid,
    )
