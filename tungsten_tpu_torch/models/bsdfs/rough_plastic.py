"""Rough plastic (RoughPlasticBsdf.cpp): a rough dielectric coat
(reflection only) over an internally scattering diffuse base, the two lobes
combined by one-sample MIS, on torch tensors.

Port of tungsten_tpu/models/bsdfs/rough_plastic.py. Params: [0] ior, [1:4]
scaledSigmaA, [4] avgTransmittance, [5] diffuseFresnel, [6] roughness (a
scalar or a texture: common.pack_roughness), [7] distribution, [8]
substrateWeight (the albedo's average).
"""
from __future__ import annotations

import numpy as np
import torch

from ...sampling import warps
from . import microfacet as mf
from . import rough_dielectric as rd
from .common import BsdfSample, Lobes, pack_roughness, resolve_roughness
from .fresnel import dielectric_reflectance
from .plastic import compute_diffuse_fresnel, diffuse_f, pack_coat_common

NAME = "rough_plastic"
LOBES = Lobes.GLOSSY_R | Lobes.DIFFUSE_R


def pack(spec, params, tex_builder):
    params = pack_coat_common(spec, params)
    params[5] = compute_diffuse_fresnel(float(params[0]))
    params[6] = pack_roughness(spec, "roughness", 0.1, tex_builder)
    params[7] = mf.dist_id(spec.get("distribution", "ggx"))
    a = spec.get("albedo", 1.0)
    if isinstance(a, (int, float)):
        params[8] = a
    elif isinstance(a, (list, tuple)):
        params[8] = float(np.mean(a))
    else:
        params[8] = 0.5  # a textured albedo: the reference uses Texture::average
    return params


def _spec_prob(params, wi):
    fi, _ = dielectric_reflectance(1.0 / params[..., 0], wi[..., 2])
    substrate = params[..., 8] * params[..., 4] * (1.0 - fi)
    return fi / torch.clamp(fi + substrate, min=1e-20)


def _coat(ctx, params, uv, wi):
    """(roughness, ior, distribution, reflection-only masks) of the coat."""
    yes = torch.ones(wi.shape[:-1], dtype=torch.bool, device=wi.device)
    return (resolve_roughness(ctx, params[..., 6], uv), params[..., 0],
            params[..., 7].to(torch.int64), yes, ~yes)


def eval(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    glossy = rd.eval_base(wi, wo, *_coat(ctx, params, uv, wi))
    valid = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    out = diffuse_f(params, albedo, wi, wo) + glossy[..., None]
    return torch.where(valid[..., None], out, 0.0)


def pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    glossy_pdf = rd.pdf_base(wi, wo, *_coat(ctx, params, uv, wi))
    sp = _spec_prob(params, wi)
    p = glossy_pdf * sp + warps.cosine_hemisphere_pdf(wo) * (1.0 - sp)
    valid = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return torch.where(valid, p, 0.0)


def sample(ctx, params, albedo, uv, wi, u2, u1, nonspecular_only=False):
    sp = _spec_prob(params, wi)
    pick_spec = u1 < sp
    u1_re = torch.clamp((u1 - sp) / torch.clamp(1.0 - sp, min=1e-7), 0.0, 1.0)
    rough, ior, dist, yes, no = _coat(ctx, params, uv, wi)
    s_gl = rd.sample_base(wi, u2, u1_re, rough, ior, dist, yes, no)
    wo = torch.where(pick_spec[..., None], s_gl.wo, warps.cosine_hemisphere(u2))

    # one-sample MIS of the two lobes (RoughPlasticBsdf::sample)
    f = eval(ctx, params, albedo, uv, wi, wo)
    p = pdf(ctx, params, albedo, uv, wi, wo)
    valid = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0) & (p > 0.0)
    valid = valid & torch.where(pick_spec, s_gl.valid, True)
    lobe = torch.where(pick_spec, Lobes.GLOSSY_R, Lobes.DIFFUSE_R)
    return BsdfSample(
        wo=wo,
        weight=torch.where(valid[..., None], f / torch.clamp(p, min=1e-30)[..., None], 0.0),
        pdf=p, lobe=lobe, valid=valid)
