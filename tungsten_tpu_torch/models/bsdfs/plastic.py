"""Smooth plastic (PlasticBsdf.cpp): a dirac specular coat over an
internally scattering diffuse base with absorption, on torch tensors.

Port of tungsten_tpu/models/bsdfs/plastic.py. Params: [0] ior, [1:4]
scaledSigmaA, [4] avgTransmittance, [5] diffuseFresnel
(compute_diffuse_fresnel, a numpy sum at pack time).
"""
from __future__ import annotations

import numpy as np
import torch

from ...math import vecops as vo
from ...sampling import warps
from .common import BsdfSample, Lobes
from .fresnel import dielectric_reflectance

NAME = "plastic"
LOBES = Lobes.SPECULAR_R | Lobes.DIFFUSE_R


def compute_diffuse_fresnel(ior: float, samples: int = 100000) -> float:
    """Fresnel::computeDiffuseFresnel (Fresnel.hpp:141): trapezoid integral of
    the dielectric reflectance over the projected hemisphere."""
    i = np.arange(1, samples + 1)
    cos_sq = i / samples
    cos_i = np.minimum(np.sqrt(cos_sq), 1.0)
    eta = ior
    sin_t_sq = eta * eta * (1.0 - cos_i * cos_i)
    cos_t = np.sqrt(np.maximum(1.0 - sin_t_sq, 0.0))
    rs = (eta * cos_i - cos_t) / np.maximum(eta * cos_i + cos_t, 1e-20)
    rp = (eta * cos_t - cos_i) / np.maximum(eta * cos_t + cos_i, 1e-20)
    fa = np.where(sin_t_sq > 1.0, 1.0, 0.5 * (rs * rs + rp * rp))
    fb = np.concatenate([[1.0 if eta > 1.0 else _f_scalar(eta, 0.0)], fa[:-1]])
    return float(np.sum((fa + fb) * (0.5 / samples)))


def _f_scalar(eta, cos_i):
    sin_t_sq = eta * eta * (1.0 - cos_i * cos_i)
    if sin_t_sq > 1.0:
        return 1.0
    cos_t = np.sqrt(max(1.0 - sin_t_sq, 0.0))
    rs = (eta * cos_i - cos_t) / max(eta * cos_i + cos_t, 1e-20)
    rp = (eta * cos_t - cos_i) / max(eta * cos_t + cos_i, 1e-20)
    return 0.5 * (rs * rs + rp * rp)


def pack_coat_common(spec, params, default_ior=1.5):
    params[0] = spec.get("ior", default_ior)
    sa = np.asarray(spec.get("sigma_a", 0.0), np.float64).ravel()
    sa = np.repeat(sa, 3) if sa.size == 1 else sa
    scaled = spec.get("thickness", 1.0) * sa
    params[1:4] = scaled
    params[4] = np.exp(-2.0 * scaled.mean())
    return params


def pack(spec, params, tex_builder):
    params = pack_coat_common(spec, params)
    params[5] = compute_diffuse_fresnel(float(params[0]))
    return params


def diffuse_f(params, albedo, wi, wo):
    """The inner diffuse term with both Fresnel factors, absorption, eta^2
    and the multiple-scattering compensation. Returns f*cos."""
    eta = 1.0 / params[..., 0]
    fi, _ = dielectric_reflectance(eta, wi[..., 2])
    fo, _ = dielectric_reflectance(eta, wo[..., 2])
    dfres = params[..., 5:6]
    brdf = ((1.0 - fi) * (1.0 - fo) * eta * eta * wo[..., 2] * warps.INV_PI)[..., None] * (
        albedo / (1.0 - albedo * dfres))
    sig = params[..., 1:4]
    att = torch.exp(sig * (-1.0 / torch.clamp(wo[..., 2:3], min=1e-6)
                           - 1.0 / torch.clamp(wi[..., 2:3], min=1e-6)))
    return torch.where(torch.any(sig > 0, dim=-1, keepdim=True), brdf * att, brdf)


def _spec_prob(params, wi, sample_r, sample_t):
    fi, _ = dielectric_reflectance(1.0 / params[..., 0], wi[..., 2])
    substrate = params[..., 4] * (1.0 - fi)
    p = fi / torch.clamp(fi + substrate, min=1e-20)
    return torch.where(sample_r & sample_t, p, torch.where(sample_r, 1.0, 0.0)), fi


def eval(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    valid = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return torch.where(valid[..., None], diffuse_f(params, albedo, wi, wo), 0.0)


def pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    valid = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    p = warps.cosine_hemisphere_pdf(wo)
    if not nonspecular_only:  # the diffuse lobe is picked with 1 - P(specular)
        yes = torch.ones(wi.shape[:-1], dtype=torch.bool, device=wi.device)
        sp, _ = _spec_prob(params, wi, yes, yes)
        p = p * (1.0 - sp)
    return torch.where(valid, p, 0.0)


def sample(ctx, params, albedo, uv, wi, u2, u1, nonspecular_only=False):
    shape = wi.shape[:-1]
    sample_r = torch.full(shape, not nonspecular_only, dtype=torch.bool, device=wi.device)
    sample_t = torch.ones(shape, dtype=torch.bool, device=wi.device)
    sp, fi = _spec_prob(params, wi, sample_r, sample_t)
    pick_spec = sample_r & (u1 < sp)

    wo_spec = vo.reflect(wi)
    w_spec = (fi / torch.clamp(sp, min=1e-20))[..., None].expand(*shape, 3)

    wo_diff = warps.cosine_hemisphere(u2)
    w_diff = diffuse_f(params, albedo, wi, wo_diff) / torch.clamp(
        warps.cosine_hemisphere_pdf(wo_diff), min=1e-20)[..., None]
    w_diff = w_diff / torch.clamp(1.0 - sp, min=1e-20)[..., None]

    wo = torch.where(pick_spec[..., None], wo_spec, wo_diff)
    w = torch.where(pick_spec[..., None], w_spec, w_diff)
    p = torch.where(pick_spec, sp, warps.cosine_hemisphere_pdf(wo) * (1.0 - sp))
    lobe = torch.where(pick_spec, Lobes.SPECULAR_R, Lobes.DIFFUSE_R)
    valid = wi[..., 2] > 0.0
    return BsdfSample(wo=wo, weight=torch.where(valid[..., None], w, 0.0), pdf=p, lobe=lobe,
                      valid=valid)
