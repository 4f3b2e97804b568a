"""Smooth dielectric coat over any non-wrapper substrate BSDF
(SmoothCoatBsdf.cpp) on torch tensors: a specular reflection lottery
against refraction into the substrate with Snell-warped directions,
absorption, and the refraction Jacobian eta^2 cos(theta_t) / cos(theta_sub).

Port of tungsten_tpu/models/bsdfs/smooth_coat.py. Params: [0] ior, [1:4]
scaledSigmaA, [4] avgTransmittance, [5] substrate material index.
"""
from __future__ import annotations

import torch

from ...math import vecops as vo
from .common import BsdfSample, Lobes
from .fresnel import dielectric_reflectance
from .plastic import pack_coat_common

NAME = "smooth_coat"
IS_WRAPPER = True


def lobes_for(spec, sub_lobes_of):
    return Lobes.SPECULAR_R | sub_lobes_of(spec["_substrate_index"])


def pack(spec, params, tex_builder):
    params = pack_coat_common(spec, params, default_ior=1.3)
    params[5] = spec.get("_substrate_index", -1)
    if params[5] < 0:
        raise ValueError("smooth_coat requires a substrate")
    return params


def setup(params, wi):
    """(ior, eta, F(wi), cos(theta_t) of wi, P(specular), substrate id)."""
    ior = params[..., 0]
    eta = 1.0 / ior
    fi, cos_ti = dielectric_reflectance(eta, wi[..., 2])
    substrate_w = params[..., 4] * (1.0 - fi)
    spec_prob = fi / torch.clamp(fi + substrate_w, min=1e-20)
    return ior, eta, fi, cos_ti, spec_prob, params[..., 5].to(torch.int64)


def warp_in(wi, eta, cos_ti):
    """A direction above the coat -> its refracted direction under it."""
    return torch.stack([wi[..., 0] * eta, wi[..., 1] * eta, torch.sign(wi[..., 2]) * cos_ti],
                       dim=-1)


def absorption(params, cos_sub_o, cos_ti):
    sig = params[..., 1:4]
    att = torch.exp(sig * (-1.0 / torch.clamp(cos_sub_o, min=1e-6)
                           - 1.0 / torch.clamp(cos_ti, min=1e-6))[..., None])
    return torch.where(torch.any(sig > 0, dim=-1, keepdim=True), att, 1.0)


def substrate_eval(ctx, params, uv, wi, wo, nonspecular_only):
    """The substrate's f*cos seen through the coat, and the warped pair."""
    from .dispatch import nested_eval

    _, eta, fi, cos_ti, _, sub_id = setup(params, wi)
    fo, cos_to = dielectric_reflectance(eta, wo[..., 2])
    wi_sub = warp_in(wi, eta, cos_ti)
    wo_sub = warp_in(wo, eta, cos_to)
    laplacian = eta * eta * wo[..., 2] / torch.clamp(cos_to, min=1e-6)
    f_sub = nested_eval(ctx, sub_id, uv, wi_sub, wo_sub, nonspecular_only)
    f_sub = f_sub * absorption(params, cos_to, cos_ti)
    return (laplacian * (1.0 - fi) * (1.0 - fo))[..., None] * f_sub, wi_sub, wo_sub, cos_to


def eval(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    f, _, _, _ = substrate_eval(ctx, params, uv, wi, wo, nonspecular_only)
    valid = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return torch.where(valid[..., None], f, 0.0)


def pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    from .dispatch import nested_pdf

    _, eta, _, cos_ti, spec_prob, sub_id = setup(params, wi)
    _, cos_to = dielectric_reflectance(eta, wo[..., 2])
    p_sub = nested_pdf(ctx, sub_id, uv, warp_in(wi, eta, cos_ti), warp_in(wo, eta, cos_to),
                       nonspecular_only)
    p = p_sub * (eta * eta * torch.abs(wo[..., 2] / torch.clamp(cos_to, min=1e-6)))
    if not nonspecular_only:
        p = p * (1.0 - spec_prob)
    valid = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return torch.where(valid, p, 0.0)


def sample(ctx, params, albedo, uv, wi, u2, u1, nonspecular_only=False):
    from .dispatch import nested_sample

    ior, eta, fi, cos_ti, spec_prob, sub_id = setup(params, wi)
    if nonspecular_only:
        spec_prob = torch.zeros_like(spec_prob)
    pick_spec = u1 < spec_prob
    u1_re = torch.clamp((u1 - spec_prob) / torch.clamp(1.0 - spec_prob, min=1e-7),
                        0.0, 1.0 - 1e-7)

    # substrate branch: refract in, sample the substrate, refract out
    s = nested_sample(ctx, sub_id, uv, warp_in(wi, eta, cos_ti), u2, u1_re, nonspecular_only)
    fo, cos_to = dielectric_reflectance(ior, s.wo[..., 2])
    cos_sub = s.wo[..., 2]
    wo_sub_out = torch.stack([s.wo[..., 0] * ior, s.wo[..., 1] * ior, cos_to], dim=-1)
    w_sub = s.weight * ((1.0 - fi) * (1.0 - fo))[..., None]
    w_sub = w_sub * absorption(params, cos_sub, cos_ti)
    w_sub = w_sub / torch.clamp(1.0 - spec_prob, min=1e-7)[..., None]
    p_sub = s.pdf * (1.0 - spec_prob) * eta * eta * cos_to / torch.clamp(cos_sub, min=1e-6)
    valid_sub = s.valid & (fo < 1.0) & (cos_sub > 0.0)

    w_spec = (fi / torch.clamp(spec_prob, min=1e-20))[..., None].expand(*fi.shape, 3)
    wo = torch.where(pick_spec[..., None], vo.reflect(wi), wo_sub_out)
    w = torch.where(pick_spec[..., None], w_spec, w_sub)
    p = torch.where(pick_spec, spec_prob, p_sub)
    lobe = torch.where(pick_spec, Lobes.SPECULAR_R, s.lobe)
    valid = (wi[..., 2] > 0.0) & torch.where(pick_spec, True, valid_sub)
    return BsdfSample(wo=wo, weight=torch.where(valid[..., None], w, 0.0), pdf=p, lobe=lobe,
                      valid=valid)
