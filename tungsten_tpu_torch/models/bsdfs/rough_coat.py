"""Rough dielectric coat over any non-wrapper substrate (RoughCoatBsdf.cpp)
on torch tensors: smooth_coat's refracted substrate beside a rough-dielectric
glossy reflection from the coat, joined by one-sample MIS.

Port of tungsten_tpu/models/bsdfs/rough_coat.py. Params: [0] ior, [1:4]
scaledSigmaA, [4] avgTransmittance, [5] substrate index, [6] roughness (a
scalar or a texture: common.pack_roughness), [7] distribution.
"""
from __future__ import annotations

import torch

from . import microfacet as mf
from . import rough_dielectric as rd
from .common import BsdfSample, Lobes, pack_roughness, resolve_roughness
from .fresnel import dielectric_reflectance
from .plastic import pack_coat_common
from .smooth_coat import setup, substrate_eval, warp_in

NAME = "rough_coat"
IS_WRAPPER = True


def lobes_for(spec, sub_lobes_of):
    return Lobes.GLOSSY_R | sub_lobes_of(spec["_substrate_index"])


def pack(spec, params, tex_builder):
    params = pack_coat_common(spec, params, default_ior=1.3)
    params[5] = spec.get("_substrate_index", -1)
    if params[5] < 0:
        raise ValueError("rough_coat requires a substrate")
    params[6] = pack_roughness(spec, "roughness", 0.1, tex_builder)
    params[7] = mf.dist_id(spec.get("distribution", "ggx"))
    return params


def _substrate_eval_pdf(ctx, params, uv, wi, wo, nonspecular_only):
    """Substrate f*cos and pdf seen through the coat (substrateEvalAndPdf)."""
    from .dispatch import nested_pdf

    f, wi_sub, wo_sub, cos_to = substrate_eval(ctx, params, uv, wi, wo, nonspecular_only)
    eta = 1.0 / params[..., 0]
    p = nested_pdf(ctx, params[..., 5].to(torch.int64), uv, wi_sub, wo_sub, nonspecular_only)
    return f, p * eta * eta * torch.abs(wo[..., 2] / torch.clamp(cos_to, min=1e-6))


def _coat_args(ctx, params, uv, wi):
    """(roughness, ior, distribution, both lobes on, refraction off)."""
    yes = torch.ones(wi.shape[:-1], dtype=torch.bool, device=wi.device)
    return (resolve_roughness(ctx, params[..., 6], uv), params[..., 0],
            params[..., 7].to(torch.int64), yes, ~yes)


def eval(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    f_sub, _ = _substrate_eval_pdf(ctx, params, uv, wi, wo, nonspecular_only)
    f_coat = rd.eval_base(wi, wo, *_coat_args(ctx, params, uv, wi))
    valid = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return torch.where(valid[..., None], f_sub + f_coat[..., None], 0.0)


def pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    spec_prob = setup(params, wi)[4]
    _, p_sub = _substrate_eval_pdf(ctx, params, uv, wi, wo, nonspecular_only)
    p_coat = rd.pdf_base(wi, wo, *_coat_args(ctx, params, uv, wi))
    p = p_coat * spec_prob + p_sub * (1.0 - spec_prob)
    valid = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return torch.where(valid, p, 0.0)


def sample(ctx, params, albedo, uv, wi, u2, u1, nonspecular_only=False):
    from .dispatch import nested_sample

    ior, eta, _, cos_ti, spec_prob, sub_id = setup(params, wi)
    pick_spec = u1 < spec_prob
    u1_re = torch.clamp((u1 - spec_prob) / torch.clamp(1.0 - spec_prob, min=1e-7),
                        0.0, 1.0 - 1e-7)

    s_coat = rd.sample_base(wi, u2, u1_re, *_coat_args(ctx, params, uv, wi))
    s_sub = nested_sample(ctx, sub_id, uv, warp_in(wi, eta, cos_ti), u2, u1_re,
                          nonspecular_only)
    fo, cos_to = dielectric_reflectance(ior, s_sub.wo[..., 2])
    wo_sub_out = torch.stack([s_sub.wo[..., 0] * ior, s_sub.wo[..., 1] * ior, cos_to], dim=-1)

    wo = torch.where(pick_spec[..., None], s_coat.wo, wo_sub_out)
    lobe = torch.where(pick_spec, Lobes.GLOSSY_R, s_sub.lobe)
    valid_sub = s_sub.valid & (fo < 1.0) & (s_sub.wo[..., 2] > 0.0)
    valid = (wi[..., 2] > 0.0) & torch.where(pick_spec, s_coat.valid, valid_sub)

    # one-sample MIS over the mixture pdf
    f = eval(ctx, params, albedo, uv, wi, wo, nonspecular_only)
    p = pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only)
    valid = valid & (p > 0.0) & (wo[..., 2] > 0.0)
    return BsdfSample(
        wo=wo, weight=torch.where(valid[..., None], f / torch.clamp(p, min=1e-30)[..., None], 0.0),
        pdf=p, lobe=lobe, valid=valid)
