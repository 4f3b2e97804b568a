"""Rough dielectric (RoughDielectricBsdf.cpp, Walter 2007): microfacet
reflection and refraction with a Fresnel lottery, on torch tensors.

Port of tungsten_tpu/models/bsdfs/rough_dielectric.py. sample_base,
eval_base and pdf_base are the reference's statics, shared with
rough_plastic (and later the rough coat). Params: [0] ior, [1] roughness (a
scalar or a texture: common.pack_roughness), [2] distribution, [3]
enable_refraction. The radiance eta^2 is folded into transmission weights
(the Bsdf wrapper's semantics); eta_sq() gives it apart.
"""
from __future__ import annotations

import torch

from ...math import vecops as vo
from . import microfacet as mf
from .common import BsdfSample, Lobes, pack_roughness, resolve_roughness
from .fresnel import dielectric_reflectance

NAME = "rough_dielectric"
LOBES = Lobes.GLOSSY_R | Lobes.GLOSSY_T


def lobes_for(spec, sub_lobes):
    if spec.get("enable_refraction", True):
        return Lobes.GLOSSY_R | Lobes.GLOSSY_T
    return Lobes.GLOSSY_R


def pack(spec, params, tex_builder):
    params[0] = spec.get("ior", 1.5)
    params[1] = pack_roughness(spec, "roughness", 0.1, tex_builder)
    params[2] = mf.dist_id(spec.get("distribution", "ggx"))
    params[3] = 1.0 if spec.get("enable_refraction", True) else 0.0
    return params


def sample_base(wi, u2, u1, rough, ior, dist, sample_r, sample_t):
    """RoughDielectricBsdf::sampleBase. sample_r / sample_t: (N,) bool masks.
    Returns a BsdfSample whose weight excludes albedo and eta^2."""
    wi_dot_n = wi[..., 2]
    eta = torch.where(wi_dot_n < 0.0, ior, 1.0 / ior)
    sample_rough = (1.2 - 0.2 * torch.sqrt(torch.abs(wi_dot_n))) * rough
    alpha = mf.roughness_to_alpha(dist, rough)
    sample_alpha = mf.roughness_to_alpha(dist, sample_rough)

    m = mf.sample(dist, sample_alpha, u2)
    pm = mf.pdf(dist, sample_alpha, m)
    wi_dot_m = vo.dot(wi, m)
    f, cos_t = dielectric_reflectance(1.0 / ior, wi_dot_m)
    eta_m = torch.where(wi_dot_m < 0.0, ior, 1.0 / ior)

    both = sample_r & sample_t
    # the lottery decides only where both lobes are allowed
    reflect = torch.where(both, u1 < f, sample_r)
    wo_r = 2.0 * wi_dot_m[..., None] * m - wi
    wo_t = ((eta_m * wi_dot_m - torch.sign(wi_dot_m) * cos_t)[..., None] * m
            - eta_m[..., None] * wi)
    wo = torch.where(reflect[..., None], wo_r, wo_t)
    wo_dot_n = wo[..., 2]
    reflected = wi_dot_n * wo_dot_n > 0.0
    valid = (pm > 1e-10) & (reflected == reflect) & (sample_r | sample_t)
    valid = valid & (reflect | (f < 1.0))

    wo_dot_m = vo.dot(wo, m)
    g = mf.G(dist, alpha, wi, wo, m)
    d = mf.D(dist, alpha, m)
    w = torch.abs(wi_dot_m) * g * d / torch.clamp(torch.abs(wi_dot_n) * pm, min=1e-20)

    pdf_r = pm * 0.25 / torch.clamp(torch.abs(wi_dot_m), min=1e-20)
    pdf_t = pm * torch.abs(wo_dot_m) / torch.clamp((eta * wi_dot_m + wo_dot_m) ** 2, min=1e-20)
    p = torch.where(reflect, pdf_r, pdf_t)

    f_pick = torch.where(reflect, f, 1.0 - f)
    p = torch.where(both, p * f_pick, p)
    w = torch.where(both, w, w * f_pick)

    lobe = torch.where(reflect, Lobes.GLOSSY_R, Lobes.GLOSSY_T)
    return BsdfSample(wo=wo, weight=w[..., None].expand(*w.shape, 3), pdf=p, lobe=lobe,
                      valid=valid)


def _half_vector(wi, wo, ior):
    """(reflect, eta, m, wi.m, wo.m, F(wi.m)) of the pair: the reflection
    half vector on the incident side, or the refraction one."""
    wi_dot_n = wi[..., 2]
    reflect = wi_dot_n * wo[..., 2] >= 0.0
    eta = torch.where(wi_dot_n < 0.0, ior, 1.0 / ior)
    m_r = torch.sign(wi_dot_n)[..., None] * vo.normalize(wi + wo, eps=1e-12)
    m_t = -vo.normalize(wi * eta[..., None] + wo, eps=1e-12)
    m = torch.where(reflect[..., None], m_r, m_t)
    wi_dot_m = vo.dot(wi, m)
    wo_dot_m = vo.dot(wo, m)
    f, _ = dielectric_reflectance(1.0 / ior, wi_dot_m)
    return reflect, eta, m, wi_dot_m, wo_dot_m, f


def eval_base(wi, wo, rough, ior, dist, sample_r, sample_t):
    """RoughDielectricBsdf::evalBase -> (N,) scalar f*cos (no albedo, no eta^2)."""
    wi_dot_n = wi[..., 2]
    alpha = mf.roughness_to_alpha(dist, rough)
    reflect, eta, m, wi_dot_m, wo_dot_m, f = _half_vector(wi, wo, ior)
    g = mf.G(dist, alpha, wi, wo, m)
    d = mf.D(dist, alpha, m)
    fr = f * g * d * 0.25 / torch.clamp(torch.abs(wi_dot_n), min=1e-20)
    fs = (torch.abs(wi_dot_m * wo_dot_m) * (1.0 - f) * g * d
          / torch.clamp((eta * wi_dot_m + wo_dot_m) ** 2 * torch.abs(wi_dot_n), min=1e-20))
    out = torch.where(reflect, fr, fs)
    allowed = torch.where(reflect, sample_r, sample_t)
    return torch.where(allowed, out, 0.0)


def pdf_base(wi, wo, rough, ior, dist, sample_r, sample_t):
    """RoughDielectricBsdf::pdfBase -> (N,) solid-angle pdf of sample_base."""
    wi_dot_n = wi[..., 2]
    sample_rough = (1.2 - 0.2 * torch.sqrt(torch.abs(wi_dot_n))) * rough
    sample_alpha = mf.roughness_to_alpha(dist, sample_rough)
    reflect, eta, m, wi_dot_m, wo_dot_m, f = _half_vector(wi, wo, ior)
    pm = mf.pdf(dist, sample_alpha, m)
    pdf_r = pm * 0.25 / torch.clamp(torch.abs(wi_dot_m), min=1e-20)
    pdf_t = pm * torch.abs(wo_dot_m) / torch.clamp((eta * wi_dot_m + wo_dot_m) ** 2, min=1e-20)
    p = torch.where(reflect, pdf_r, pdf_t)
    p = torch.where(sample_r & sample_t, p * torch.where(reflect, f, 1.0 - f), p)
    allowed = torch.where(reflect, sample_r, sample_t)
    return torch.where(allowed, p, 0.0)


def _masks(params, wi):
    """Glossy lobes are not specular: nonspecular_only keeps both."""
    return torch.ones(wi.shape[:-1], dtype=torch.bool, device=wi.device), params[..., 3] > 0.5


def _unpack(ctx, params, uv):
    return (params[..., 0], resolve_roughness(ctx, params[..., 1], uv),
            params[..., 2].to(torch.int64))


def eta_sq(params, wi, wo):
    ior = params[..., 0]
    transmit = wi[..., 2] * wo[..., 2] < 0.0
    eta = torch.where(wi[..., 2] < 0.0, ior, 1.0 / ior)
    return torch.where(transmit, eta * eta, 1.0)


def eval(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    ior, rough, dist = _unpack(ctx, params, uv)
    f = eval_base(wi, wo, rough, ior, dist, *_masks(params, wi))
    return albedo * (f * eta_sq(params, wi, wo))[..., None]


def pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    ior, rough, dist = _unpack(ctx, params, uv)
    return pdf_base(wi, wo, rough, ior, dist, *_masks(params, wi))


def sample(ctx, params, albedo, uv, wi, u2, u1, nonspecular_only=False):
    ior, rough, dist = _unpack(ctx, params, uv)
    s = sample_base(wi, u2, u1, rough, ior, dist, *_masks(params, wi))
    return BsdfSample(wo=s.wo, weight=s.weight * albedo * eta_sq(params, wi, s.wo)[..., None],
                      pdf=s.pdf, lobe=s.lobe, valid=s.valid)
