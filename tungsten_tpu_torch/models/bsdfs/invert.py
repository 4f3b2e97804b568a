"""BSDF sampling inversion (RJ-MLT's machinery), torch.

Port of tungsten_tpu/models/bsdfs/invert.py (the reference's Bsdf::invert
hierarchy: Bsdf.hpp:68, LambertBsdf.cpp:60-73, OrenNayarBsdf.cpp:102-123,
PlasticBsdf.cpp:90-123, MirrorBsdf.hpp, DielectricBsdf.cpp,
RoughConductorBsdf.hpp with Microfacet::invert, Microfacet.hpp:132-157):
given (wi, wo) at a surface vertex, the primary-sample uniforms (u2, u1)
for which bsdf_sample(..., wi, u2, u1) gives wo back, the core of the
reversible-jump strategy perturbation (ReversibleJumpMltTracer.cpp:196).

`mu` (three free uniforms) fills what the inversion leaves free: a branch
lottery's uniform lands mu-deep in its interval, a degenerate azimuth takes
mu itself, as the reference's untrackedBoolean() / untracked1D().

Nine types invert: lambert, oren_nayar, mirror, conductor, phong, plastic,
rough_plastic, rough_conductor and dielectric. Every other type (the
wrappers, rough_dielectric, thinsheet, forward, ...) reports ok=False, and
the RJ-MLT proposal holding it is rejected: the reference's failure path.
"""
from __future__ import annotations

import torch

from ...math import vecops as vo
from ...sampling import warps
from . import microfacet as mf
from .fresnel import dielectric_reflectance

_REFL_EPS = 1e-4


def _is_reflection(wi, wo):
    return vo.dot(vo.reflect(wi), wo) > 1.0 - _REFL_EPS


def _put_bool(p, value, mu):
    """The uniform u with (u < p) == value, mu-deep in its interval."""
    p = torch.clamp(p, 0.0, 1.0)
    return torch.where(value, mu * p, p + mu * (1.0 - p))


def _pair(mu0):
    return torch.stack([mu0, mu0], dim=-1)


def microfacet_invert(dist, alpha, m, mu=0.5):
    """Microfacet::invert (Microfacet.hpp:132-157): the half vector m -> xi."""
    xi_phi = warps.invert_phi(m, mu)
    cos_t = torch.clamp(m[..., 2], 1e-7, 1.0)
    tan_sq = 1.0 / (cos_t * cos_t) - 1.0
    a_sq = torch.clamp(alpha * alpha, min=1e-20)
    x_beck = 1.0 - torch.exp(-tan_sq / a_sq)
    x_phong = torch.pow(cos_t, alpha + 2.0)
    gamma = tan_sq / a_sq
    x_ggx = gamma / (1.0 + gamma)
    x0 = torch.where(dist == mf.BECKMANN, x_beck, torch.where(dist == mf.PHONG, x_phong, x_ggx))
    return torch.stack([torch.clamp(x0, 0.0, 1.0), xi_phi], dim=-1)


def _inv_lambert(ctx, params, albedo, uv, wi, wo, mu):
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return warps.invert_cosine_hemisphere(wo, mu[0]), mu[2], ok


def _inv_oren_nayar(ctx, params, albedo, uv, wi, wo, mu):
    from . import oren_nayar

    # the roughness is a texture id (an ordinary Texture, OrenNayarBsdf.hpp)
    ratio = torch.clamp(oren_nayar._rough(ctx, params, uv), 0.01, 1.0)
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    pdf_u = warps.uniform_hemisphere_pdf(wo) * ratio
    pdf_c = warps.cosine_hemisphere_pdf(wo) * (1.0 - ratio)
    pick_u = mu[1] < pdf_u / torch.clamp(pdf_u + pdf_c, min=1e-20)
    u2 = torch.where(pick_u[..., None], warps.invert_uniform_hemisphere(wo, mu[0]),
                     warps.invert_cosine_hemisphere(wo, mu[0]))
    return u2, _put_bool(ratio, pick_u, mu[2]), ok


def _inv_mirror(ctx, params, albedo, uv, wi, wo, mu):
    ok = (wi[..., 2] > 0.0) & _is_reflection(wi, wo)
    return _pair(mu[0]), mu[2], ok


def _inv_phong(ctx, params, albedo, uv, wi, wo, mu):
    exponent = params[..., 0]
    dr = params[..., 1]
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    refl = vo.reflect(wi)
    t, b = vo.tangent_frame(refl)
    loc = vo.to_local(t, b, refl, wo)
    in_lobe = loc[..., 2] > 0.0
    # the branches' posteriors (the glossy pick is u1 >= dr)
    pdf_g = torch.where(in_lobe, (1.0 - dr) * (exponent + 1.0) * warps.INV_TWO_PI
                        * torch.pow(torch.clamp(loc[..., 2], min=1e-7), exponent), 0.0)
    pdf_d = dr * warps.cosine_hemisphere_pdf(wo)
    pick_g = (mu[1] < pdf_g / torch.clamp(pdf_g + pdf_d, min=1e-20)) & in_lobe
    u2_g = torch.stack([warps.invert_phi(loc, mu[0]),
                        torch.pow(torch.clamp(loc[..., 2], 1e-7, 1.0), 1.0 + exponent)], dim=-1)
    u2 = torch.where(pick_g[..., None], u2_g, warps.invert_cosine_hemisphere(wo, mu[0]))
    u1 = _put_bool(dr, ~pick_g, mu[2])
    return u2, u1, ok & ((pdf_g + pdf_d) > 0.0)


def _inv_plastic(ctx, params, albedo, uv, wi, wo, mu):
    from .plastic import _spec_prob

    yes = torch.ones(wi.shape[:-1], dtype=torch.bool, device=wi.device)
    sp, _ = _spec_prob(params, wi, yes, yes)
    is_spec = _is_reflection(wi, wo)
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    u1 = _put_bool(sp, is_spec, mu[2])  # the specular pick is u1 < sp
    u2 = torch.where(is_spec[..., None], _pair(mu[0]), warps.invert_cosine_hemisphere(wo, mu[0]))
    return u2, u1, ok


def _inv_rough_plastic(ctx, params, albedo, uv, wi, wo, mu):
    from .common import resolve_roughness
    from .rough_plastic import _spec_prob

    rough = resolve_roughness(ctx, params[..., 6], uv)
    dist = params[..., 7].to(torch.int64)
    # the glossy lobe samples its half vector with the scaled roughness
    # (RoughDielectricBsdf::sampleBase): invert with the same alpha
    alpha_s = mf.roughness_to_alpha(dist, (1.2 - 0.2 * torch.sqrt(torch.abs(wi[..., 2]))) * rough)
    sp = _spec_prob(params, wi)
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    m = vo.normalize(wi + wo, eps=1e-12)
    # the glossy and diffuse posteriors at wo (sampling-measure pdfs)
    pdf_g = sp * mf.pdf(dist, alpha_s, m) * 0.25 / torch.clamp(torch.abs(vo.dot(wi, m)),
                                                                min=1e-20)
    pdf_d = (1.0 - sp) * warps.cosine_hemisphere_pdf(wo)
    pick_g = mu[1] < pdf_g / torch.clamp(pdf_g + pdf_d, min=1e-20)
    u2 = torch.where(pick_g[..., None], microfacet_invert(dist, alpha_s, m, mu[0]),
                     warps.invert_cosine_hemisphere(wo, mu[0]))
    return u2, _put_bool(sp, pick_g, mu[2]), ok & ((pdf_g + pdf_d) > 0.0)


def _inv_rough_conductor(ctx, params, albedo, uv, wi, wo, mu):
    from .common import resolve_roughness
    from .rough_conductor import _unpack

    _, _, rough, dist = _unpack(params)
    alpha = mf.roughness_to_alpha(dist, resolve_roughness(ctx, rough, uv))
    m = vo.normalize(wi + wo, eps=1e-12)
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0) & (vo.dot(wi, m) > 0.0)
    return microfacet_invert(dist, alpha, m, mu[0]), mu[2], ok


def _inv_conductor(ctx, params, albedo, uv, wi, wo, mu):
    return _inv_mirror(ctx, params, albedo, uv, wi, wo, mu)


def _inv_dielectric(ctx, params, albedo, uv, wi, wo, mu):
    ior = params[..., 0]
    enable_t = params[..., 1] > 0.5
    wiz = wi[..., 2]
    eta = torch.where(wiz < 0.0, ior, 1.0 / ior)
    f, cos_t = dielectric_reflectance(eta, torch.abs(wiz))
    reflect_prob = torch.where(enable_t, f, 1.0)
    is_refl = _is_reflection(wi, wo)
    # the refraction: wo must be wi's analytic refraction
    wo_t = torch.stack([-wi[..., 0] * eta, -wi[..., 1] * eta, -torch.sign(wiz) * cos_t], dim=-1)
    is_refr = (vo.dot(vo.normalize(wo_t, eps=1e-12), wo) > 1.0 - _REFL_EPS) & enable_t & (f < 1.0)
    return _pair(mu[0]), _put_bool(reflect_prob, is_refl, mu[2]), is_refl | is_refr


_INVERTERS = {
    "lambert": _inv_lambert,
    "oren_nayar": _inv_oren_nayar,
    "mirror": _inv_mirror,
    "conductor": _inv_conductor,
    "phong": _inv_phong,
    "plastic": _inv_plastic,
    "rough_plastic": _inv_rough_plastic,
    "rough_conductor": _inv_rough_conductor,
    "dielectric": _inv_dielectric,
}


def bsdf_invert(ctx, mat_id, uv, wi, wo, mu=(0.5, 0.5, 0.5)):
    """A masked dispatch over the material types present, as
    dispatch.bsdf_sample: (u2 (N, 2), u1 (N,), ok (N,)), ok False for a
    type without an inverter or a (wi, wo) it cannot produce. ctx:
    (MaterialTable, TextureTable)."""
    from .dispatch import gather, module_for_id

    mats, textures = ctx
    params, tid, albedo, _ = gather(mats, textures, mat_id, uv)[:4]
    n = wi.shape[0]
    mu_arr = tuple(torch.as_tensor(m, dtype=torch.float32, device=wi.device).expand(n)
                   for m in mu)
    u2 = _pair(mu_arr[0])
    u1 = mu_arr[2]
    ok = torch.zeros((n,), dtype=torch.bool, device=wi.device)
    for type_id in mats.present:
        fn = _INVERTERS.get(module_for_id(type_id).NAME)
        if fn is None:
            continue
        iu2, iu1, iok = fn(ctx, params, albedo, uv, wi, wo, mu_arr)
        mask = tid == type_id
        u2 = torch.where(mask[..., None], iu2, u2)
        u1 = torch.where(mask, iu1.expand(n), u1)
        ok = torch.where(mask, iok, ok)
    return u2, u1, ok
