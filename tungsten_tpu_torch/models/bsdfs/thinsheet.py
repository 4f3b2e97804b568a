"""Thin sheet (ThinSheetBsdf.cpp) on torch tensors: an infinitely thin
dielectric slab. Specular reflection with the internal bounces summed;
transmission is a forward lobe, taken through the tracer's transparency
lottery. The interference variant evaluates the wavelength-dependent
thin-film reflectance at the RGB primaries (Fresnel.hpp:39-67; thickness,
a number or a texture, in units of 500 nm).

Port of tungsten_tpu/models/bsdfs/thinsheet.py. Params: [0] ior, [1:4]
sigmaA, [4] thickness texture id, [5] enable_interference.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...math import vecops as vo
from .common import BsdfSample, Lobes

NAME = "thinsheet"
LOBES = Lobes.SPECULAR_R | Lobes.FORWARD
PRIMARIES_NM = (650.0, 510.0, 475.0)


def pack(spec, params, tex_builder):
    from ..textures.textures import texture_from_spec

    params[0] = spec.get("ior", 1.5)
    params[5] = 1.0 if spec.get("enable_interference", False) else 0.0
    sa = np.asarray(spec.get("sigma_a", 0.0), np.float32).ravel()
    params[1:4] = np.repeat(sa, 3) if sa.size == 1 else sa
    params[4] = texture_from_spec(spec.get("thickness", 0.5), tex_builder,
                                  spec.get("_resolve_path"))
    return params


def _thin_film_reflectance(eta, cos_i):
    """Fresnel::thinFilmReflectance (Fresnel.hpp:15): the summed internal
    reflections of a thin slab -> (R, cos_t)."""
    sin_t_sq = eta * eta * (1.0 - cos_i * cos_i)
    tir = sin_t_sq > 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t_sq, min=0.0))
    rs = ((eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-20)) ** 2
    rp = ((eta * cos_t - cos_i) / torch.clamp(eta * cos_t + cos_i, min=1e-20)) ** 2
    r = 1.0 - ((1.0 - rs) / (1.0 + rs) + (1.0 - rp) / (1.0 + rp)) * 0.5
    return torch.where(tir, 1.0, r), torch.where(tir, 0.0, cos_t)


def _thin_film_interference(eta, cos_i, thickness_nm):
    """Fresnel::thinFilmReflectanceInterference (Fresnel.hpp:39-67) at the
    650 / 510 / 475 nm primaries; eta = 1 / ior -> (R (N, 3), cos_t (N,))."""
    inv_lam = 1.0 / torch.tensor(PRIMARIES_NM, dtype=torch.float32, device=cos_i.device)
    sin_t_sq = eta * eta * (1.0 - cos_i * cos_i)
    tir = sin_t_sq > 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t_sq, min=0.0))
    ts = 4.0 * eta * cos_i * cos_t / torch.clamp((eta * cos_i + cos_t) ** 2, min=1e-20)
    tp = 4.0 * eta * cos_i * cos_t / torch.clamp((eta * cos_t + cos_i) ** 2, min=1e-20)
    rs = (1.0 - ts)[..., None]
    rp = (1.0 - tp)[..., None]
    phi = (thickness_nm * cos_t * (4.0 * math.pi) / eta)[..., None] * inv_lam
    cphi = torch.cos(phi)
    t_s = ts[..., None] ** 2 / torch.clamp((rs ** 2 + 1.0) - 2.0 * rs * cphi, min=1e-20)
    t_p = tp[..., None] ** 2 / torch.clamp((rp ** 2 + 1.0) - 2.0 * rp * cphi, min=1e-20)
    r = 1.0 - (t_s + t_p) * 0.5
    return torch.where(tir[..., None], 1.0, r), torch.where(tir, 0.0, cos_t)


def _transmittance(ctx, params, uv, wi):
    """-> (R (N, 3), trans (N, 3)); R is coloured only under interference."""
    from ..textures.textures import eval_texture

    eta = 1.0 / params[..., 0]
    cos_i = torch.abs(wi[..., 2])
    r_p, cos_t_p = _thin_film_reflectance(eta, cos_i)
    thickness = eval_texture(ctx[1], params[..., 4].to(torch.int64), uv)[..., 0]
    r_i, cos_t_i = _thin_film_interference(eta, cos_i, thickness * 500.0)
    interf = params[..., 5] > 0.5
    r3 = torch.where(interf[..., None], r_i, r_p[..., None].expand(*r_p.shape, 3))
    cos_t = torch.where(interf, cos_t_i, cos_t_p)
    trans = 1.0 - r3
    sigma = params[..., 1:4] * thickness[..., None]
    att = torch.exp(-sigma * (2.0 / torch.clamp(cos_t, min=1e-6))[..., None])
    absorbs = torch.any(sigma > 0, dim=-1) & (cos_t > 0.0)
    return r3, torch.where(absorbs[..., None], trans * att, trans)


def eval(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    return torch.zeros(wi.shape[:-1] + (3,), dtype=torch.float32, device=wi.device)


def forward_transparency(ctx, params, albedo, uv, wi):
    return _transmittance(ctx, params, uv, wi)[1]


def pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    return torch.zeros(wi.shape[:-1], dtype=torch.float32, device=wi.device)


def sample(ctx, params, albedo, uv, wi, u2, u1, nonspecular_only=False):
    if nonspecular_only:
        return BsdfSample.invalid(wi.shape[0], wi.device)
    r3, trans = _transmittance(ctx, params, uv, wi)
    # the reflection weight is normalized by the forward lottery's
    # complement (ThinSheetBsdf::sample: R / (1 - avg(trans)))
    shape = wi.shape[:-1]
    return BsdfSample(
        wo=vo.reflect(wi), weight=r3 / torch.clamp(1.0 - vo.avg3(trans), min=1e-6)[..., None],
        pdf=torch.ones(shape, dtype=torch.float32, device=wi.device),
        lobe=torch.full(shape, Lobes.SPECULAR_R, dtype=torch.int64, device=wi.device),
        valid=torch.ones(shape, dtype=torch.bool, device=wi.device))
