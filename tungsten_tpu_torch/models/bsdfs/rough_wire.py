"""Rough wire BCSDF (src/core/bsdfs/RoughWireBcsdf.cpp), torch.

Port of tungsten_tpu/models/bsdfs/rough_wire.py. A metal wire: perfectly
smooth in azimuth (N reduces to the h -> phi mirror jacobian,
RoughWireBcsdf.cpp:56-61) with a rough von-Mises longitudinal lobe M of
variance v = (roughness * pi/2)^2 (:64-76), attenuated by the complex-IOR
conductor Fresnel at the wi/wo half angle (:120-137).

Frame convention as hair.py: fiber tangent on local y (sin(theta) = dir.y),
phi measured in the (x, z) normal plane; cosPhi = cos(azimuth(wo) -
azimuth(wi)), the rotation-invariant form of the reference's
wo.z / |wo.xz|. sample() draws phi = 2 gamma, which agrees with N's pdf
(the reference's own sample uses gamma, :155; the JAX package's caveat).

Params: [0:3] eta rgb, [3:6] k rgb, [6] v (longitudinal variance).
"""
from __future__ import annotations

import numpy as np
import torch

from .common import BsdfSample, Lobes
from .complex_ior import lookup
from .fresnel import conductor_reflectance
from .hair import _M, _sample_m, _trig_inv
from .lambertian_fiber import _rotate_by_azimuth

NAME = "rough_wire"
LOBES = Lobes.GLOSSY_R | Lobes.ANISOTROPIC


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
    rough = float(spec.get("roughness", 0.1))
    params[6] = max((rough * np.pi * 0.5) ** 2, 1e-6)  # prepareForRender (:177-180)
    return params


def _trig_half(x):
    return torch.clamp(torch.sqrt(torch.clamp(x * 0.5 + 0.5, min=0.0)), max=1.0)


def _N(cos_phi):  # noqa: N802 (the reference's name)
    """Azimuthal mirror jacobian (RoughWireBcsdf.cpp:56-61)."""
    return 0.25 * _trig_half(cos_phi)


def _angles(wi, wo):
    sin_ti = torch.clamp(wi[..., 1], -1.0, 1.0)
    sin_to = torch.clamp(wo[..., 1], -1.0, 1.0)
    # cos(azimuth difference) via the normalized 2D dot in the normal plane
    lo = torch.sqrt(torch.clamp(wo[..., 0] ** 2 + wo[..., 2] ** 2, min=1e-24))
    li = torch.sqrt(torch.clamp(wi[..., 0] ** 2 + wi[..., 2] ** 2, min=1e-24))
    cos_phi = (wo[..., 0] * wi[..., 0] + wo[..., 2] * wi[..., 2]) / (lo * li)
    return sin_ti, sin_to, _trig_inv(sin_ti), _trig_inv(sin_to), torch.clamp(cos_phi, -1.0, 1.0)


def _nm(params, wi, wo):
    sin_ti, sin_to, cos_ti, cos_to, cos_phi = _angles(wi, wo)
    nm = _N(cos_phi) * _M(params[..., 6], sin_ti, sin_to, cos_ti, cos_to)
    return torch.where(torch.isfinite(nm), nm, 0.0)


def _fresnel(params, wi, wo):
    cos_h = _trig_half(torch.sum(wi * wo, dim=-1))
    return conductor_reflectance(params[..., 0:3], params[..., 3:6], cos_h)


def eval(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):  # noqa: A001
    return albedo * _fresnel(params, wi, wo) * _nm(params, wi, wo)[..., None]


def pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    return _nm(params, wi, wo)


def sample(ctx, params, albedo, uv, wi, u2, u1, nonspecular_only=False):
    """sampleN + sampleM (RoughWireBcsdf.cpp:78-96, 139-163), rotated from
    the wi-azimuth frame into the shading frame: the fiber offset h =
    sin(gamma) is uniform and the mirror deflection is phi = 2 gamma, whose
    density is N(cos phi) = 0.25 cos(phi / 2)."""
    n = wi.shape[0]
    v = params[..., 6]
    sin_ti = torch.clamp(wi[..., 1], -1.0, 1.0)
    cos_ti = _trig_inv(sin_ti)

    sin_half = 2.0 * u1 - 1.0  # sampleN: uniform across the fiber width
    cos_half = _trig_inv(sin_half)
    sin_phi = 2.0 * sin_half * cos_half
    cos_phi = 1.0 - 2.0 * sin_half * sin_half
    sin_to = _sample_m(v, sin_ti, cos_ti, u2[..., 0], u2[..., 1])
    cos_to = _trig_inv(sin_to)
    wo0 = torch.stack([sin_phi * cos_to, sin_to, cos_phi * cos_to], dim=-1)
    wo = _rotate_by_azimuth(wo0, wi)
    p = _N(cos_phi) * _M(v, sin_ti, sin_to, cos_ti, cos_to)
    p = torch.where(torch.isfinite(p), p, 0.0)
    valid = p > 0.0
    return BsdfSample(
        wo=wo,
        weight=torch.where(valid[..., None], albedo * _fresnel(params, wi, wo), 0.0),
        pdf=p,
        lobe=torch.full((n,), LOBES, dtype=torch.int64, device=wi.device),
        valid=valid,
    )
