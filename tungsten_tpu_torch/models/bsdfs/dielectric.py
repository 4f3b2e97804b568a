"""Smooth dielectric (DielectricBsdf.cpp): dirac specular reflection and
refraction with a Fresnel lottery, on torch tensors.

Port of tungsten_tpu/models/bsdfs/dielectric.py. The radiance-transport
eta^2 (Bsdf.hpp:87, the non-adjoint wrapper with DielectricBsdf::eta) is
folded into the transmission weight; eta_sq() gives it apart. Params: [0]
ior, [1] enable_refraction.
"""
from __future__ import annotations

import torch

from ...utils import trace
from .common import BsdfSample, Lobes
from .fresnel import dielectric_reflectance

NAME = "dielectric"
LOBES = Lobes.SPECULAR_R | Lobes.SPECULAR_T


def lobes_for(spec, sub_lobes):
    if spec.get("enable_refraction", True):
        return Lobes.SPECULAR_R | Lobes.SPECULAR_T
    return Lobes.SPECULAR_R


def pack(spec, params, tex_builder):
    params[0] = spec.get("ior", 1.5)
    params[1] = 1.0 if spec.get("enable_refraction", True) else 0.0
    return params


def eval(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    return torch.zeros(wi.shape[:-1] + (3,), dtype=torch.float32, device=wi.device)


def pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    return torch.zeros(wi.shape[:-1], dtype=torch.float32, device=wi.device)


def sample(ctx, params, albedo, uv, wi, u2, u1, nonspecular_only=False):
    if nonspecular_only:
        return BsdfSample.invalid(wi.shape[0], wi.device)
    ior = params[..., 0]
    enable_t = params[..., 1] > 0.5
    wiz = wi[..., 2]
    eta = torch.where(wiz < 0.0, ior, 1.0 / ior)
    f, cos_t = dielectric_reflectance(eta, torch.abs(wiz))

    reflect_prob = torch.where(enable_t, f, 1.0)
    reflect = u1 < reflect_prob

    with trace.span("sync.h2d.dielectric"):  # a host list copied up: the stream waits
        flip = torch.tensor([-1.0, -1.0, 1.0], device=wi.device)
    wo_r = wi * flip
    wo_t = torch.stack([-wi[..., 0] * eta, -wi[..., 1] * eta, -torch.sign(wiz) * cos_t],
                       dim=-1)
    wo = torch.where(reflect[..., None], wo_r, wo_t)
    # with both lobes enabled the lottery cancels Fresnel (weight 1);
    # reflection only keeps F. Transmission gets the radiance eta^2 factor
    w_r = torch.where(enable_t, 1.0, f)
    w = torch.where(reflect, w_r, eta * eta)
    p = torch.where(reflect, reflect_prob, 1.0 - reflect_prob)
    valid = reflect | (f < 1.0)
    lobe = torch.where(reflect, Lobes.SPECULAR_R, Lobes.SPECULAR_T)
    return BsdfSample(
        wo=wo,
        weight=torch.where(valid[..., None], albedo * w[..., None], 0.0),
        pdf=p,
        lobe=lobe,
        valid=valid,
    )


def eta_sq(params, wi, wo):
    ior = params[..., 0]
    transmit = wi[..., 2] * wo[..., 2] < 0.0
    eta = torch.where(wi[..., 2] < 0.0, ior, 1.0 / ior)
    return torch.where(transmit, eta * eta, 1.0)
