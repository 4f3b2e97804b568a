"""Fresnel terms (Fresnel.hpp:15-123) on torch tensors: dielectric (with
cos theta_t out) and conductor (Shirley's form).

Port of tungsten_tpu/models/bsdfs/fresnel.py; the thin-film term waits for
the BSDF that uses it.
"""
from __future__ import annotations

import torch


def dielectric_reflectance(eta, cos_i):
    """eta = etaI/etaT for cos_i > 0 rays; handles both sides like the
    reference (flips eta when cos_i < 0). Returns (F, cos_t)."""
    flip = cos_i < 0.0
    eta = torch.where(flip, 1.0 / eta, eta)
    ci = torch.abs(cos_i)
    sin_t_sq = eta * eta * (1.0 - ci * ci)
    tir = sin_t_sq > 1.0
    ct = torch.sqrt(torch.clamp(1.0 - sin_t_sq, min=0.0))
    rs = (eta * ci - ct) / torch.clamp(eta * ci + ct, min=1e-20)
    rp = (eta * ct - ci) / torch.clamp(eta * ct + ci, min=1e-20)
    f = 0.5 * (rs * rs + rp * rp)
    return torch.where(tir, 1.0, f), torch.where(tir, 0.0, ct)


def conductor_reflectance(eta, k, cos_i):
    """eta, k: (..., 3) rgb; cos_i: (...,). Returns (..., 3)."""
    ci = torch.clamp(cos_i, min=0.0)[..., None]
    ci_sq = ci * ci
    sin_sq = torch.clamp(1.0 - ci_sq, min=0.0)
    sin_qu = sin_sq * sin_sq
    inner = eta * eta - k * k - sin_sq
    a_sq_b_sq = torch.sqrt(torch.clamp(inner * inner + 4.0 * eta * eta * k * k, min=0.0))
    a = torch.sqrt(torch.clamp((a_sq_b_sq + inner) * 0.5, min=0.0))
    rs = ((a_sq_b_sq + ci_sq) - 2.0 * a * ci) / torch.clamp(
        (a_sq_b_sq + ci_sq) + 2.0 * a * ci, min=1e-20)
    rp = ((ci_sq * a_sq_b_sq + sin_qu) - 2.0 * a * ci * sin_sq) / torch.clamp(
        (ci_sq * a_sq_b_sq + sin_qu) + 2.0 * a * ci * sin_sq, min=1e-20)
    return 0.5 * (rs + rs * rp)
