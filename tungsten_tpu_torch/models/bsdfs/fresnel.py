"""Conductor Fresnel term (Fresnel.hpp, Shirley's form) on torch tensors.

Port of conductor_reflectance from tungsten_tpu/models/bsdfs/fresnel.py; the
dielectric and thin-film terms wait for the BSDFs that use them.
"""
from __future__ import annotations

import torch


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
