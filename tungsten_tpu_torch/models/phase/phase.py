"""Phase functions (torch): isotropic, Henyey-Greenstein, Rayleigh.

Port of tungsten_tpu/models/phase/phase.py. Batched over lanes with a
per-lane phase type and g. eval takes (wi, wo) with wi the incoming ray
direction (not negated): HG with positive g scatters forward around +wi.
eval is the pdf as well (the phase functions are normalized and sampled
exactly), so a sample's weight is 1.
"""
from __future__ import annotations

import math

import torch

from ...math import vecops as vo
from ...sampling import warps

PHASE_ISOTROPIC = 0
PHASE_HG = 1
PHASE_RAYLEIGH = 2

_NAMES = {"isotropic": PHASE_ISOTROPIC, "henyey_greenstein": PHASE_HG,
          "rayleigh": PHASE_RAYLEIGH}


def phase_id(name: str) -> int:
    return _NAMES[name]


def _hg(cos_theta, g):
    term = 1.0 + g * g - 2.0 * g * cos_theta
    return warps.INV_FOUR_PI * (1.0 - g * g) / (term * torch.sqrt(torch.clamp(term, min=1e-12)))


def _rayleigh(cos_theta):
    return (3.0 / (16.0 * math.pi)) * (1.0 + cos_theta * cos_theta)


def phase_eval(ptype, g, wi, wo):
    """ptype, g: (N,); wi, wo: (N, 3). Returns (N,)."""
    cos_theta = vo.dot(wi, wo)
    iso = torch.full_like(cos_theta, warps.INV_FOUR_PI)
    hg = torch.where(torch.abs(g) < 1e-4, iso, _hg(cos_theta, g))
    ray = _rayleigh(cos_theta)
    return torch.where(ptype == PHASE_HG, hg, torch.where(ptype == PHASE_RAYLEIGH, ray, iso))


def phase_pdf(ptype, g, wi, wo):
    return phase_eval(ptype, g, wi, wo)


def phase_sample(ptype, g, wi, u2):
    """Returns (w (N, 3), pdf (N,)); the weight is 1."""
    phi = u2[..., 0] * (2.0 * math.pi)

    g_safe = torch.where(torch.abs(g) < 1e-4, 1e-4, g)
    cos_hg = (1.0 + g_safe * g_safe - ((1.0 - g_safe * g_safe)
                                       / (1.0 + g_safe * (u2[..., 1] * 2.0 - 1.0))) ** 2) \
        / (2.0 * g_safe)

    z = u2[..., 1] * 4.0 - 2.0
    inv_z = torch.sqrt(z * z + 1.0)
    u = torch.pow(z + inv_z, 1.0 / 3.0)  # z + sqrt(z^2 + 1) > 0: the real cube root
    cos_ray = u - 1.0 / u

    cos_iso = 1.0 - 2.0 * u2[..., 1]

    use_hg = (ptype == PHASE_HG) & (torch.abs(g) >= 1e-4)
    cos_theta = torch.where(use_hg, cos_hg,
                            torch.where(ptype == PHASE_RAYLEIGH, cos_ray, cos_iso))
    cos_theta = torch.clamp(cos_theta, -1.0, 1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    local = torch.stack([torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta, cos_theta],
                        dim=-1)
    t, b = vo.tangent_frame(wi)
    w = vo.to_global(t, b, wi, local)
    return w, phase_eval(ptype, g, wi, w)
