"""Energy-conserving hair BCSDF (d'Eon et al. / Marschner R+TT+TRT), torch.

Port of tungsten_tpu/models/bsdfs/hair.py, a mirror of
src/core/bsdfs/HairBcsdf.cpp: longitudinal scattering M (:129-140,
von-Mises-like with the stable small-v form), azimuthal scattering N_p
precomputed by Gauss-Legendre integration over the fiber width into 64x64
(phi, cosThetaD) tables (:318-415), lobe shifts from the hair scale tilt
(:200-204), melanin-derived absorption (:433-440).

Conventions (the JAX package's):
  * The local shading frame has the FIBER TANGENT on the y axis (the
    reference Curves::tangentSpace puts the curve tangent on B,
    Curves.cpp:517-528); sin(theta) = direction.y.
  * phi is the azimuthal DIFFERENCE atan2(wo.x, wo.z) - atan2(wi.x, wi.z),
    wrapped to [0, 2 pi) as jnp.mod wraps it.
  * The azimuthal sampling / pdf uses the NEAREST cosThetaD table row (the
    reference interpolates rows); sample and pdf use the same row so the MIS
    weights stay consistent. eval() interpolates bilinearly.

The host side (`pack`, `precompute_azimuthal`) is the JAX package's numpy
code: the (3, 64, 64, 3) tables, the per-row CDFs and the per-row sums of
each hair material are built at flatten time (dispatch.pack_materials) and
ride in MaterialTable.hair_tables / hair_cdf / hair_sums.
"""
from __future__ import annotations

import numpy as np
import torch

from .common import BsdfSample, Lobes

NAME = "hair"
LOBES = Lobes.GLOSSY_R | Lobes.ANISOTROPIC

ETA = 1.55
RES = 64  # PrecomputedAzimuthalLobe::AzimuthalResolution
TWO_PI = 2.0 * np.pi


def pack(spec, params, tex_builder):
    """params: [scale_angle_rad, beta_r, hair_table_index] (set up by
    pack_materials' hair pre-pass, which owns the table precompute)."""
    params[0] = spec["_scale_rad"]
    params[1] = spec["_beta_r"]
    params[2] = float(spec["_hair_index"])
    return params


# ---------------------------------------------------------------------------
# host-side precompute (numpy), HairBcsdf::precomputeAzimuthalDistributions
# ---------------------------------------------------------------------------

def _np_dielectric_reflectance(eta, cos_i):
    """Unpolarized Fresnel for relative ior eta = n1/n2 (Fresnel.hpp:77)."""
    cos_i = np.clip(cos_i, 0.0, 1.0)
    sin_t_sq = eta * eta * (1.0 - cos_i * cos_i)
    total = sin_t_sq > 1.0
    cos_t = np.sqrt(np.maximum(1.0 - sin_t_sq, 0.0))
    rs = (eta * cos_i - cos_t) / np.maximum(eta * cos_i + cos_t, 1e-12)
    rp = (eta * cos_t - cos_i) / np.maximum(eta * cos_t + cos_i, 1e-12)
    f = 0.5 * (rs * rs + rp * rp)
    return np.where(total, 1.0, f)


def _np_gauss(beta, theta):
    return np.exp(-theta * theta / (2.0 * beta * beta)) / (np.sqrt(2.0 * np.pi) * beta)


def _np_detector(beta, phi):
    """Wrapped Gaussian detector D (HairBcsdf.cpp:62-73)."""
    result = np.zeros_like(phi)
    shift = 0.0
    while True:
        delta = _np_gauss(beta, phi + shift) + _np_gauss(beta, phi - shift - TWO_PI)
        result += delta
        shift += TWO_PI
        if np.max(delta) <= 1e-4:
            break
    return result


def precompute_azimuthal(sigma_a, beta_r):
    """Returns (table (3, RES, RES, 3), cdf (3, RES, RES+1), sums (3, RES)).

    table[p, y, x]: N_p at phi = 2pi x/(RES-1), cosThetaD = y/(RES-1).
    cdf[p, y]: normalized-to-sum CDF over the RES phi bins of row y, used
    for azimuthal importance sampling; sums[p, y] = integral of N_p
    luminance over phi (the per-lobe selection weight)."""
    sigma_a = np.asarray(sigma_a, np.float64).reshape(3)
    n_pts = 140
    points, weights = np.polynomial.legendre.leggauss(n_pts)
    gamma_i = np.arcsin(points)

    n_gauss = 2048
    phi_grid = np.arange(n_gauss) / (n_gauss - 1.0) * TWO_PI
    d_tab = _np_detector(max(beta_r, 0.04), phi_grid)

    def approx_d(phi):
        u = np.abs(phi * ((n_gauss - 1) / TWO_PI))
        x0 = u.astype(np.int64)
        frac = u - x0
        return d_tab[x0 % n_gauss] * (1.0 - frac) + d_tab[(x0 + 1) % n_gauss] * frac

    table = np.zeros((3, RES, RES, 3), np.float32)
    for y in range(RES):
        cos_half = y / (RES - 1.0)
        cos_half = max(cos_half, 1e-4)
        ior_prime = np.sqrt(ETA * ETA - (1.0 - cos_half**2)) / cos_half
        cos_theta_t = np.sqrt(1.0 - (1.0 - cos_half**2) * (1.0 / ETA) ** 2)
        sigma_a_prime = sigma_a / cos_theta_t

        gamma_t = np.arcsin(np.clip(points / ior_prime, -1.0, 1.0))
        fres = _np_dielectric_reflectance(1.0 / ETA, cos_half * np.cos(gamma_i))
        absorb = np.exp(-sigma_a_prime[None, :] * (2.0 * np.cos(gamma_t))[:, None])

        a_r = fres  # (n_pts,)
        a_tt = ((1.0 - fres) ** 2)[:, None] * absorb
        a_trt = a_tt * fres[:, None] * absorb

        phis = TWO_PI * np.arange(RES) / (RES - 1.0)  # (RES,)
        for p, a in ((0, a_r[:, None] * np.ones((1, 3))), (1, a_tt), (2, a_trt)):
            # Phi(gammaI, gammaT, p) = 2 p gammaT - 2 gammaI + p pi
            phi_p = 2.0 * p * gamma_t - 2.0 * gamma_i + p * np.pi  # (n_pts,)
            dphi = phis[:, None] - phi_p[None, :]  # (RES, n_pts)
            dv = approx_d(dphi)
            table[p, y] = 0.5 * np.einsum("i,ri,ic->rc", weights, dv, a).astype(np.float32)

    lum = table.mean(-1)  # (3, RES, RES) channel-average for sampling
    bin_w = TWO_PI / RES
    sums = lum.sum(-1) * bin_w  # (3, RES) integral over phi
    cdf = np.zeros((3, RES, RES + 1), np.float32)
    cdf[..., 1:] = np.cumsum(lum, axis=-1)
    norm = np.maximum(cdf[..., -1:], 1e-20)
    cdf = cdf / norm
    return table, cdf.astype(np.float32), sums.astype(np.float32)


# ---------------------------------------------------------------------------
# eval / pdf / sample on torch tensors
# ---------------------------------------------------------------------------

def _mod_2pi(x):
    """jnp.mod(x, 2 pi): the truncated remainder, moved into [0, 2 pi)."""
    r = torch.fmod(x, TWO_PI)
    return torch.where((r != 0.0) & (r < 0.0), r + TWO_PI, r)


def _i0(x):
    """Modified Bessel I0, 10-term series (HairBcsdf.cpp:25-37); the
    denominators are host constants, as in the JAX trace."""
    x_sq = x * x
    result = torch.ones_like(x)
    xi = x_sq
    denom = 4.0
    for i in range(1, 11):
        result = result + xi / denom
        xi = xi * x_sq
        denom = denom * 4.0 * (i + 1) ** 2
    return result


def _log_i0(x):
    big = x > 12.0
    xs = torch.clamp(x, min=1e-6)
    stable = x + 0.5 * (torch.log(1.0 / (TWO_PI * xs)) + 1.0 / (8.0 * xs))
    return torch.where(big, stable,
                       torch.log(torch.clamp(_i0(torch.clamp(x, max=12.0)), min=1e-30)))


def _M(v, sin_i, sin_o, cos_i, cos_o):  # noqa: N802 (the reference's name)
    """Longitudinal scattering (HairBcsdf.cpp:129-140)."""
    a = cos_i * cos_o / v
    b = sin_i * sin_o / v
    small = v < 0.1
    m_small = torch.exp(-b + _log_i0(a) - 1.0 / v + 0.6931 + torch.log(1.0 / (2.0 * v)))
    m_big = torch.exp(-b) * _i0(torch.clamp(a, max=12.0)) / (
        2.0 * v * torch.sinh(1.0 / torch.clamp(v, min=1e-3)))
    return torch.where(small, m_small, m_big)


def _trig_inv(x):
    return torch.sqrt(torch.clamp(1.0 - x * x, min=0.0))


def _angles(wi, wo):
    sin_ti = torch.clamp(wi[..., 1], -1.0, 1.0)
    sin_to = torch.clamp(wo[..., 1], -1.0, 1.0)
    theta_i = torch.asin(sin_ti)
    theta_o = torch.asin(sin_to)
    cos_td = torch.cos((theta_o - theta_i) * 0.5)
    phi = torch.atan2(wo[..., 0], wo[..., 2]) - torch.atan2(wi[..., 0], wi[..., 2])
    return theta_i, sin_to, torch.cos(theta_o), cos_td, _mod_2pi(phi)


def _betas(params):
    beta_r = params[..., 1]
    return beta_r * beta_r, (0.5 * beta_r) ** 2, (2.0 * beta_r) ** 2


def _shifted(theta_i, scale):
    return theta_i - 2.0 * scale, theta_i + scale, theta_i + 4.0 * scale


def _tab_eval(tables, idx, p, phi, cos_td):
    """Bilinear lookup of table[idx, p] at (phi, cosThetaD): the
    PrecomputedAzimuthalLobe::eval grid semantics."""
    u = (RES - 1) * phi / TWO_PI
    v = (RES - 1) * cos_td
    x0 = torch.clamp(u.to(torch.int64), 0, RES - 2)
    y0 = torch.clamp(v.to(torch.int64), 0, RES - 2)
    fu = torch.clamp(u - x0, 0.0, 1.0)[..., None]
    fv = torch.clamp(v - y0, 0.0, 1.0)[..., None]
    t00 = tables[idx, p, y0, x0]
    t10 = tables[idx, p, y0, x0 + 1]
    t01 = tables[idx, p, y0 + 1, x0]
    t11 = tables[idx, p, y0 + 1, x0 + 1]
    return (t00 * (1 - fu) + t10 * fu) * (1 - fv) + (t01 * (1 - fu) + t11 * fu) * fv


def _row(cos_td):
    """Nearest cosThetaD row (see module docstring)."""
    return torch.clamp(torch.round((RES - 1) * cos_td).to(torch.int64), 0, RES - 1)


def _az_pdf(cdf, idx, p, row, phi):
    """Azimuthal pdf at phi from the row CDF (per-bin constant density)."""
    x = torch.clamp((phi / TWO_PI * RES).to(torch.int64), 0, RES - 1)
    mass = cdf[idx, p, row, x + 1] - cdf[idx, p, row, x]
    return mass * RES / TWO_PI


def _weight(sums, idx, p, cos_td):
    """Lobe selection weight = integral of N_p over phi at cosThetaD."""
    v = (RES - 1) * cos_td
    y0 = torch.clamp(v.to(torch.int64), 0, RES - 2)
    f = torch.clamp(v - y0, 0.0, 1.0)
    return sums[idx, p, y0] * (1 - f) + sums[idx, p, y0 + 1] * f


def _index(mats, params):
    """The lanes' hair table index, clamped: a masked dispatch hands every
    lane to every present type, and a gather past the table clamps."""
    return torch.clamp(params[..., 2].to(torch.int64), 0, mats.hair_tables.shape[0] - 1)


def eval(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):  # noqa: A001
    mats = ctx[0]
    idx = _index(mats, params)
    scale = params[..., 0]
    theta_i, sin_to, cos_to, cos_td, phi = _angles(wi, wo)
    v_r, v_tt, v_trt = _betas(params)
    t_r, t_tt, t_trt = _shifted(theta_i, scale)
    m_r = _M(v_r, torch.sin(t_r), sin_to, torch.cos(t_r), cos_to)
    m_tt = _M(v_tt, torch.sin(t_tt), sin_to, torch.cos(t_tt), cos_to)
    m_trt = _M(v_trt, torch.sin(t_trt), sin_to, torch.cos(t_trt), cos_to)
    tabs = mats.hair_tables
    out = (m_r[..., None] * _tab_eval(tabs, idx, 0, phi, cos_td)
           + m_tt[..., None] * _tab_eval(tabs, idx, 1, phi, cos_td)
           + m_trt[..., None] * _tab_eval(tabs, idx, 2, phi, cos_td))
    return torch.where(torch.isfinite(out), out, 0.0)


def pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    mats = ctx[0]
    idx = _index(mats, params)
    scale = params[..., 0]
    theta_i, sin_to, cos_to, cos_td, phi = _angles(wi, wo)
    cos_ti = _trig_inv(torch.clamp(wi[..., 1], -1.0, 1.0))
    v_r, v_tt, v_trt = _betas(params)
    t_r, t_tt, t_trt = _shifted(theta_i, scale)
    w_r = _weight(mats.hair_sums, idx, 0, cos_ti)
    w_tt = _weight(mats.hair_sums, idx, 1, cos_ti)
    w_trt = _weight(mats.hair_sums, idx, 2, cos_ti)
    w_sum = torch.clamp(w_r + w_tt + w_trt, min=1e-20)
    row = _row(cos_td)
    cdf = mats.hair_cdf
    p_r = w_r * _M(v_r, torch.sin(t_r), sin_to, torch.cos(t_r), cos_to) * _az_pdf(
        cdf, idx, 0, row, phi)
    p_tt = w_tt * _M(v_tt, torch.sin(t_tt), sin_to, torch.cos(t_tt), cos_to) * _az_pdf(
        cdf, idx, 1, row, phi)
    p_trt = w_trt * _M(v_trt, torch.sin(t_trt), sin_to, torch.cos(t_trt), cos_to) * _az_pdf(
        cdf, idx, 2, row, phi)
    p = (p_r + p_tt + p_trt) / w_sum
    return torch.where(torch.isfinite(p), p, 0.0)


def _sample_m(v, sin_ti, cos_ti, xi1, xi2):
    """sampleM (HairBcsdf.cpp:143-155, stable vMF form); returns sinThetaO."""
    cos_t = 1.0 + v * torch.log(torch.clamp(xi1 + (1.0 - xi1) * torch.exp(-2.0 / v), min=1e-30))
    sin_t = _trig_inv(cos_t)
    cos_phi = torch.cos(TWO_PI * xi2)
    return torch.clamp(-cos_t * sin_ti + sin_t * cos_phi * cos_ti, -1.0, 1.0)


def sample(ctx, params, albedo, uv, wi, u2, u1, nonspecular_only=False):
    mats = ctx[0]
    n = wi.shape[0]
    idx = _index(mats, params)
    scale = params[..., 0]
    sin_ti = torch.clamp(wi[..., 1], -1.0, 1.0)
    cos_ti = _trig_inv(sin_ti)
    theta_i = torch.asin(sin_ti)
    v_r, v_tt, v_trt = _betas(params)
    t_r, t_tt, t_trt = _shifted(theta_i, scale)

    w_r = _weight(mats.hair_sums, idx, 0, cos_ti)
    w_tt = _weight(mats.hair_sums, idx, 1, cos_ti)
    w_trt = _weight(mats.hair_sums, idx, 2, cos_ti)
    target = u1 * torch.clamp(w_r + w_tt + w_trt, min=1e-20)
    pick_tt = (target >= w_r) & (target < w_r + w_tt)
    pick_trt = target >= w_r + w_tt
    v = torch.where(pick_trt, v_trt, torch.where(pick_tt, v_tt, v_r))
    theta = torch.where(pick_trt, t_trt, torch.where(pick_tt, t_tt, t_r))
    lobe_p = torch.where(pick_trt, 2, torch.where(pick_tt, 1, 0))

    sin_to = _sample_m(v, torch.sin(theta), torch.cos(theta), u2[..., 0], u2[..., 1])
    cos_to = _trig_inv(sin_to)
    theta_o = torch.asin(torch.clamp(sin_to, -1.0, 1.0))
    cos_td = torch.cos((theta_o - theta_i) * 0.5)

    # azimuthal sample: inverse-CDF over the nearest row's phi bins, then
    # uniform within the bin; the lobe-pick uniform is remapped to its
    # conditional remainder (hair.py: the dispatch gives 3 uniforms where
    # the reference draws 4, HairBcsdf.cpp:222-224)
    row = _row(cos_td)
    cum_lo = torch.where(pick_trt, w_r + w_tt, torch.where(pick_tt, w_r, 0.0))
    w_pick = torch.where(pick_trt, w_trt, torch.where(pick_tt, w_tt, w_r))
    xi = torch.clamp((target - cum_lo) / torch.clamp(w_pick, min=1e-20), 0.0, 1.0 - 1e-7)
    cdf = mats.hair_cdf
    lo = torch.zeros((n,), dtype=torch.int64, device=wi.device)
    hi = torch.full((n,), RES, dtype=torch.int64, device=wi.device)
    for _ in range(7):
        mid = (lo + hi) // 2
        go_hi = cdf[idx, lobe_p, row, mid] <= xi
        lo = torch.where(go_hi, mid, lo)
        hi = torch.where(go_hi, hi, mid)
    x = torch.clamp(lo, 0, RES - 1)
    c0 = cdf[idx, lobe_p, row, x]
    c1 = cdf[idx, lobe_p, row, x + 1]
    frac = torch.clamp((xi - c0) / torch.clamp(c1 - c0, min=1e-20), 0.0, 1.0)
    d_phi = TWO_PI * (x.to(torch.float32) + frac) / RES
    # rotate the sampled azimuthal difference by wi's azimuth
    phi_o = torch.atan2(wi[..., 0], wi[..., 2]) + d_phi
    wo = torch.stack([torch.sin(phi_o) * cos_to, sin_to, torch.cos(phi_o) * cos_to], dim=-1)

    p = pdf(ctx, params, albedo, uv, wi, wo)
    f = eval(ctx, params, albedo, uv, wi, wo)
    w = f / torch.clamp(p, min=1e-20)[..., None]
    valid = (p > 0.0) & torch.all(torch.isfinite(w), dim=-1)
    return BsdfSample(
        wo=wo,
        weight=torch.where(valid[..., None], w, 0.0),
        pdf=p,
        lobe=torch.full((n,), LOBES, dtype=torch.int64, device=wi.device),
        valid=valid,
    )
