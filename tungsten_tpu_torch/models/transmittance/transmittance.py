"""Generalized (non-exponential) free-flight transmittance (torch).

Port of tungsten_tpu/models/transmittance/transmittance.py, the Bitterli
non-exponential transport family (src/core/transmittances/). A segment's
transmittance depends on whether its endpoints are on surfaces or at
medium scatter events; the four cases are

    surface->surface: surfaceSurface(tau)
    medium->medium:   mediumMedium(tau) / sigmaBar
    mixed:            mediumSurface(tau)

Models (type ids as in the JAX module): exponential 0, double_exponential 1,
quadratic 2, linear 3, erlang 4, davis 5, pulse 6, davis_weinstein 7,
interpolated 8 (one level of two-parameter children). Batched over lanes
with a per-lane type and parameter row (the medium table's):

    double_exponential [sigma_a, sigma_b]; quadratic / linear [max_t];
    erlang [rate]; davis [alpha]; pulse [min, max, pulses];
    davis_weinstein [h, c]; interpolated [u, typeA, typeB, paA, pbA, paB, pbB, -].

Every function evaluates in the JAX module's order, with its iteration
counts (the 42 bisection rounds of davis_weinstein, the 10 Newton steps of
erlang), since the sample is sensitive to both. `present` (the static set of
types a scene holds) lets `_cases` skip the formulas of absent types: a
lane only ever reads its own type's formula, so no value changes.
"""
from __future__ import annotations

import torch

T_EXPONENTIAL = 0
T_DOUBLE_EXPONENTIAL = 1
T_QUADRATIC = 2
T_LINEAR = 3
T_ERLANG = 4
T_DAVIS = 5
T_PULSE = 6
T_DAVIS_WEINSTEIN = 7
T_INTERPOLATED = 8

_NAMES = {
    "exponential": T_EXPONENTIAL,
    "double_exponential": T_DOUBLE_EXPONENTIAL,
    "quadratic": T_QUADRATIC,
    "linear": T_LINEAR,
    "erlang": T_ERLANG,
    "davis": T_DAVIS,
    "pulse": T_PULSE,
    "davis_weinstein": T_DAVIS_WEINSTEIN,
    "interpolated": T_INTERPOLATED,
}

MAX_PULSES = 8


def trans_id(name: str) -> int:
    if name not in _NAMES:
        raise NotImplementedError(f"transmittance model '{name}' not implemented yet")
    return _NAMES[name]


def _fin(x):
    return torch.where(torch.isfinite(x), x, 0.0)


def _dw_cases(pa, pb, tau):
    """davis_weinstein (DavisWeinsteinTransmittance.cpp): a tau-dependent
    alpha -> (ss, sm, mm)."""
    dw_t = torch.clamp(tau, min=1e-6)
    dw_beta = 2.0 * pa - 1.0
    dw_alpha = torch.pow(dw_t, 1.0 - dw_beta) / torch.pow(torch.clamp(pb, min=1e-6),
                                                          1.0 + dw_beta)
    dw_alpha = torch.clamp(dw_alpha, min=1e-8)
    dw_base = 1.0 + dw_t / dw_alpha
    dw_log = torch.log(dw_base)
    dw_ss = torch.pow(dw_base, -dw_alpha)
    dw_sm = dw_ss * (dw_beta / dw_base - (dw_beta - 1.0) * dw_alpha / dw_t * dw_log)
    dw_term1 = dw_beta * (
        -1.0 + dw_beta * (1.0 + dw_t) + (-1.0 + 2.0 * dw_beta) * dw_t / dw_alpha
    ) / (dw_t * dw_base * dw_base)
    dw_term2 = (
        (-1.0 + dw_beta) * dw_beta * dw_alpha / (dw_t * dw_t)
        * (2.0 * dw_t + dw_base) * dw_log
    ) / dw_base
    dw_term3 = (dw_beta - 1.0) * dw_alpha / dw_t * dw_log
    dw_mm = dw_ss * (dw_term1 - dw_term2 + dw_term3 * dw_term3)
    return _fin(dw_ss), _fin(dw_sm), _fin(dw_mm)


def _cases(ttype, pa, pb, tau, pc=4.0, present=None):
    """The four case values {"ss", "sm", "ms", "mm"}, each (N, 3).
    pa / pb / pc: (N, 1). present: None (every formula) or the static set of
    types whose formulas are computed (exponential always is)."""
    def has(t):
        return present is None or t in present

    e = torch.exp(-tau)
    out = {k: e for k in ("ss", "sm", "ms", "mm")}

    def put(t, ss, sm, ms, mm):
        sel = ttype == t
        for k, v in (("ss", ss), ("sm", sm), ("ms", ms), ("mm", mm)):
            out[k] = torch.where(sel, v, out[k])

    if has(T_DOUBLE_EXPONENTIAL):
        ea, eb = torch.exp(-pa * tau), torch.exp(-pb * tau)
        put(T_DOUBLE_EXPONENTIAL, 0.5 * (ea + eb), 0.5 * (pa * ea + pb * eb),
            (pa * ea + pb * eb) / (pa + pb), (pa * pa * ea + pb * pb * eb) / (pa + pb))
    if has(T_QUADRATIC):
        tq = torch.clamp(tau / pa, max=1.0)
        put(T_QUADRATIC, 1.0 - 2.0 * tq + tq * tq, (2.0 / pa) * (1.0 - tq), 1.0 - tq,
            torch.where(tau > pa, 0.0, 1.0 / pa))
    if has(T_LINEAR):
        put(T_LINEAR, 1.0 - torch.clamp(tau / pa, max=1.0),
            torch.where(tau > pa, 0.0, 1.0 / pa), torch.where(tau > pa, 0.0, 1.0),
            torch.where(torch.abs(tau - pa) < 1e-3, 1.0, 0.0))
    if has(T_ERLANG):
        lam = pa
        er_ss = 0.5 * torch.exp(-lam * tau) * (2.0 + lam * tau)
        er_ms = torch.exp(-lam * tau) * (1.0 + lam * tau)
        er_sm = er_ms * lam * 0.5
        er_mm = lam * lam * tau * torch.exp(-lam * tau)
        put(T_ERLANG, er_ss, er_sm, er_ms, er_mm)
    if has(T_DAVIS):
        al = pa
        d_ss = torch.pow(1.0 + tau / al, -al)
        d_sm = torch.pow(1.0 + tau / al, -(al + 1.0))
        d_mm = (1.0 + 1.0 / al) * torch.pow(1.0 + tau / al, -(al + 2.0))
        put(T_DAVIS, d_ss, d_sm, d_sm, d_mm)
    if has(T_PULSE):
        # PulseTransmittance.cpp: a piecewise-linear comb, dirac mm
        npul = pc
        rel = (tau - pa) / torch.clamp(pb - pa, min=1e-20)
        idx_f = _clip_n(npul * rel + 0.5, npul)
        idx = torch.floor(idx_f)
        height = (npul - idx) / npul
        cell = height * (idx_f - idx)
        cell = torch.where(idx > 0, cell + (idx - 0.5) - (idx * (idx - 1.0)) / (2.0 * npul),
                           cell - 0.5)
        p_ss = 1.0 - (2.0 / npul) * cell
        idx_ms = _clip_n(torch.floor(npul * rel + 0.5), npul)
        p_ms = 1.0 - idx_ms / npul
        p_sm = 2.0 / torch.clamp(pb - pa, min=1e-20) * p_ms
        idx_mm_f = _clip_n(npul * rel, npul)
        p_mm = (1.0 / npul) * torch.where(
            torch.abs(idx_mm_f - torch.floor(idx_mm_f) - 0.5) < 1e-3, 1.0, 0.0)
        put(T_PULSE, p_ss, p_sm, p_ms, p_mm)
    if has(T_DAVIS_WEINSTEIN):
        dw_ss, dw_sm, dw_mm = _dw_cases(pa, pb, tau)
        put(T_DAVIS_WEINSTEIN, dw_ss, dw_sm, dw_sm, dw_mm)
    return out


def _clip_n(x, n):
    """jnp.clip(x, 0, n) with n a number or a tensor."""
    x = torch.clamp(x, min=0.0)
    return torch.minimum(x, n.expand_as(x)) if torch.is_tensor(n) else torch.clamp(x, max=n)


def _interp_blend(params, tau, key):
    """Interpolated transmittance (InterpolatedTransmittance.cpp): the lerp
    of two two-parameter children; the mm case takes the dirac-xor rule."""
    u = params[..., 0:1]
    tA = params[..., 1:2].to(torch.int32)
    tB = params[..., 2:3].to(torch.int32)
    cA = _cases(tA, params[..., 3:4], params[..., 4:5], tau)
    cB = _cases(tB, params[..., 5:6], params[..., 6:7], tau)
    a, b = cA[key], cB[key]
    if key == "ss":
        sbarA = trans_sigma_bar(tA[..., 0], params[..., 3:5])[..., None]
        sbarB = trans_sigma_bar(tB[..., 0], params[..., 5:7])[..., None]
        sbar = 1.0 / ((1.0 - u) / sbarA + u / sbarB)
        return sbar * ((1.0 - u) * a / sbarA + u * b / sbarB)
    if key == "mm":
        diracA = ((tA == T_LINEAR) | (tA == T_PULSE)) & (a > 0.0)
        diracB = ((tB == T_LINEAR) | (tB == T_PULSE)) & (b > 0.0)
        lin = (1.0 - u) * a + u * b
        one = torch.where(diracA, a, b)
        return torch.where(diracA ^ diracB, one, lin)
    if key == "sm":  # surfaceMedium = mediumSurface * sigmaBar
        ms = (1.0 - u) * cA["ms"] + u * cB["ms"]
        sbarA = trans_sigma_bar(tA[..., 0], params[..., 3:5])[..., None]
        sbarB = trans_sigma_bar(tB[..., 0], params[..., 5:7])[..., None]
        sbar = 1.0 / ((1.0 - u) / sbarA + u / sbarB)
        return ms * sbar
    return (1.0 - u) * a + u * b  # ms


def _apply_interp(ttype, params, tau, cases, present):
    if present is not None and T_INTERPOLATED not in present:
        return cases
    is_i = (ttype[..., None] if ttype.dim() < tau.dim() else ttype) == T_INTERPOLATED
    return {key: torch.where(is_i, _interp_blend(params, tau, key), val)
            for key, val in cases.items()}


def trans_sigma_bar(ttype, params):
    pa = params[..., 0]
    pb = params[..., 1]
    out = torch.ones_like(pa)  # exponential, davis
    out = torch.where(ttype == T_DOUBLE_EXPONENTIAL, 0.5 * (pa + pb), out)
    out = torch.where(ttype == T_QUADRATIC, 2.0 / pa, out)
    out = torch.where(ttype == T_LINEAR, 1.0 / pa, out)
    out = torch.where(ttype == T_ERLANG, pa * 0.5, out)
    out = torch.where(ttype == T_PULSE, 2.0 / torch.clamp(pb - pa, min=1e-20), out)
    return out


def _sigma_bar_full(ttype, params, present=None):
    out = trans_sigma_bar(ttype, params)
    if present is None or T_INTERPOLATED in present:
        u = params[..., 0]
        sA = trans_sigma_bar(params[..., 1].to(torch.int32), params[..., 3:5])
        sB = trans_sigma_bar(params[..., 2].to(torch.int32), params[..., 5:7])
        si = 1.0 / ((1.0 - u) / sA + u / sB)
        out = torch.where(ttype == T_INTERPOLATED, si, out)
    return out


def _all_cases(ttype, params, tau, present):
    c = _cases(ttype[..., None], params[..., 0:1], params[..., 1:2], tau, params[..., 2:3],
               present=present)
    return _apply_interp(ttype[..., None], params, tau, c, present)


def trans_eval(ttype, params, tau, start_on_surface, end_on_surface, present=None):
    """Transmittance.eval: tau (N, 3), the flags (N,) bool."""
    c = _all_cases(ttype, params, tau, present)
    sbar = _sigma_bar_full(ttype, params, present)[..., None]
    both_s = (start_on_surface & end_on_surface)[..., None]
    both_m = (~start_on_surface & ~end_on_surface)[..., None]
    return torch.where(both_s, c["ss"], torch.where(both_m, c["mm"] / sbar, c["ms"]))


def trans_surface_prob(ttype, params, tau, start_on_surface, present=None):
    c = _all_cases(ttype, params, tau, present)
    return torch.where(start_on_surface[..., None], c["ss"], c["ms"])


def trans_medium_pdf(ttype, params, tau, start_on_surface, present=None):
    c = _all_cases(ttype, params, tau, present)
    return torch.where(start_on_surface[..., None], c["sm"], c["mm"])


def _bisect_sample(cdf_fn, u, iters=42):
    """The reference's bisection sampler (DavisWeinsteinTransmittance.cpp:
    86-117): 42 halvings from step 1e6 bracket tau to ~1e-6."""
    step = torch.full_like(u, 1e6)
    x = torch.full_like(u, 2e6)
    for _ in range(iters):
        x = torch.where(cdf_fn(x) > u, x - step, x + step)
        step = step * 0.5
    return x


def trans_sample(ttype, params, u, u_b, start_on_surface, present=None):
    """Free-flight tau sample (unitless optical depth). u, u_b: uniforms."""
    pa = params[..., 0]
    pb = params[..., 1]
    u = torch.clamp(u, 1e-7, 1.0 - 1e-7)
    t_exp = -torch.log1p(-u)

    # double exponential: from a surface pick a / b evenly, from a medium
    # in proportion to sigma
    p_pick = torch.where(start_on_surface, 0.5, pa / (pa + pb))
    t_de = torch.where(u_b < p_pick, t_exp / pa, t_exp / pb)

    t_q = torch.where(start_on_surface, pa * (1.0 - torch.sqrt(1.0 - u)), pa * u)
    t_l = torch.where(start_on_surface, pa * u, pa)

    # erlang: from a surface 10 Newton steps (the reference's); from a
    # medium -log(u1 u2) / lambda
    lam = pa

    def erlang_newton(u):
        x = torch.full_like(u, 0.5)
        for _ in range(10):
            ss = 0.5 * torch.exp(-lam * x) * (2.0 + lam * x)
            sm = torch.exp(-lam * x) * (1.0 + lam * x) * lam * 0.5
            x = torch.clamp(x + (u - (1.0 - ss)) / torch.clamp(sm, min=1e-20), min=0.0)
        return x

    u2c = torch.clamp(u_b, 1e-7, 1.0)
    t_er = torch.where(start_on_surface, erlang_newton(u), -torch.log(u * u2c) / lam)

    al = pa
    t_dv = torch.where(start_on_surface,
                       al * (torch.pow(1.0 - u, -1.0 / al) - 1.0),
                       al * (torch.pow(1.0 - u, -1.0 / (1.0 + al)) - 1.0))

    # pulse: a piecewise-constant comb (PulseTransmittance::sampleSurface /
    # sampleMedium), unrolled over MAX_PULSES with masks
    a = params[..., 0]
    b = params[..., 1]
    npul = params[..., 2]
    delta = 1.0 / torch.clamp(npul, min=1.0)
    xi = u * npul * 0.5
    t_pu_s = torch.zeros_like(u)
    found = torch.zeros_like(u, dtype=torch.bool)
    for i in range(MAX_PULSES):
        h0 = 1.0 - i * delta
        h1 = 1.0 - (i + 1.0) * delta
        in_range = i < npul
        hit0 = ~found & in_range & (xi - h0 * 0.5 < 0.0)
        t_pu_s = torch.where(hit0, a + (i + 0.5 * u_b) * (b - a) * delta, t_pu_s)
        found = found | hit0
        xi = torch.where(~found & in_range, xi - h0 * 0.5, xi)
        hit1 = ~found & in_range & (xi - h1 * 0.5 < 0.0)
        t_pu_s = torch.where(hit1, a + (i + 0.5 + 0.5 * u_b) * (b - a) * delta, t_pu_s)
        found = found | hit1
        xi = torch.where(~found & in_range, xi - h1 * 0.5, xi)
    t_pu_m = a + (0.5 + torch.floor(u * npul)) * delta * (b - a)
    t_pu = torch.where(start_on_surface, t_pu_s, t_pu_m)

    out = t_exp
    out = torch.where(ttype == T_DOUBLE_EXPONENTIAL, t_de, out)
    out = torch.where(ttype == T_QUADRATIC, t_q, out)
    out = torch.where(ttype == T_LINEAR, t_l, out)
    out = torch.where(ttype == T_ERLANG, t_er, out)
    out = torch.where(ttype == T_DAVIS, t_dv, out)
    out = torch.where(ttype == T_PULSE, t_pu, out)

    if present is None or T_DAVIS_WEINSTEIN in present:
        # no analytic inverse: bisection on the exact cdf (reference parity)
        h = params[..., 0:1]
        cdw = params[..., 1:2]

        def cdf(x):
            dw_ss, dw_sm, _ = _dw_cases(h, cdw, x[..., None])
            tr = torch.where(start_on_surface[..., None], dw_ss, dw_sm)
            return 1.0 - tr[..., 0]

        t_dw = _bisect_sample(cdf, u)
        out = torch.where(ttype == T_DAVIS_WEINSTEIN, t_dw, out)

    if present is None or T_INTERPOLATED in present:
        # pick a child by the ratio, then sample it (InterpolatedTransmittance
        # sampleSurface / sampleMedium nextBoolean(u))
        ui = params[..., 0]
        pick_b = u_b < ui
        ct = torch.where(pick_b, params[..., 2], params[..., 1]).to(torch.int32)
        cp = torch.where(pick_b[..., None], params[..., 5:7], params[..., 3:5])
        cp = torch.cat([cp, torch.full(cp.shape[:-1] + (1,), 4.0, device=cp.device)], dim=-1)
        # a fresh uniform for the child's draw (u_b was consumed)
        u_c = torch.abs(u_b * 7919.0) % 1.0
        t_in = trans_sample(ct, cp, u, u_c, start_on_surface, present=())
        out = torch.where(ttype == T_INTERPOLATED, t_in, out)
    return out
