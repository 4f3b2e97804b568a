"""Participating media (torch): homogeneous, exponential, atmospheric and
voxel media with a pluggable generalized transmittance and phase function.

Port of tungsten_tpu/models/media/media.py (src/core/media/
HomogeneousMedium.cpp:66-110, ExponentialMedium.cpp, AtmosphericMedium.cpp,
VoxelMedium.cpp:97-186, Medium.hpp:22-76). A per-lane medium id (-1 =
vacuum) indexes the medium table; the reference's MediumState
{firstScatter, bounce} rides in two lane arrays (the non-exponential
four-case transmittance needs them).

Distance sampling is the reference's: the spectral channel by
nextDiscrete(3), the free-flight tau from the transmittance model scaled by
the channel's sigma_t, the spectral pdf averaged MIS-style, separate
surface / medium pdf cases. Heterogeneous media integrate their density
along the ray: closed forms for the exponential and atmospheric profiles
(torch.erf / torch.erfinv), the grid's exact cell walk (K6) for voxel media.
Each voxel grid's walk runs on the lanes its medium owns only (the JAX
package computes every lane and discards the others with `where`), and not
on vacuum lanes, whose results the caller never reads.

`pack_media_arrays` is the host half of `pack_media` (numpy), and
`MediumTable.from_arrays` builds the table on a device from it, or from
any table's fields read by name into the same dict.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..grids.grid import (DenseGrid, grid_density, grid_emission, grid_inverse_optical_depth,
                          grid_optical_depth, grid_spec_arrays)
from ..phase.phase import phase_id
from ..transmittance.transmittance import (_sigma_bar_full, trans_eval, trans_id,
                                           trans_medium_pdf, trans_sample, trans_surface_prob)

INF = 3.0e38

ARRAY_FIELDS = (  # MediumTable's arrays with their numpy types
    ("sigma_a", np.float32), ("sigma_s", np.float32), ("sigma_t", np.float32),
    ("absorption_only", np.bool_), ("phase_type", np.int64), ("phase_g", np.float32),
    ("trans_type", np.int64), ("trans_params", np.float32), ("max_bounce", np.int64),
    ("exp_dir", np.float32), ("exp_x0", np.float32), ("hetero_kind", np.int64),
    ("atm_center", np.float32), ("atm_s", np.float32), ("atm_r2", np.float32))
STATIC_FIELDS = ("n_media", "trans_present", "has_hetero", "vox_owner", "has_emissive_grid")


@dataclass
class MediumTable:
    sigma_a: torch.Tensor  # (K, 3)
    sigma_s: torch.Tensor  # (K, 3)
    sigma_t: torch.Tensor  # (K, 3)
    absorption_only: torch.Tensor  # (K,) bool
    phase_type: torch.Tensor  # (K,) int64
    phase_g: torch.Tensor  # (K,)
    trans_type: torch.Tensor  # (K,) int64
    trans_params: torch.Tensor  # (K, 8) [a, b, pulses] / the interpolated layout
    max_bounce: torch.Tensor  # (K,) int64
    exp_dir: torch.Tensor  # (K, 3) falloff_scale * unit falloff direction
    exp_x0: torch.Tensor  # (K,) exp_dir . unit_point
    hetero_kind: torch.Tensor  # (K,) 0 uniform, 1 exponential, 2 atmosphere, 3 voxel
    atm_center: torch.Tensor  # (K, 3)
    atm_s: torch.Tensor  # (K,) effective falloff scale (falloff / radius)
    atm_r2: torch.Tensor  # (K,) radius^2
    vox_grids: tuple = ()  # DenseGrid per voxel medium
    n_media: int = 0
    trans_present: tuple = ()
    has_hetero: bool = False
    vox_owner: tuple = ()  # grid -> medium id
    has_emissive_grid: bool = False

    @staticmethod
    def from_arrays(data: dict, device) -> "MediumTable":
        """From {"arrays": {ARRAY_FIELDS}, "statics": {STATIC_FIELDS},
        "grids": [(grid arrays, grid statics)]} (pack_media_arrays)."""
        arrays, statics = data["arrays"], data["statics"]
        t = {k: torch.as_tensor(np.array(arrays[k], dt), device=device) for k, dt in ARRAY_FIELDS}
        grids = tuple(DenseGrid.from_arrays(a, s, device) for a, s in data["grids"])
        s = {k: statics[k] for k in STATIC_FIELDS}
        s["trans_present"] = tuple(int(x) for x in s["trans_present"])
        s["vox_owner"] = tuple(int(x) for x in s["vox_owner"])
        return MediumTable(**t, vox_grids=grids, **s)


def pack_media_arrays(specs: List[dict], resolve=None, prim_origin=None) -> dict:
    """The host half of pack_media: the scene's media specs -> the dict
    from_arrays takes. Raises NotImplementedError with the JAX package's
    messages (an unknown medium type or transmittance model, pulse or
    interpolated children of an interpolated transmittance)."""
    k = max(len(specs), 1)
    sa = np.zeros((k, 3), np.float32)
    ss = np.zeros((k, 3), np.float32)
    pt = np.zeros(k, np.int32)
    pg = np.zeros(k, np.float32)
    tt = np.zeros(k, np.int32)
    tp = np.ones((k, 8), np.float32)
    mb = np.full(k, 1024, np.int32)
    ed = np.zeros((k, 3), np.float32)
    ex = np.zeros(k, np.float32)
    hk = np.zeros(k, np.int32)
    ac = np.zeros((k, 3), np.float32)
    asc = np.ones(k, np.float32)
    ar2 = np.ones(k, np.float32)
    grids, vox_owner = [], []
    for i, spec in enumerate(specs):
        mtype = spec.get("type", "homogeneous")
        if mtype == "exponential":
            # ExponentialMedium.cpp: density(p) = exp(-scale (p - unit) . dir)
            fdir = np.asarray(spec.get("falloff_direction", [0.0, 1.0, 0.0]), np.float64)
            fdir = fdir / max(np.linalg.norm(fdir), 1e-30)
            fs = float(spec.get("falloff_scale", 1.0))
            up = np.asarray(spec.get("unit_point", [0.0, 0.0, 0.0]), np.float64)
            if np.ndim(up) == 0:
                up = np.repeat(up, 3)
            ed[i] = (fs * fdir).astype(np.float32)
            ex[i] = float(np.dot(fs * fdir, up))
            hk[i] = 1
        elif mtype == "atmosphere":
            # AtmosphericMedium.cpp: density(p) = exp(-s^2 (|p - c|^2 - R^2)),
            # s = falloff_scale / radius; a "pivot" names a primitive whose
            # transform origin becomes the center (:63-70 prepareForRender)
            center = spec.get("center", [0.0, 0.0, 0.0])
            if "pivot" in spec:
                c = prim_origin(spec["pivot"]) if prim_origin else None
                if c is not None:
                    center = c
            r = float(spec.get("radius", 1.0))
            ac[i] = np.asarray(center, np.float32)
            asc[i] = float(spec.get("falloff_scale", 1.0)) / max(r, 1e-30)
            ar2[i] = r * r
            hk[i] = 2
        elif mtype == "voxel":
            # VoxelMedium.cpp:97-186: sigma_t scaled by the grid density,
            # distance sampling through Grid::inverseOpticalDepth
            grids.append(grid_spec_arrays(spec.get("grid", {}), resolve=resolve))
            vox_owner.append(i)
            hk[i] = 3
        elif mtype != "homogeneous":
            raise NotImplementedError(f"medium type '{mtype}' not implemented yet")
        density = spec.get("density", 1.0)

        def vec3(v, default=0.0):
            a = np.asarray(spec.get(v, default), np.float32).ravel()
            return np.repeat(a, 3) if a.size == 1 else a

        sa[i] = vec3("sigma_a") * density
        ss[i] = vec3("sigma_s") * density
        ph = spec.get("phase_function", {"type": "isotropic"})
        if isinstance(ph, str):
            ph = {"type": ph}
        pt[i] = phase_id(ph.get("type", "isotropic"))
        pg[i] = ph.get("g", 0.0)
        tr = spec.get("transmittance", {"type": "exponential"})
        if isinstance(tr, str):
            tr = {"type": tr}
        tt[i] = trans_id(tr.get("type", "exponential"))

        def base_params(trd):
            if trd.get("type") == "pulse":
                return [trd.get("min", 0.0), trd.get("max", 1.0), trd.get("num_pulses", 4)]
            if trd.get("type") == "davis_weinstein":
                return [float(np.clip(trd.get("h", 0.75), 0.5, 1.0)), trd.get("c", 1.0), 4.0]
            return [trd.get("sigma_a", trd.get("max_t", trd.get("rate", trd.get("alpha", 1.0)))),
                    trd.get("sigma_b", 1.0), 4.0]

        if tr.get("type") == "interpolated":
            # [u, typeA, typeB, paA, pbA, paB, pbB, -]; the defaults mirror
            # InterpolatedTransmittance(): linear + erlang, ratio 0.5
            tra = tr.get("tr_a", {"type": "linear"})
            trb = tr.get("tr_b", {"type": "erlang"})
            if isinstance(tra, str):
                tra = {"type": tra}
            if isinstance(trb, str):
                trb = {"type": trb}
            if tra.get("type") in ("pulse", "interpolated") or trb.get("type") in (
                    "pulse", "interpolated"):
                raise NotImplementedError(
                    "interpolated transmittance children limited to 2-param models")
            tp[i, 0] = tr.get("ratio", 0.5)
            tp[i, 1] = trans_id(tra.get("type", "linear"))
            tp[i, 2] = trans_id(trb.get("type", "erlang"))
            tp[i, 3:5] = base_params(tra)[:2]
            tp[i, 5:7] = base_params(trb)[:2]
        else:
            tp[i, 0:3] = base_params(tr)
        mb[i] = spec.get("max_bounces", 1024)
    arrays = dict(sigma_a=sa, sigma_s=ss, sigma_t=sa + ss, absorption_only=(ss == 0).all(axis=1),
                  phase_type=pt, phase_g=pg, trans_type=tt, trans_params=tp, max_bounce=mb,
                  exp_dir=ed, exp_x0=ex, hetero_kind=hk, atm_center=ac, atm_s=asc, atm_r2=ar2)
    statics = dict(n_media=len(specs), trans_present=tuple(sorted(set(int(x) for x in tt))),
                   has_hetero=bool((hk != 0).any()), vox_owner=tuple(vox_owner),
                   has_emissive_grid=any(s["has_emission"] for _, s in grids))
    return {"arrays": arrays, "statics": statics, "grids": grids}


def pack_media(specs: List[dict], resolve=None, prim_origin=None, *, device) -> MediumTable:
    """The medium table on `device`."""
    return MediumTable.from_arrays(pack_media_arrays(specs, resolve, prim_origin), device)


def _ray_falloff(media, i, o, d):
    """Per-lane line parameters: density(t) = exp(-(x + dx t))
    (ExponentialMedium.cpp:58-66); zero for homogeneous media."""
    fdir = media.exp_dir[i]
    x = torch.sum(o * fdir, dim=-1) - media.exp_x0[i]
    dx = torch.sum(d * fdir, dim=-1)
    return x, dx


def _dens_integral(x, dx, t):
    """int_0^t density ds (ExponentialMedium::densityIntegral); t when
    x = dx = 0."""
    small = torch.abs(dx) < 1e-12
    safe_dx = torch.where(small, 1.0, dx)
    inf = t >= 1e30
    fin = torch.where(small, torch.exp(-x) * t, (torch.exp(-x) - torch.exp(-dx * t - x)) / safe_dx)
    return torch.where(inf, torch.exp(-x) / safe_dx, fin)


def _inverse_optical_depth(x, dx, tau):
    """ExponentialMedium::inverseOpticalDepth; tau when x = dx = 0."""
    small = torch.abs(dx) < 1e-12
    safe_dx = torch.where(small, 1.0, dx)
    denom = 1.0 - dx * torch.exp(x) * tau
    t_gen = torch.where(denom <= 0.0, INF, -torch.log(torch.clamp(denom, min=1e-38)) / safe_dx)
    return torch.where(small, tau * torch.exp(x), t_gen)


def _hetero_ray(media, i, o, d, lanes=None):
    """Per-lane heterogeneous-profile line parameters. kind 1 (exponential):
    density(t) = exp(-(x + dx t)); kind 2 (atmosphere, AtmosphericMedium.cpp:
    94-124): in the shifted coordinate u = t + t0 (t0 the along-ray offset of
    the closest approach), density(u) = exp(-(eh + s^2 u^2)), eh = s^2 (h^2 -
    R^2); kind 3 (voxel, VoxelMedium.cpp:97-186): the grid's cell walk, the
    ray itself rides in hp. lanes: the lanes whose values are read (None:
    all); the grid walks skip the others."""
    kind = media.hetero_kind[i]
    x = torch.sum(o * media.exp_dir[i], dim=-1) - media.exp_x0[i]
    dx = torch.sum(d * media.exp_dir[i], dim=-1)
    pc = o - media.atm_center[i]
    t0 = torch.sum(pc * d, dim=-1)
    h2 = torch.clamp(torch.sum(pc * pc, dim=-1) - t0 * t0, min=0.0)
    sA = media.atm_s[i]
    eh = sA * sA * (h2 - media.atm_r2[i])
    return dict(kind=kind, x=x, dx=dx, t0=t0, s=sA, eh=eh, i=i, o=o, d=d, media=media,
                lanes=lanes)


_SQRT_PI = 1.7724538509055159
_INV_SQRT_PI = 0.5641895835477563


def _vox_lanes(hp, owner):
    """The lanes whose values the voxel medium `owner` supplies."""
    m = (hp["kind"] == 3) & (hp["i"] == owner)
    return m if hp["lanes"] is None else m & hp["lanes"]


def _hetero_integral(hp, t):
    """int_0^t density ds for the lane's profile; exact for t = inf."""
    i_exp = _dens_integral(hp["x"], hp["dx"], t)
    inf = t >= 1e30
    u1 = torch.where(inf, 0.0, hp["t0"] + t)
    e1 = torch.where(inf, 1.0, torch.erf(hp["s"] * u1))
    i_atm = ((_SQRT_PI * 0.5 / torch.clamp(hp["s"], min=1e-30))
             * torch.exp(-hp["eh"]) * (e1 - torch.erf(hp["s"] * hp["t0"])))
    out = torch.where(hp["kind"] == 2, i_atm, i_exp)
    media = hp["media"]
    for gi, owner in enumerate(media.vox_owner):
        sel = _vox_lanes(hp, owner)
        i_vox = grid_optical_depth(media.vox_grids[gi], hp["o"], hp["d"], torch.zeros_like(t),
                                   torch.clamp(t, max=1e30), mask=sel)
        out = torch.where(sel, i_vox, out)
    return out


def _hetero_density(hp, t):
    d_exp = torch.exp(-(hp["x"] + hp["dx"] * t))
    u = hp["t0"] + t
    d_atm = torch.exp(-(hp["eh"] + (hp["s"] * u) ** 2))
    out = torch.where(hp["kind"] == 2, d_atm, d_exp)
    media = hp["media"]
    for gi, owner in enumerate(media.vox_owner):
        p = hp["o"] + hp["d"] * t[..., None]
        d_vox = grid_density(media.vox_grids[gi], p)
        out = torch.where((hp["kind"] == 3) & (hp["i"] == owner), d_vox, out)
    return out


def _hetero_inverse(hp, tau):
    """The smallest t with int_0^t density = tau (INF when unreachable)."""
    t_exp = _inverse_optical_depth(hp["x"], hp["dx"], tau)
    inner = torch.erf(hp["s"] * hp["t0"]) + 2.0 * _INV_SQRT_PI * torch.exp(hp["eh"]) * hp["s"] * tau
    t_atm = torch.where(
        inner >= 1.0, INF,
        torch.erfinv(torch.clamp(inner, -1.0 + 1e-7, 1.0 - 1e-7))
        / torch.clamp(hp["s"], min=1e-30) - hp["t0"])
    out = torch.where(hp["kind"] == 2, t_atm, t_exp)
    media = hp["media"]
    for gi, owner in enumerate(media.vox_owner):
        sel = _vox_lanes(hp, owner)
        t_vox = grid_inverse_optical_depth(media.vox_grids[gi], hp["o"], hp["d"],
                                           torch.zeros_like(tau), torch.full_like(tau, 1e30),
                                           tau, mask=sel)
        out = torch.where(sel, t_vox, out)
    return out


def _hetero_far_ok(hp, far_t):
    """Absorption-only validity: exponential profiles diverge on infinite
    rays unless they decay; the gaussian atmosphere and grids integrate
    finitely."""
    ok_exp = (far_t < INF) | (hp["dx"] > 0.0)
    bounded = (hp["kind"] == 2) | (hp["kind"] == 3)
    return torch.where(bounded, True, torch.where(hp["kind"] == 1, ok_exp, far_t < INF))


@dataclass
class MediumSample:
    t: torch.Tensor  # (N,) sampled distance (= far_t where it exited)
    weight: torch.Tensor  # (N, 3) throughput factor
    pdf: torch.Tensor  # (N,)
    exited: torch.Tensor  # (N,) bool: reached the surface
    scattered: torch.Tensor  # (N,) bool: a scatter event inside the medium
    p: torch.Tensor  # (N, 3)
    emission: torch.Tensor = None  # (N, 3) grid emission at the scatter point
    # the continued free flight (ignoring far_t), for photon planes
    # (HomogeneousMedium.cpp:86-100 continuedT / continuedWeight)
    continued_t: torch.Tensor = None  # (N,)
    continued_weight: torch.Tensor = None  # (N, 3)


def medium_sample_distance(media: MediumTable, mid, o, d, far_t, first_scatter, med_bounce,
                           u_comp, u_dist, u_b, want_continued=False):
    """HomogeneousMedium::sampleDistance, batched. mid (N,) medium ids (lanes
    with mid < 0 are vacuum: exited with weight 1). With want_continued the
    sample also carries the UNBOUNDED free flight (continuedT) and its
    as-if-scattered weight (continuedWeight), for photon-plane deposits."""
    i = torch.clamp(mid, min=0)
    sigma_t = media.sigma_t[i]
    sigma_s = media.sigma_s[i]
    ttype = media.trans_type[i]
    tparams = media.trans_params[i]
    abs_only = media.absorption_only[i]
    in_medium = mid >= 0
    present = media.trans_present

    # spectral channel choice
    comp = torch.clamp((u_comp * 3).to(torch.int64), max=2)
    sigma_tc = torch.gather(sigma_t, 1, comp[:, None])[:, 0]

    tau_sample = trans_sample(ttype, tparams, u_dist, u_b, first_scatter, present=present)
    if media.has_hetero:
        # heterogeneous density along the ray (ExponentialMedium /
        # AtmosphericMedium / VoxelMedium sampleDistance)
        hp = _hetero_ray(media, i, o, d, lanes=in_medium)
        t_free = _hetero_inverse(hp, tau_sample / torch.clamp(sigma_tc, min=1e-20))
        exited = t_free >= far_t
        t = torch.minimum(t_free, far_t)
        tau = _hetero_integral(hp, t)[..., None] * sigma_t
        rho = _hetero_density(hp, t)
    else:
        t_free = tau_sample / torch.clamp(sigma_tc, min=1e-20)
        exited = t_free >= far_t
        t = torch.minimum(t_free, far_t)
        tau = t[..., None] * sigma_t
        rho = torch.ones_like(t)
    sbar = _sigma_bar_full(ttype, tparams, present)

    w_trans = trans_eval(ttype, tparams, tau, first_scatter, exited, present=present)
    pdf_exit = torch.mean(trans_surface_prob(ttype, tparams, tau, first_scatter, present=present),
                          dim=-1)
    pdf_scatter = rho * torch.mean(
        sigma_t * trans_medium_pdf(ttype, tparams, tau, first_scatter, present=present), dim=-1)
    pdf = torch.where(exited, pdf_exit, pdf_scatter)
    w = torch.where(exited[..., None], w_trans, w_trans * rho[..., None] * sigma_s * sbar[..., None])
    w = w / torch.clamp(pdf, min=1e-30)[..., None]
    # emission takes the PRE-scatter weight: trans_eval / pdf only, without
    # the rho sigma_s sigma_bar factor (VoxelMedium.cpp:142-145 order)
    w_emis = w_trans / torch.clamp(pdf, min=1e-30)[..., None]

    # absorption-only media never scatter: the deterministic transmittance
    # to far_t
    if media.has_hetero:
        far_finite = _hetero_far_ok(hp, far_t)  # decaying profiles: finite on infinite rays
        hp_abs = dict(hp, lanes=in_medium & abs_only)
        tau_abs = _hetero_integral(hp_abs, far_t)[..., None] * sigma_t
    else:
        far_finite = far_t < INF
        tau_abs = far_t[..., None] * sigma_t
    w_abs = trans_eval(ttype, tparams, tau_abs, first_scatter, torch.ones_like(exited),
                       present=present)
    t = torch.where(abs_only, far_t, t)
    w = torch.where(abs_only[..., None], w_abs, w)
    pdf = torch.where(abs_only, 1.0, pdf)
    exited = torch.where(abs_only, True, exited)
    # absorption-only + an infinite ray: invalid (the reference returns false)
    valid = in_medium & torch.where(abs_only, far_finite, True)
    # the max_bounce cut (the reference returns false: the path ends)
    valid = valid & (med_bounce <= media.max_bounce[i])

    # vacuum lanes pass through
    t = torch.where(in_medium, t, far_t)
    w = torch.where(in_medium[..., None], w, 1.0)
    exited = exited | ~in_medium
    scattered = in_medium & ~exited & valid & ~abs_only

    p_end = o + d * t[..., None]
    w_final = torch.where(valid[..., None], w, torch.where(in_medium[..., None], 0.0, 1.0))
    # VoxelMedium.cpp:142: emission = the grid's emission at the scatter
    # point times the (pdf-normalized) path weight
    emission = torch.zeros_like(w_final)
    if media.has_emissive_grid:
        for gi, owner in enumerate(media.vox_owner):
            g = media.vox_grids[gi]
            if not g.has_emission:
                continue
            e = grid_emission(g, p_end) * torch.where(valid[..., None], w_emis, 0.0)
            emission = torch.where((scattered & (i == owner))[..., None], e, emission)
    cont_t = cont_w = None
    if want_continued:
        # continuedT / continuedWeight (HomogeneousMedium.cpp:86-100): the
        # unbounded free flight with its scatter weight, the transmittance
        # taking the REALIZED sample's exited flag, as the reference does
        finite_c = (t_free < INF) & in_medium & ~abs_only & valid
        t_c = torch.where(finite_c, t_free, 0.0)
        if media.has_hetero:
            hp_c = dict(hp, lanes=finite_c)
            tau_c = _hetero_integral(hp_c, t_c)[..., None] * sigma_t
            rho_c = _hetero_density(hp, t_c)
        else:
            tau_c = t_c[..., None] * sigma_t
            rho_c = torch.ones_like(t_c)
        w_tc = trans_eval(ttype, tparams, tau_c, first_scatter, exited, present=present)
        pdf_c = rho_c * torch.mean(
            sigma_t * trans_medium_pdf(ttype, tparams, tau_c, first_scatter, present=present),
            dim=-1)
        cw = (w_tc * rho_c[..., None] * sigma_s * sbar[..., None]
              / torch.clamp(pdf_c, min=1e-30)[..., None])
        cont_t = t_c
        cont_w = torch.where(finite_c[..., None], cw, 0.0)
        cont_w = torch.where(torch.isfinite(cont_w), cont_w, 0.0)
    return MediumSample(t=t, weight=w_final, pdf=pdf, exited=exited & valid | ~in_medium,
                        scattered=scattered, p=p_end, emission=emission, continued_t=cont_t,
                        continued_weight=cont_w)


def medium_distance_pdf(media: MediumTable, mid, o, d, t, start_on_surface, end_on_surface):
    """Medium::pdf: the density of the distance sampler producing a segment
    of length t along (o, d), given the endpoint types (BDPT folds the
    reverse edges' medium pdfs into its MIS products, PathVertex.cpp:161-163,
    LightPath.cpp:66-71). Vacuum lanes return 1."""
    i = torch.clamp(mid, min=0)
    sigma_t = media.sigma_t[i]
    ttype = media.trans_type[i]
    tparams = media.trans_params[i]
    present = media.trans_present
    if media.has_hetero:
        hp = _hetero_ray(media, i, o, d, lanes=mid >= 0)
        tau = _hetero_integral(hp, t)[..., None] * sigma_t
        rho = _hetero_density(hp, t)
    else:
        tau = torch.clamp(t, max=1e30)[..., None] * sigma_t
        rho = torch.ones_like(t)
    pdf_exit = torch.mean(trans_surface_prob(ttype, tparams, tau, start_on_surface,
                                             present=present), dim=-1)
    pdf_scatter = rho * torch.mean(
        sigma_t * trans_medium_pdf(ttype, tparams, tau, start_on_surface, present=present),
        dim=-1)
    pdf = torch.where(end_on_surface, pdf_exit, pdf_scatter)
    pdf = torch.where(media.absorption_only[i], 1.0, pdf)
    return torch.where(mid >= 0, pdf, 1.0)


def medium_transmittance(media: MediumTable, mid, far_t, start_on_surface, end_on_surface,
                         o=None, d=None):
    """Medium::transmittance of shadow segments; mid < 0 -> 1. o / d enable
    the heterogeneous line integral (homogeneous tables ignore them)."""
    i = torch.clamp(mid, min=0)
    sigma_t = media.sigma_t[i]
    ttype = media.trans_type[i]
    tparams = media.trans_params[i]
    infinite = far_t >= INF
    if media.has_hetero and o is not None:
        hp = _hetero_ray(media, i, o, d, lanes=mid >= 0)
        tau = _hetero_integral(hp, far_t)[..., None] * sigma_t
        infinite = infinite & ~_hetero_far_ok(hp, far_t)
    else:
        tau = torch.clamp(far_t, max=1e30)[..., None] * sigma_t
    tr = trans_eval(ttype, tparams, tau, start_on_surface, end_on_surface,
                    present=media.trans_present)
    tr = torch.where(infinite[..., None], 0.0, tr)
    return torch.where((mid >= 0)[..., None], tr, 1.0)
