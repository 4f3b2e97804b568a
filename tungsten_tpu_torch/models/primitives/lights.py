"""Light sampling on torch tensors: area lights (triangle sets) and the env.

Port of tungsten_tpu/models/primitives/lights.py for the light kinds the
port's flatten takes:
 - area lights (emissive meshes, quads, cubes): area-weighted triangle pick
   by a strided CDF search, uniform barycentric point, one-sided,
   pdf = r^2 / (cos * total area) (TriangleMesh.cpp sampleDirect / directPdf);
 - one infinite sphere: lat-long importance sampling of the emission bitmap
   (or uniform-sphere sampling of a constant env), pdf = pdf_uv /
   (2 pi^2 sin theta) (InfiniteSphere.cpp:27-50,161-229);
 - the light choice by approximate received radiance (TraceBase::chooseLight)
   for the kinds `quad`, `const` and `none`.
Point lights, cap lights, several env lights (with `escape_winner`) and
emissive analytic prims are not ported; scene/flatten.py refuses them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ...math import vecops as vo
from ...sampling import warps
from ...sampling.distributions import searchsorted_strided
from ..textures.textures import eval_texture

INF = 3.0e38


@dataclass
class LightSample:
    d: torch.Tensor  # (N, 3) direction from shading point to light
    dist: torch.Tensor  # (N,)
    pdf: torch.Tensor  # (N,) solid-angle pdf
    radiance: torch.Tensor  # (N, 3)
    valid: torch.Tensor  # (N,) bool


def _env_may(env):
    return (env.tex_kind,) if env.tex_kind >= 0 else None


def _env_tex(env, shape, device):
    return torch.full(shape, env.tex, dtype=torch.int64, device=device)


def direction_to_uv(env, d):
    """World direction -> lat-long uv + sinTheta (InfiniteSphere.cpp:33-38)."""
    w = d @ env.inv_rot.T
    sin_theta = torch.sqrt(torch.clamp(1.0 - w[..., 1] * w[..., 1], min=0.0))
    u = torch.atan2(w[..., 2], w[..., 0]) * warps.INV_TWO_PI + 0.5
    v = torch.acos(torch.clamp(-w[..., 1], -1.0, 1.0)) * warps.INV_PI
    return torch.stack([u, v], dim=-1), sin_theta


def uv_to_direction(env, uv):
    phi = (uv[..., 0] - 0.5) * (2.0 * math.pi)
    theta = uv[..., 1] * math.pi
    sin_theta = torch.sin(theta)
    local = torch.stack(
        [torch.cos(phi) * sin_theta, -torch.cos(theta), torch.sin(phi) * sin_theta], dim=-1)
    return local @ env.rot.T, sin_theta


def env_radiance(scene, d):
    """Emission of the env seen along escape direction d."""
    uv, _ = direction_to_uv(scene.env, d)
    return eval_texture(scene.textures, _env_tex(scene.env, d.shape[:-1], d.device), uv,
                        may=_env_may(scene.env))


def env_direct_pdf(scene, d):
    """Solid-angle pdf of the env's sampleDirect for direction d."""
    if scene.meta.env_is_constant:
        return torch.full(d.shape[:-1], warps.INV_FOUR_PI, dtype=torch.float32, device=d.device)
    env = scene.env
    h, w = env.dist.shape
    uv, sin_theta = direction_to_uv(env, d)
    x = torch.clamp((uv[..., 0] * w).to(torch.int64), 0, w - 1)
    row = torch.clamp(((1.0 - uv[..., 1]) * h).to(torch.int64), 0, h - 1)
    pdf_uv = env.dist.prob(x, row) * (w * h)
    return torch.where(
        sin_theta > 1e-6,
        pdf_uv * warps.INV_PI * warps.INV_TWO_PI / torch.clamp(sin_theta, min=1e-6), 0.0)


def sample_env_direct(scene, li, u2) -> LightSample:
    """sampleDirect of the env light chosen at light index li (N,). The
    port takes one env light, so li picks nothing here."""
    env = scene.env
    n = u2.shape[0]
    dev = u2.device
    if scene.meta.env_is_constant:
        d = warps.uniform_sphere(u2)
        uv, _ = direction_to_uv(env, d)
        rad = eval_texture(scene.textures, _env_tex(env, (n,), dev), uv, may=_env_may(env))
        return LightSample(
            d=d, dist=torch.full((n,), INF, device=dev),
            pdf=torch.full((n,), warps.INV_FOUR_PI, device=dev),
            radiance=rad, valid=torch.ones((n,), dtype=torch.bool, device=dev),
        )
    h, w = env.dist.shape
    x, row, pdf_d, uvr = env.dist.sample(u2)
    # BitmapTexture::sample: u = (vx + x)/w, v = 1 - (vy + row)/h
    uv = torch.stack([(uvr[..., 0] + x) / w, 1.0 - (uvr[..., 1] + row) / h], dim=-1)
    d, sin_theta = uv_to_direction(env, uv)
    pdf = pdf_d * (w * h) * warps.INV_PI * warps.INV_TWO_PI / torch.clamp(sin_theta, min=1e-6)
    rad = eval_texture(scene.textures, _env_tex(env, (n,), dev), uv, may=_env_may(env))
    return LightSample(
        d=d, dist=torch.full((n,), INF, device=dev), pdf=pdf, radiance=rad,
        valid=(sin_theta > 1e-6) & (pdf > 0.0),
    )


def _merge_ls(sel, a: LightSample, b: LightSample) -> LightSample:
    return LightSample(
        d=vo.where3(sel, a.d, b.d),
        dist=torch.where(sel, a.dist, b.dist),
        pdf=torch.where(sel, a.pdf, b.pdf),
        radiance=vo.where3(sel, a.radiance, b.radiance),
        valid=torch.where(sel, a.valid, b.valid),
    )


def infinite_radiance(scene, d):
    """Emission seen by an escaped ray: the env's (the port has no caps),
    zero without an env."""
    if not scene.meta.has_env:
        return torch.zeros(d.shape[:-1] + (3,), device=d.device)
    return env_radiance(scene, d)


def infinite_needs_escape_add(scene, d, was_specular):
    """Lanes whose escape emission is NOT covered by the NEE/MIS machinery:
    light sampling off, a specular prior bounce, or an unsamplable env."""
    meta = scene.meta
    if not meta.enable_light_sampling or (meta.has_env and meta.env_light_index < 0):
        return torch.ones(d.shape[:-1], dtype=torch.bool, device=d.device)
    return was_specular


def any_infinite_sampled(meta) -> bool:
    """True when the escape-winning infinite light has a light row."""
    return any(i >= 0 for i in meta.env_light_idx)


def infinite_winner_pdf(scene, d):
    """Direct-sampling pdf of the env for escape direction d (0 when there
    is no samplable env, which makes the MIS weight 1)."""
    meta = scene.meta
    if not (meta.has_env and meta.env_light_index >= 0):
        return torch.zeros(d.shape[:-1], device=d.device)
    return env_direct_pdf(scene, d)


def chosen_infinite_eval(scene, li, d):
    """bsdf-strategy target eval for a CHOSEN infinite light: estimateDirect
    intersects the chosen light primitive itself (TraceBase.cpp:286-319).
    Returns (match, radiance, pdf): match where li is the samplable env (it
    is hit by every direction), False for area choices."""
    meta = scene.meta
    shp = d.shape[:-1]
    if not any_infinite_sampled(meta):
        z = torch.zeros(shp, device=d.device)
        return z.bool(), torch.zeros(shp + (3,), device=d.device), z
    sel = li == meta.env_light_idx[0]
    uv, _ = direction_to_uv(scene.env, d)
    rad = eval_texture(scene.textures, _env_tex(scene.env, shp, d.device), uv)
    return (sel, torch.where(sel[..., None], rad, 0.0),
            torch.where(sel, env_direct_pdf(scene, d), 0.0))


def _quad_solid_angle(p, base, e0, e1):
    """Solid angle of the (base, e0, e1) parallelogram seen from p by the
    spherical-excess formula (Quad.cpp:256-281)."""
    r0 = base - p
    r1 = r0 + e0
    r2 = r1 + e1
    r3 = r0 + e1

    def nrm(a, b):
        c = torch.linalg.cross(a, b, dim=-1)
        return c / torch.sqrt(torch.clamp(vo.length_sq(c), min=1e-30))[..., None]

    def acos(a, b):
        return torch.acos(torch.clamp(vo.dot(a, b), -1.0, 1.0))

    n0, n1, n2, n3 = nrm(r0, r1), nrm(r1, r2), nrm(r2, r3), nrm(r3, r0)
    q = acos(n0, n1) + acos(n1, n2) + acos(n2, n3) + acos(n3, n0)
    return 2.0 * math.pi - torch.abs(q)


def _light_weights(scene, p):
    """Per-light approximateRadiance at p (TraceBase.cpp:416-459): rows of
    (L, N); 'none' lights get the reference's uniform replacement (the mean
    of the known weights). Returns (w, total)."""
    lights = scene.lights
    n = p.shape[0]
    rows = []
    for i, kind in enumerate(lights.apx_kind):
        avg = lights.apx_avg[i]
        if kind == "const":
            rows.append(avg.expand(n))
        elif kind == "quad":
            behind = vo.dot(lights.apx_base[i] - p, lights.apx_n[i].expand(p.shape)) >= 0.0
            sa = _quad_solid_angle(p, lights.apx_base[i], lights.apx_e0[i], lights.apx_e1[i])
            rows.append(torch.where(behind, 0.0, sa * avg))
        elif kind == "none":  # unknown: TriangleMesh, Cube
            rows.append(torch.full((n,), -1.0, device=p.device))
        else:
            raise NotImplementedError(f"approximateRadiance kind '{kind}' is not ported")
    w = torch.stack(rows, 0)  # (L, N)
    known = w >= 0.0
    total_k = torch.sum(torch.where(known, w, 0.0), 0)
    n_k = torch.sum(known, 0)
    uniform_w = torch.where(total_k == 0.0, 1.0, total_k) / torch.clamp(n_k, min=1)
    uniform_w = torch.where(n_k == 0, 1.0, uniform_w)
    w = torch.where(known, w, uniform_w[None])
    return w, torch.sum(w, 0)


def _uniform_choice(scene) -> bool:
    return scene.meta.n_lights <= 1 or all(k == "none" for k in scene.lights.apx_kind)


def choose_light(scene, u, p):
    """TraceBase::chooseLight: pick a light by approximate received
    radiance; returns (li (N,), weight = total / pdf_i (N,)). weight = 0
    when total = 0 (no reachable light: the contribution cancels)."""
    nl = scene.meta.n_lights
    if _uniform_choice(scene):
        li = torch.clamp((u * nl).to(torch.int64), max=nl - 1)
        return li, torch.full(p.shape[:-1], float(nl), device=p.device)
    w, total = _light_weights(scene, p)
    cum = torch.cumsum(w, 0)
    li = torch.clamp(torch.sum((u * total)[None] >= cum, 0), 0, nl - 1)
    wi = torch.gather(w, 0, li[None])[0]
    return li, torch.where(total > 0.0, total / torch.clamp(wi, min=1e-30), 0.0)


def light_choice_pdf(scene, li, p):
    """Probability that chooseLight(p) picks light li: the factor folded
    into MIS light pdfs where NEE pairs with the continuation ray."""
    nl = scene.meta.n_lights
    if _uniform_choice(scene):
        return torch.full(p.shape[:-1], 1.0 / max(nl, 1), device=p.device)
    w, total = _light_weights(scene, p)
    wi = torch.gather(w, 0, torch.clamp(li, 0, nl - 1)[None])[0]
    return torch.where(total > 0.0, wi / torch.clamp(total, min=1e-30), 0.0)


def infinite_winner_choice_pdf(scene, d, p):
    """chooseLight(p) probability of the env, the one infinite light that
    can win an escape (pairs with infinite_winner_pdf for MIS)."""
    wid = torch.full(d.shape[:-1], max(scene.meta.env_light_index, 0), dtype=torch.int64,
                     device=d.device)
    return light_choice_pdf(scene, wid, p)


def sample_area_direct(scene, li, p, u_tri, u2) -> LightSample:
    """Sample a point on area light li (N,) as seen from p (N, 3). Without
    area lights the callers overwrite every lane with the env's sample, so
    the CDF search and the triangle gathers are skipped."""
    if scene.lights.has_surface:
        return _sample_area_direct_tris(scene, li, p, u_tri, u2)
    n = u_tri.shape[0]
    z3 = torch.zeros((n, 3), device=p.device)
    return LightSample(d=z3, dist=torch.zeros((n,), device=p.device),
                       pdf=torch.ones((n,), device=p.device), radiance=z3,
                       valid=torch.zeros((n,), dtype=torch.bool, device=p.device))


def _sample_area_direct_tris(scene, li, p, u_tri, u2) -> LightSample:
    lights = scene.lights
    count = lights.count[li]
    k = searchsorted_strided(lights.cdf, lights.cdf_offset[li], u_tri, count + 1,
                             max_len=lights.max_count + 1) - 1
    k = torch.minimum(torch.clamp(k, min=0), torch.clamp(count - 1, min=0))
    tri = lights.tri_idx[torch.clamp(lights.offset[li] + k, 0, lights.tri_idx.shape[0] - 1)]

    lam = warps.uniform_triangle_uv(u2)  # barycentric weights of (p0, p1)
    lx, ly = lam[..., 0:1], lam[..., 1:2]
    # reference: p = p0 * l.x + p1 * l.y + p2 * (1 - l.x - l.y)
    q = scene.tris.v0[tri] + scene.tris.e1[tri] * ly + scene.tris.e2[tri] * (1.0 - lx - ly)
    uv = (scene.tri_uv0[tri] * lx + scene.tri_uv1[tri] * ly
          + scene.tri_uv2[tri] * (1.0 - lx - ly))
    dvec = q - p
    r_sq = vo.length_sq(dvec)
    dist = torch.sqrt(torch.clamp(r_sq, min=1e-30))
    d = dvec / dist[..., None]
    cos_theta = -vo.dot(scene.tri_ng[tri], d)
    # emission-cone gate; cone_cos is 0 for ordinary lights: the front test
    valid = (cos_theta > torch.clamp(lights.cone_cos[li], min=0.0)) & (cos_theta > 0.0)
    pdf = r_sq / torch.clamp(cos_theta * lights.area[li], min=1e-30)
    rad = eval_texture(scene.textures, lights.tex[li], uv, may=lights.emit_kinds)
    return LightSample(d=d, dist=dist, pdf=pdf, radiance=rad, valid=valid)


def area_direct_pdf(scene, tri, p, hit_p, d):
    """directPdf of the area light owning triangle `tri`, for a hit at hit_p
    reached from p along d (TriangleMesh::directPdf); 0 where tri is no
    light's (an analytic virtual id included: none is emissive)."""
    li = scene.tri_light[tri]
    area = scene.lights.area[torch.clamp(li, min=0)]
    cos_theta = torch.abs(vo.dot(d, scene.tri_ng[tri]))
    pdf = vo.length_sq(hit_p - p) / torch.clamp(cos_theta * area, min=1e-30)
    return torch.where(li >= 0, pdf, 0.0)
