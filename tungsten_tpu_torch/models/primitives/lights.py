"""Light sampling on torch tensors: every light kind of the JAX flatten but
the skydome.

Port of tungsten_tpu/models/primitives/lights.py:
 - area lights (emissive meshes, quads, cubes): area-weighted triangle pick
   by a strided CDF search, uniform barycentric point, one-sided,
   pdf = r^2 / (cos * total area) (TriangleMesh.cpp sampleDirect /
   directPdf), behind a disk's emission cone where it has one;
 - analytic emitters (sphere, disk, cylinder): their exact sampleDirect and
   directPdf (models/primitives/analytic.py);
 - infinite spheres, any number: lat-long importance sampling of the
   emission bitmap (or uniform-sphere sampling of a constant env), pdf =
   pdf_uv / (2 pi^2 sin theta) (InfiniteSphere.cpp:27-50,161-229); each env
   primitive is its own light row (`env_slot`), the last one wins an
   escape and masks the earlier ones;
 - spherical caps (InfiniteSphereCap.cpp): uniform in the cone, radiance
   inside it; a cap listed after the last env can win an escape
   (`meta.esc_caps`);
 - point lights (Point.cpp): dirac, pdf = r^2, no bsdf strategy;
 - the light choice by approximate received radiance (TraceBase::chooseLight)
   over the kinds quad, sphere, disk (with its cone gate), point, const and
   none;
 - emitter position sampling for the light tracer and BDPT
   (`sample_emitter_position`, Primitive::samplePosition): an area light's
   area-weighted triangle and a uniform barycentric point, an analytic
   emitter's uniform surface point; env, cap and point rows are invalid
   there, as in the JAX package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ...math import vecops as vo
from ...sampling import warps
from ...sampling.distributions import searchsorted_strided
from ..textures.textures import eval_texture
from . import analytic

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
    """Emission of the escape-winner env (the last env primitive, which
    masks every earlier one) seen along escape direction d."""
    uv, _ = direction_to_uv(scene.env, d)
    return eval_texture(scene.textures, _env_tex(scene.env, d.shape[:-1], d.device), uv,
                        may=_env_may(scene.env))


def _env_direct_pdf_one(scene, env, is_const, d):
    """Solid-angle pdf of one env's sampleDirect for direction d."""
    if is_const:
        return torch.full(d.shape[:-1], warps.INV_FOUR_PI, dtype=torch.float32, device=d.device)
    h, w = env.dist.shape
    uv, sin_theta = direction_to_uv(env, d)
    x = torch.clamp((uv[..., 0] * w).to(torch.int64), 0, w - 1)
    row = torch.clamp(((1.0 - uv[..., 1]) * h).to(torch.int64), 0, h - 1)
    pdf_uv = env.dist.prob(x, row) * (w * h)
    return torch.where(
        sin_theta > 1e-6,
        pdf_uv * warps.INV_PI * warps.INV_TWO_PI / torch.clamp(sin_theta, min=1e-6), 0.0)


def env_direct_pdf(scene, d):
    """Solid-angle pdf of the escape-winner env's sampleDirect."""
    return _env_direct_pdf_one(scene, scene.env, scene.meta.env_is_constant, d)


def _sample_env_direct_one(scene, env, is_const, u2) -> LightSample:
    n = u2.shape[0]
    dev = u2.device
    if is_const:
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


def _envs(scene):
    """(every env light, their constant flags) in primitive order."""
    meta = scene.meta
    if meta.n_envs:
        return scene.envs, meta.env_const
    return (scene.env,), (meta.env_is_constant,)


def sample_env_direct(scene, li, u2) -> LightSample:
    """sampleDirect of the env light chosen at light index li (N,): each env
    primitive is its own light row, whose slot picks its EnvLight."""
    envs, consts = _envs(scene)
    ls = _sample_env_direct_one(scene, envs[0], consts[0], u2)
    if len(envs) > 1:
        slot = scene.lights.env_slot[li]
        for e in range(1, len(envs)):
            ls = _merge_ls(slot == e, _sample_env_direct_one(scene, envs[e], consts[e], u2), ls)
    return ls


def cap_in_cone_k(scene, d, k: int):
    """Directions inside cap k's emission cone (InfiniteSphereCap.cpp:60-64)."""
    cap = scene.cap
    return vo.dot(d, cap.dir[k].expand(d.shape)) >= cap.cos_angle[k]


def cap_direct_pdf_k(scene, d, k: int):
    """Uniform spherical-cap solid-angle pdf of cap k
    (SampleWarp::uniformSphericalCapPdf), 0 outside its cone."""
    pdf = warps.INV_TWO_PI / torch.clamp(1.0 - scene.cap.cos_angle[k], min=1e-9)
    return torch.where(cap_in_cone_k(scene, d, k), pdf, 0.0)


def sample_cap_direct(scene, li, u2) -> LightSample:
    """sampleDirect of the cap light chosen at light index li (N,)
    (InfiniteSphereCap.cpp:131-140): a uniform direction in the cone about
    its axis, dist = inf. Lanes whose li is no cap return garbage (callers
    gate on lights.cap_slot[li] >= 0)."""
    cap = scene.cap
    n, dev = u2.shape[0], u2.device
    slot = torch.clamp(scene.lights.cap_slot[li], min=0)
    cdir = cap.dir[slot]
    ccos = cap.cos_angle[slot]
    cos_t = ccos + u2[..., 0] * (1.0 - ccos)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = u2[..., 1] * (2.0 * math.pi)
    local = torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, cos_t], dim=-1)
    t, b = vo.tangent_frame(cdir)
    return LightSample(
        d=vo.to_global(t, b, cdir, local), dist=torch.full((n,), INF, device=dev),
        pdf=warps.INV_TWO_PI / torch.clamp(1.0 - ccos, min=1e-9), radiance=cap.radiance[slot],
        valid=torch.ones((n,), dtype=torch.bool, device=dev))


def infinite_radiance(scene, d):
    """Emission seen by an escaped ray: the LAST infinite primitive in scene
    order that the direction meets wins (TraceableScene.hpp:194-209); a cap
    meets only its cone. meta.esc_caps holds the caps listed after the last
    env, in primitive order, so overwriting in that order reproduces it."""
    meta = scene.meta
    if meta.has_env:
        rad = env_radiance(scene, d)
    else:
        rad = torch.zeros(d.shape[:-1] + (3,), device=d.device)
    for k in meta.esc_caps:
        rad = torch.where(cap_in_cone_k(scene, d, k)[..., None],
                          scene.cap.radiance[k].expand(rad.shape), rad)
    return rad


def infinite_needs_escape_add(scene, d, was_specular):
    """Lanes whose escape emission is NOT covered by the NEE/MIS machinery:
    light sampling off, a specular prior bounce, or an unsamplable winning
    infinite primitive (cf. handleInfiniteLights)."""
    meta = scene.meta
    if not meta.enable_light_sampling:
        return torch.ones(d.shape[:-1], dtype=torch.bool, device=d.device)
    unsampled = torch.full(d.shape[:-1], meta.has_env and meta.env_light_index < 0,
                           device=d.device)
    for k in meta.esc_caps:
        unsampled = torch.where(cap_in_cone_k(scene, d, k), _cap_li(meta, k) < 0, unsampled)
    return was_specular | unsampled


def _cap_li(meta, k: int) -> int:
    """Light index of cap slot k (-1 when unsamplable)."""
    return meta.cap_light_idx[k] if k < len(meta.cap_light_idx) else -1


def any_infinite_sampled(meta) -> bool:
    """True when some escape-winning infinite light has a light row (so the
    bsdf strategy can match it and needs the winner's radiance and pdf)."""
    return any(i >= 0 for i in meta.env_light_idx) or any(
        _cap_li(meta, k) >= 0 for k in meta.esc_caps)


def infinite_winner_pdf(scene, d):
    """Direct-sampling pdf of the WINNING infinite light for escape
    direction d; 0 where the winner is unsamplable, which makes
    power_heuristic(pdf_bsdf, 0) = 1 (the handleInfiniteLights gate)."""
    meta = scene.meta
    if meta.has_env and meta.env_light_index >= 0:
        pdf = env_direct_pdf(scene, d)
    else:
        pdf = torch.zeros(d.shape[:-1], device=d.device)
    for k in meta.esc_caps:
        cap_pdf = cap_direct_pdf_k(scene, d, k) if _cap_li(meta, k) >= 0 else 0.0
        pdf = torch.where(cap_in_cone_k(scene, d, k), cap_pdf, pdf)
    return pdf


def escape_winner(scene, d, want_radiance=True):
    """(winner light index, radiance, direct pdf) of the infinite primitive
    an escaping ray meets: the LAST listed one that meets d
    (TraceableScene.hpp:194-209). The index is -2 where nothing meets d or
    the winner is unsamplable, so `li == wl` is estimateDirect's exact test
    that the primitive hit IS the chosen light."""
    meta = scene.meta
    shp, dev = d.shape[:-1], d.device
    wl = torch.full(shp, -2, dtype=torch.int64, device=dev)
    e = torch.zeros(shp + (3,), device=dev)
    pdf = torch.zeros(shp, device=dev)
    if meta.has_env:
        wl = torch.full(shp, meta.env_light_index if meta.env_light_index >= 0 else -2,
                        dtype=torch.int64, device=dev)
        if want_radiance:
            e = env_radiance(scene, d)
        if meta.env_light_index >= 0:
            pdf = env_direct_pdf(scene, d)
    for k in meta.esc_caps:
        ic = cap_in_cone_k(scene, d, k)
        li_k = _cap_li(meta, k)
        wl = torch.where(ic, li_k if li_k >= 0 else -2, wl)
        e = torch.where(ic[..., None], scene.cap.radiance[k].expand(e.shape), e)
        pdf = torch.where(ic, cap_direct_pdf_k(scene, d, k) if li_k >= 0 else 0.0, pdf)
    return wl, e, pdf


def chosen_infinite_eval(scene, li, d):
    """bsdf-strategy target eval for CHOSEN infinite lights: estimateDirect
    intersects the chosen light primitive itself (TraceBase.cpp:286-319), so
    a chosen env that a later env or cap masks at escape time still gives
    its own radiance and directPdf where the bsdf ray escapes. Returns
    (match, radiance, pdf): match where li is a samplable infinite primitive
    that d meets (an env: every direction; a cap: its cone); False for area
    and point choices."""
    meta = scene.meta
    shp, dev = d.shape[:-1], d.device
    match = torch.zeros(shp, dtype=torch.bool, device=dev)
    e = torch.zeros(shp + (3,), device=dev)
    pdf = torch.zeros(shp, device=dev)
    envs, consts = _envs(scene) if meta.has_env else ((), ())
    for s, (env, is_const) in enumerate(zip(envs, consts)):
        li_e = meta.env_light_idx[s] if s < len(meta.env_light_idx) else -1
        if li_e < 0:
            continue
        sel = li == li_e
        uv, _ = direction_to_uv(env, d)
        rad = eval_texture(scene.textures, _env_tex(env, shp, dev), uv)
        e = torch.where(sel[..., None], rad, e)
        pdf = torch.where(sel, _env_direct_pdf_one(scene, env, is_const, d), pdf)
        match = match | sel
    for k, li_c in enumerate(meta.cap_light_idx):
        if li_c < 0:
            continue
        sel = (li == li_c) & cap_in_cone_k(scene, d, k)
        e = torch.where(sel[..., None], scene.cap.radiance[k].expand(e.shape), e)
        pdf = torch.where(sel, cap_direct_pdf_k(scene, d, k), pdf)
        match = match | sel
    return match, e, pdf


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
        elif kind == "point":
            rows.append(avg / torch.clamp(vo.length_sq(lights.apx_base[i] - p), min=1e-30))
        elif kind == "sphere":
            lv = lights.apx_base[i] - p
            d = torch.sqrt(torch.clamp(vo.length_sq(lv), min=1e-30))
            r = lights.apx_e0[i][0]
            cos_t = torch.sqrt(torch.clamp(d * d - r * r, min=0.0)) / d
            rows.append(2.0 * math.pi * (1.0 - cos_t) * avg)
        elif kind == "quad":
            behind = vo.dot(lights.apx_base[i] - p, lights.apx_n[i].expand(p.shape)) >= 0.0
            sa = _quad_solid_angle(p, lights.apx_base[i], lights.apx_e0[i], lights.apx_e1[i])
            rows.append(torch.where(behind, 0.0, sa * avg))
        elif kind == "disk":  # the disk's bounding square, behind its emission cone
            cone_d = p - lights.apx_cbase[i]
            dl = torch.sqrt(torch.clamp(vo.length_sq(cone_d), min=1e-30))
            gate = vo.dot(cone_d, lights.apx_n[i].expand(p.shape)) / dl
            base = lights.apx_base[i] - lights.apx_e0[i] - lights.apx_e1[i]
            sa = _quad_solid_angle(p, base, 2.0 * lights.apx_e0[i], 2.0 * lights.apx_e1[i])
            rows.append(torch.where(gate < lights.cone_cos[i], 0.0, sa * avg))
        else:  # "none": unknown (TriangleMesh, Cube, Cylinder)
            rows.append(torch.full((n,), -1.0, device=p.device))
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
    """chooseLight(p) probability of the WINNING infinite light for escape
    direction d (pairs with infinite_winner_pdf for MIS)."""
    meta = scene.meta
    wid = torch.full(d.shape[:-1], max(meta.env_light_index, 0), dtype=torch.int64,
                     device=d.device)
    for k in meta.esc_caps:
        wid = torch.where(cap_in_cone_k(scene, d, k), max(_cap_li(meta, k), 0), wid)
    return light_choice_pdf(scene, wid, p)


def sample_area_direct(scene, li, p, u_tri, u2) -> LightSample:
    """Sample a point on area light li (N,) as seen from p (N, 3). Analytic
    emitters (sphere, disk, cylinder) take their exact direct samplers
    (models/primitives/analytic.py). Without surface lights the callers
    overwrite every lane with an env, cap or point sample, so the CDF search
    and the triangle gathers are skipped."""
    n = u_tri.shape[0]
    if scene.lights.has_surface:
        ls = _sample_area_direct_tris(scene, li, p, u_tri, u2)
    else:
        z3 = torch.zeros((n, 3), device=p.device)
        ls = LightSample(d=z3, dist=torch.zeros((n,), device=p.device),
                         pdf=torch.ones((n,), device=p.device), radiance=z3,
                         valid=torch.zeros((n,), dtype=torch.bool, device=p.device))
    if scene.ana is not None:
        k = scene.lights.ana_prim[li]
        d_a, dist_a, pdf_a, uv_a, valid_a = analytic.sample_direct(scene.ana, k, p, u2, u_tri)
        rad_a = eval_texture(scene.textures, scene.lights.tex[li], uv_a)
        ls = _merge_ls(k >= 0, LightSample(d=d_a, dist=dist_a, pdf=pdf_a, radiance=rad_a,
                                           valid=valid_a), ls)
    return ls


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
    """directPdf of the area light owning prim `tri` (a triangle id or an
    analytic virtual id >= T), for a hit at hit_p reached from p along d
    (TriangleMesh::directPdf; the analytic prims' directPdf); 0 where tri
    is no light's."""
    li = scene.tri_light[tri]
    area = scene.lights.area[torch.clamp(li, min=0)]
    cos_theta = torch.abs(vo.dot(d, scene.tri_ng[tri]))
    pdf = vo.length_sq(hit_p - p) / torch.clamp(cos_theta * area, min=1e-30)
    if scene.ana is not None:
        n_tris = scene.tris.v0.shape[0]
        pdf = torch.where(tri >= n_tris,
                          analytic.direct_pdf(scene.ana, tri - n_tris, p, hit_p, d), pdf)
    return torch.where(li >= 0, pdf, 0.0)


def sample_point_direct(scene, li, p) -> LightSample:
    """Point::sampleDirect (Point.cpp:98-106) of the point light at light
    index li (N,): d toward the point, pdf = r^2, so that radiance / pdf is
    power / (4 pi r^2); the dirac light takes MIS weight 1 (no bsdf strategy
    can hit it). Lanes whose li is no point light return garbage (callers
    gate on lights.pt_slot[li] >= 0)."""
    slot = torch.clamp(scene.lights.pt_slot[li], min=0)
    dvec = scene.point.pos[slot] - p
    r_sq = vo.length_sq(dvec)
    dist = torch.sqrt(torch.clamp(r_sq, min=1e-30))
    return LightSample(d=dvec / dist[..., None], dist=dist, pdf=r_sq,
                       radiance=scene.point.intensity[slot],
                       valid=torch.ones(p.shape[:-1], dtype=torch.bool, device=p.device))


def light_kinds(scene) -> tuple:
    """The kind of each light row: "area" (triangles), "sphere", "disk",
    "cylinder" (analytic emitters), "env", "cap" or "point"."""
    lights = scene.lights
    names = ("sphere", "disk", "cylinder")
    out = []
    for i in range(scene.meta.n_lights):
        k = int(lights.ana_prim[i])
        if k >= 0:
            out.append(names[int(scene.ana.ptype[k])])
        elif int(lights.env_slot[i]) >= 0:
            out.append("env")
        elif int(lights.cap_slot[i]) >= 0:
            out.append("cap")
        elif int(lights.pt_slot[i]) >= 0:
            out.append("point")
        else:
            out.append("area")
    return tuple(out)


@dataclass
class EmitterSample:
    p: torch.Tensor  # (N, 3) position on the light
    ng: torch.Tensor  # (N, 3)
    uv: torch.Tensor  # (N, 2)
    weight: torch.Tensor  # (N, 3) position weight = pi * area * emission
    radiance: torch.Tensor  # (N, 3) emitted radiance
    valid: torch.Tensor  # (N,) bool
    tri: torch.Tensor  # (N,) sampled triangle, or the analytic virtual id T + k


def sample_emitter_position(scene, li, u_tri, u2) -> EmitterSample:
    """Primitive::samplePosition of light li (N,) (lights.py:544-569): an
    area light's area-weighted triangle and a uniform barycentric point
    (TriangleMesh.cpp / Quad.cpp), weight = pi * area * emission; an
    analytic emitter's uniform surface point (`analytic.sample_position`),
    its tri the virtual id T + k. Env, cap and point rows are invalid, yet
    keep the triangle branch's point and weight (pi * their area, 1, times
    their emission at the point's uv), which BDPT's s = 1 connections read
    as the JAX package's do (ROADMAP §3)."""
    es = _sample_emitter_position_tris(scene, li, u_tri, u2)
    if scene.ana is not None:
        lights = scene.lights
        k = lights.ana_prim[li]
        p_a, ng_a, uv_a, _ = analytic.sample_position(scene.ana, k, u2, u_tri)
        rad_a = eval_texture(scene.textures, lights.tex[li], uv_a)
        is_a = k >= 0
        n_tris = scene.tris.v0.shape[0]
        es = EmitterSample(
            p=vo.where3(is_a, p_a, es.p), ng=vo.where3(is_a, ng_a, es.ng),
            uv=torch.where(is_a[..., None], uv_a, es.uv),
            weight=vo.where3(is_a, (math.pi * lights.area[li])[..., None] * rad_a, es.weight),
            radiance=vo.where3(is_a, rad_a, es.radiance), valid=torch.where(is_a, True, es.valid),
            tri=torch.where(is_a, n_tris + torch.clamp(k, min=0), es.tri))
    return es


def _sample_emitter_position_tris(scene, li, u_tri, u2) -> EmitterSample:
    lights = scene.lights
    count = lights.count[li]
    k = searchsorted_strided(lights.cdf, lights.cdf_offset[li], u_tri, count + 1,
                             max_len=lights.max_count + 1) - 1
    k = torch.minimum(torch.clamp(k, min=0), torch.clamp(count - 1, min=0))
    tri = lights.tri_idx[torch.clamp(lights.offset[li] + k, 0, lights.tri_idx.shape[0] - 1)]
    lam = warps.uniform_triangle_uv(u2)  # barycentric weights of (p0, p1)
    lx, ly = lam[..., 0:1], lam[..., 1:2]
    q = scene.tris.v0[tri] + scene.tris.e1[tri] * ly + scene.tris.e2[tri] * (1.0 - lx - ly)
    uv = (scene.tri_uv0[tri] * lx + scene.tri_uv1[tri] * ly
          + scene.tri_uv2[tri] * (1.0 - lx - ly))
    rad = eval_texture(scene.textures, lights.tex[li], uv)
    return EmitterSample(p=q, ng=scene.tri_ng[tri], uv=uv,
                         weight=(math.pi * lights.area[li])[..., None] * rad, radiance=rad,
                         valid=~lights.is_env[li] & (count > 0), tri=tri)
