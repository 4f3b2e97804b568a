"""Regenerating wavefront path tracer with NEE and single-sample MIS (torch).

Port of `trace_regen_batch` and the helpers it calls from
tungsten_tpu/integrators/path_tracer.py (lines 67-150, 1100-1232, 1236-1778)
for the slice's configuration: triangles and non-emissive analytic prims,
no media, no forward lobes, no AOVs, one samplable env light. A
fixed-width wavefront of W lanes runs the bounce loop; a lane whose path
ends respawns a camera path from the budget of n_passes * W paths. Per
iteration:

  sampler window prefetch -> shading data -> one material gather + masked
  BSDF dispatch -> env light sample -> continuation + Russian roulette ->
  regen -> ONE 2N-lane walk carrying the shadow rays and the next rays ->
  one scatter-add into rad_pix.

The intersector dispatch is the JAX package's TPU route (`_intersect`,
`_intersect_tris`, `_intersect_mixed`): analytic prims first, their t
clipping the triangle walk; then the first pack the scene carries, pbvh8
(K3), pbvh (K5) or ptris (K2, which every scene has); brute force at 64
triangles or fewer. The 2N walk latches the shadow lanes (any-hit) on K3
and is a plain closest-hit walk on the other routes (same booleans).

RNG streams key on the global path id, so the image is a pure function of
(seed, path id) as in the JAX package. The loop condition is one `.item()`
per iteration (the JAX package's lax.while_loop runs on the device).
"""
from __future__ import annotations

import torch

from ..math import vecops as vo
from ..models.bsdfs.common import Lobes
from ..models.bsdfs.dispatch import bsdf_eval, bsdf_pdf, bsdf_sample, gather
from ..models.cameras.pinhole import camera_rays_w
from ..models.primitives import lights as L
from ..models.primitives.analytic import intersect_analytic, normal_at
from ..ops import bvh, bvh8
from ..ops.intersect import INF, Hit, intersect_brute
from ..ops.intersect_stream import intersect_stream
from ..sampling import warps
from ..sampling.sampler import MASK32, Sampler, _mul32, stratified_cam_2d
from ..scene.flatten import DEFAULT_EPSILON, FlatScene

DIMS_PER_BOUNCE = 24
SHADOW_FUDGE = 1.0 - 1e-3  # cf. attenuatedEmission's 1+1e-3 (TraceBase.cpp:155)


BRUTE_MAX_TRIS = 64  # at or below: brute force, no pack (path_tracer.py:90, :106)


def _with_analytic(scene: FlatScene, o, d, tnear, tfar, walk) -> Hit:
    """Analytic prims first; their t clips the triangle walk `walk(tfar)`,
    and the nearer hit wins, an analytic one carrying the virtual id
    n_tris + k and its uv in (u, v) (path_tracer.py:71-83)."""
    if scene.ana is None:
        return walk(tfar)
    ah = intersect_analytic(scene.ana, o, d, tnear, tfar)
    h = walk(torch.minimum(tfar, ah.t))
    pick_a = (ah.k >= 0) & (ah.t < h.t)
    return Hit(t=torch.where(pick_a, ah.t, h.t),
               prim=torch.where(pick_a, scene.tris.v0.shape[0] + ah.k, h.prim),
               u=torch.where(pick_a, ah.uv[:, 0], h.u),
               v=torch.where(pick_a, ah.uv[:, 1], h.v))


def _intersect_tris(scene: FlatScene, o, d, tnear, tfar) -> Hit:
    """Closest hit over the triangles through the first pack the scene
    carries: pbvh8 (K3), pbvh (K5), else ptris (K2) (path_tracer.py:87-108)."""
    if scene.tris.v0.shape[0] <= BRUTE_MAX_TRIS:
        return intersect_brute(scene.tris, o, d, tnear, tfar)
    if scene.pbvh8 is not None:
        return bvh8.intersect(scene.pbvh8, scene.tris, o, d, tnear, tfar)
    if scene.pbvh is not None:
        return bvh.intersect_bvh(scene.pbvh, o, d, tnear, tfar)
    return intersect_stream(scene.ptris, o, d, tnear, tfar)


def _intersect(scene: FlatScene, o, d, tnear, tfar) -> Hit:
    """Closest hit over triangles and analytic prims."""
    return _with_analytic(scene, o, d, tnear, tfar,
                          lambda far: _intersect_tris(scene, o, d, tnear, far))


def _intersect_mixed(scene: FlatScene, o, d, tnear, tfar, latch) -> Hit:
    """ONE walk for a mixed [any-hit | closest-hit] wavefront: on K3 latched
    lanes stop at their first hit (only prim >= 0 is meaningful); the other
    routes run closest hit on every lane, which gives the same booleans
    (path_tracer.py:1171-1198)."""
    if scene.pbvh8 is None or scene.tris.v0.shape[0] <= BRUTE_MAX_TRIS:
        return _intersect(scene, o, d, tnear, tfar)
    return _with_analytic(scene, o, d, tnear, tfar, lambda far: bvh8.intersect_mixed(
        scene.pbvh8, scene.tris, o, d, tnear, far, latch))


def _shading_data(scene: FlatScene, hit: Hit, o, d):
    """Gather surface info for hit lanes (garbage where prim < 0, masked out
    by the caller): ONE packed row gather per lane. An analytic hit (virtual
    id >= T) takes Ns = Ng = normal_at(p) and uv = (hit.u, hit.v)
    (path_tracer.py:129-137). The geometric normal and the light id of the
    row serve media and area lights, not ported."""
    tri = torch.clamp(hit.prim, min=0)
    p = o + d * hit.t[..., None]
    u = hit.u[..., None]
    v = hit.v[..., None]
    w0 = 1.0 - u - v
    row = scene.shade_pack[tri]
    ns = vo.normalize(row[..., 3:6] * w0 + row[..., 6:9] * u + row[..., 9:12] * v)
    uv = row[..., 12:14] * w0 + row[..., 14:16] * u + row[..., 16:18] * v
    mat = row[..., 18].to(torch.int64)
    if scene.ana is not None:
        n_tris = scene.tris.v0.shape[0]
        is_a = (hit.prim >= n_tris)[..., None]
        ns = torch.where(is_a, normal_at(scene.ana, hit.prim - n_tris, p), ns)
        uv = torch.where(is_a, torch.cat([u, v], -1), uv)
    return p, ns, uv, mat


def _shading_frame(ns, flip):
    """Local shading frame (t, b, n) with the two-sided flip applied."""
    t_ax, b_ax = vo.tangent_frame(ns)
    n_ax = ns
    t_ax = vo.where3(flip, -t_ax, t_ax)
    n_ax = vo.where3(flip, -n_ax, n_ax)
    return t_ax, b_ax, n_ax


def _choose_and_sample_light(scene: FlatScene, smp: Sampler, p):
    """Light choice + sampleDirect over the slice's one env light. Consumes
    4 sampler dims like the JAX function. With one light the choice and its
    pdf are static (li = 0, choice pdf 1), and `_merge_ls(is_env, env, area)`
    selects the env sample on every lane, so the area sample the JAX
    function draws and discards is not drawn here."""
    n = p.shape[0]
    _, smp = smp.next_1d()  # u_choose: unused with a single light
    u_point, smp = smp.next_2d()
    _, smp = smp.next_1d()  # u_tri: feeds the discarded area sample
    ls = L.sample_env_direct(scene, u_point)
    choice_pdf = torch.ones((n,), device=p.device)
    return ls, choice_pdf, smp


def _regen(scene, s, seed, px_cycle, py_cycle, pix_cycle, pass_base, W, total, strat):
    """Respawn dead lanes with the next path ids; past-budget lanes idle."""
    meta = scene.meta
    n_pix = meta.res_x * meta.res_y
    m = max(W // n_pix, 1)
    dead = ~s["alive"]
    ranks = torch.cumsum(dead.long(), 0) - 1
    new_id = s["next_id"] + torch.where(dead, ranks, 0)
    take = dead & (new_id < total)
    next_id = s["next_id"] + dead.sum()
    cyc = torch.where(take, new_id % W, 0)
    pxn, pyn = px_cycle[cyc], py_cycle[cyc]
    pass_idx = (pass_base + new_id // W) & MASK32
    lane_key = (pass_base * W + new_id) & MASK32
    if strat:
        samp_idx = (_mul32(pass_idx, m) + cyc // n_pix) & MASK32
        pix_key = (_mul32(pyn, meta.res_x) + pxn) & MASK32
    else:
        samp_idx = pix_key = None
    smp = Sampler.create(seed, lane_key, samp_idx, pix_key, strat)
    u_cam, smp = smp.next_2d()
    u_lens, smp = smp.next_2d()
    if not strat:
        u_cam = stratified_cam_2d(cyc, pass_idx)
    o_c, d_c, cam_w = camera_rays_w(scene.camera, meta, pxn, pyn, u_cam, u_lens)
    t3 = take[..., None]
    out = dict(s)
    out["o"] = torch.where(t3, o_c, s["o"])
    out["d"] = torch.where(t3, d_c, s["d"])
    out["near"] = torch.where(take, 1e-4, s["near"])
    out["pix"] = torch.where(take, pix_cycle[cyc], s["pix"])
    out["lane_key"] = torch.where(take, lane_key, s["lane_key"])
    if strat:
        out["samp_idx"] = torch.where(take, samp_idx, s["samp_idx"])
        out["pix_key"] = torch.where(take, pix_key, s["pix_key"])
    out["throughput"] = torch.where(t3, cam_w[..., None], s["throughput"])
    out["emission"] = torch.where(t3, 0.0, s["emission"])
    out["alive"] = s["alive"] | (take & (cam_w > 0.0))
    out["was_specular"] = torch.where(take, True, s["was_specular"])
    out["bounce"] = torch.where(take, 0, s["bounce"])
    out["pdf_cont"] = torch.where(take, 1.0, s["pdf_cont"])
    out["nee_active"] = torch.where(take, False, s["nee_active"])
    out["next_id"] = next_id
    return out


def trace_regen_batch(scene: FlatScene, seed, px_cycle, py_cycle, pix_cycle,
                      pass_base: int, n_passes: int = 1):
    """Regenerating wavefront PT over W = len(px_cycle) lanes and
    n_passes * W paths. seed: (s0, s1) uint32 pair. Returns rad (n_pix, 3),
    the per-pixel radiance SUM."""
    meta = scene.meta
    if meta.has_forward or meta.has_media or meta.aovs:
        raise NotImplementedError("regen path: forward lobes, media and AOVs are not ported")
    dev = px_cycle.device
    W = px_cycle.shape[0]
    n_pix = meta.res_x * meta.res_y
    strat = bool(meta.stratified)
    total = n_passes * W
    do_nee = meta.enable_light_sampling and meta.n_lights > 0
    n = W
    pass_base = int(pass_base)

    def full(v, dtype=torch.float32, shape=(W,)):
        return torch.full(shape, v, dtype=dtype, device=dev)

    state = dict(
        o=full(0.0, shape=(W, 3)),
        d=torch.tensor([0.0, 0.0, 1.0], device=dev).expand(W, 3),
        near=full(1e-4),
        pix=full(0, torch.int64),
        lane_key=full(0, torch.int64),
        samp_idx=full(0, torch.int64) if strat else None,
        pix_key=full(0, torch.int64) if strat else None,
        throughput=full(1.0, shape=(W, 3)),
        emission=full(0.0, shape=(W, 3)),
        alive=full(False, torch.bool),
        was_specular=full(True, torch.bool),
        bounce=full(0, torch.int64),
        pdf_cont=full(1.0),
        nee_active=full(False, torch.bool),
        next_id=torch.zeros((), dtype=torch.int64, device=dev),
    )
    rad_pix = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)

    def regen(s):
        return _regen(scene, s, seed, px_cycle, py_cycle, pix_cycle, pass_base, W, total, strat)

    state = regen(state)
    hit = _intersect(scene, state["o"], state["d"], state["near"],
                     torch.where(state["alive"], INF, 0.0))
    mats, texs = scene.materials, scene.textures
    latch2 = torch.cat([full(True, torch.bool), full(False, torch.bool)])

    while bool(state["alive"].any().item()):
        s = state
        bounce = s["bounce"]
        smp = Sampler(seed, s["lane_key"], 2 + bounce * DIMS_PER_BOUNCE, s["samp_idx"],
                      s["pix_key"], strat).prefetch(8)
        o, d, alive = s["o"], s["d"], s["alive"]
        throughput, emission = s["throughput"], s["emission"]
        did_hit = (hit.prim >= 0) & alive
        smp = smp.skip(3)  # the medium-interaction dims (no media)
        hit_surface_lane = did_hit
        alive = alive & did_hit

        # ---- misses: environment, MIS against the previous light sample ----
        miss = s["alive"] & (hit.prim < 0)
        mis_applies = (~s["was_specular"] & s["nee_active"]) if do_nee else torch.zeros_like(miss)
        if do_nee:
            lp_inf = L.infinite_winner_pdf(scene, d) * L.infinite_winner_choice_pdf(scene, d, o)
            w_env = torch.where(mis_applies, warps.power_heuristic(s["pdf_cont"], lp_inf), 1.0)
        else:
            w_env = full(1.0)
        add_env = miss & (bounce >= meta.min_bounces)
        emission = emission + torch.where(
            add_env[..., None], throughput * L.infinite_radiance(scene, d) * w_env[..., None], 0.0)

        # ---- surface shading data + ONE material gather ----
        p, ns, uv, mat_id = _shading_data(scene, hit, o, d)
        mat_pre = gather(mats, texs, mat_id, uv)
        lobes = mat_pre[3]
        hit_backside = vo.dot(ns, d) > 0.0
        if meta.enable_two_sided:
            flip = hit_backside & ~Lobes.is_transmissive(lobes)
        else:
            flip = torch.zeros_like(hit_backside)
        frame = _shading_frame(ns, flip)
        wi = vo.to_local(*frame, -d)
        vp = p
        throughput_vertex = throughput

        # ---- NEE: light strategy only (the continuation is the bsdf half) ----
        if do_nee:
            ls, cp_pick, smp = _choose_and_sample_light(scene, smp, vp)
            wo_l = vo.to_local(*frame, ls.d)
            f_l = bsdf_eval(mats, mat_pre, uv, wi, wo_l)
            pdf_b = bsdf_pdf(mats, mat_pre, uv, wi, wo_l)
            w_light = warps.power_heuristic(ls.pdf * cp_pick, pdf_b)
            # with one light, the escape winner along ls.d is the chosen light,
            # so the JAX package's masked-infinite-choice override never fires
            skip_l = (Lobes.is_pure_specular(lobes) | (lobes == Lobes.FORWARD) | (lobes == 0))
            nee_gate = hit_surface_lane & (bounce < meta.max_bounces - 1)
            cand = (ls.valid & (ls.pdf > 0.0) & torch.any(f_l > 0.0, dim=-1)
                    & ~skip_l & nee_gate)
            shadow_far = torch.where(
                cand, torch.where(ls.dist >= INF, INF, ls.dist * SHADOW_FUDGE), 0.0)
            near_nee = full(DEFAULT_EPSILON)
            contrib_l = f_l * ls.radiance * (
                w_light / torch.clamp(ls.pdf * cp_pick, min=1e-30))[..., None]
            contrib_l = torch.where(
                torch.all(torch.isfinite(contrib_l), dim=-1)[..., None], contrib_l, 0.0)
            nee_add = torch.where(cand[..., None], throughput_vertex * contrib_l, 0.0)
        else:
            smp = smp.skip(4)
            nee_gate = full(False, torch.bool)
            nee_add = None

        # ---- continuation sample ----
        u_c2, smp = smp.next_2d()
        u_c1, smp = smp.next_1d()
        bs = bsdf_sample(mats, mat_pre, uv, wi, u_c2, u_c1)
        wo_w = vo.to_global(*frame, bs.wo)
        pdf_cont = bs.pdf
        throughput = throughput * torch.where(alive[..., None], bs.weight, 1.0)
        was_specular = torch.where(hit_surface_lane, Lobes.has_specular(bs.lobe),
                                   s["was_specular"])
        alive = alive & torch.where(hit_surface_lane, bs.valid, True)
        alive = alive & (vo.max3(torch.abs(throughput)) > 0.0)

        # ---- russian roulette ----
        rp = vo.max3(torch.abs(throughput))
        u_rr, smp = smp.next_1d()
        do_rr = (bounce > 2) & (rp < 0.1)
        survive = u_rr < rp
        throughput = torch.where((do_rr & survive & alive)[..., None],
                                 throughput / torch.clamp(rp, min=1e-30)[..., None], throughput)
        alive = alive & (~do_rr | survive)
        alive = alive & (bounce + 1 < meta.max_bounces)

        # ---- deposit finished paths, then respawn their lanes ----
        fin = s["alive"] & ~alive
        em_clean = torch.where(torch.isfinite(emission), emission, 0.0)
        dep_val = torch.where(fin[..., None], em_clean, 0.0)
        old_pix = s["pix"]
        s2 = dict(s)
        s2.update(o=vp, d=wo_w, near=full(DEFAULT_EPSILON), throughput=throughput,
                  emission=emission, alive=alive, was_specular=was_specular,
                  bounce=bounce + 1, pdf_cont=pdf_cont, nee_active=nee_gate)
        s2 = regen(s2)

        # ---- next-ray closest hit merged with the shadow batch: one 2N walk ----
        far_next = torch.where(s2["alive"], INF, 0.0)
        if nee_add is not None:
            h2 = _intersect_mixed(
                scene, torch.cat([vp, s2["o"]]), torch.cat([ls.d, s2["d"]]),
                torch.cat([near_nee, s2["near"]]), torch.cat([shadow_far, far_next]), latch2)
            blocked = h2.prim[:n] >= 0
            hit = Hit(t=h2.t[n:], prim=h2.prim[n:], u=h2.u[n:], v=h2.v[n:])
            # ONE scatter: finished-path deposit + NEE, by the pre-regen pixel
            rad_pix.index_add_(0, old_pix, dep_val + torch.where(blocked[..., None], 0.0, nee_add))
        else:
            rad_pix.index_add_(0, old_pix, dep_val)
            hit = _intersect(scene, s2["o"], s2["d"], s2["near"], far_next)
        state = s2
    return rad_pix
