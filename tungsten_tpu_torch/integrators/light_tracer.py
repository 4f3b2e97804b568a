"""Wavefront light tracer (adjoint particle tracing), torch.

Port of tungsten_tpu/integrators/light_tracer.py (LightTracer.cpp:12-120):
particles leave the lights (a uniform light choice, a position on the light,
a cosine direction), every surface and medium vertex connects to the camera
through the generalized shadow walk (`_trace_transparent`) and splats its
filtered contribution into the framebuffer, and the path continues by
adjoint BSDF (or phase) sampling: no NEE, no emission gathering.

One pass traces one light path per lane, all lanes bouncing together (one
`.item()` a bounce tests whether any lane lives, where the JAX package's
lax.while_loop runs on the device). Splats go through the path tracer's
`_deposit`: a sorted `index_put_` on the card, so that a render is a
function of its seed bit for bit. The image is the splat sum over all
light paths: splat_sum / (spp * W * H).
"""
from __future__ import annotations

import torch

from ..math import vecops as vo
from ..models.bsdfs.dispatch import bsdf_eta_sq, bsdf_eval, bsdf_sample, gather
from ..models.cameras import rfilter
from ..models.cameras.connect import camera_sample_direct
from ..models.phase.phase import phase_eval, phase_sample
from ..models.primitives import lights as L
from ..sampling import warps
from ..sampling.sampler import MASK32, Sampler
from ..scene.flatten import DEFAULT_EPSILON, FlatScene
from .path_tracer import (DIMS_PER_BOUNCE, INF, SHADOW_FUDGE, _deposit, _intersect,
                          _local_frame, _medium_handoff, _medium_interaction, _roulette,
                          _select_medium_dir, _shading_data, _trace_transparent)

LT_PASS_SEED = 0x10000  # pass i runs under (seed, LT_PASS_SEED + i) (light_tracer.py:135)


def splat_filtered(buf, pixel_xy, value, valid, res_x, res_y, filter_name="tent"):
    """AtomicFramebuffer::splatFiltered (AtomicFramebuffer.hpp:50-76;
    light_tracer.py:38-78) into buf (W*H, 3), in place; returns buf. tent:
    the exact analytic 2x2 footprint; mitchell_netravali, catmull_rom,
    lanczos: the SIGNED tabulated `eval_approx` over the 4x4 support of
    their width 2 (negative lobes splat negative energy); box: one pixel;
    dirac: the splat is dropped, as the reference drops it. The taps of
    the valid lanes that land on the film go in one `_deposit` (the others
    would add 0: on the card a sorted `index_put_` summing them all at one
    clamped index takes ~0.25 s a full-width splat)."""
    if filter_name == "dirac":
        return buf
    if filter_name == "box":
        px = torch.floor(pixel_xy[:, 0])
        py = torch.floor(pixel_xy[:, 1])
        inside = (px >= 0) & (px < res_x) & (py >= 0) & (py < res_y) & valid
        idx = py.to(torch.int64) * res_x + px.to(torch.int64)
        _deposit(buf, idx[inside], value[inside])
        return buf
    fx = pixel_xy[:, 0] - 0.5
    fy = pixel_xy[:, 1] - 0.5
    tabulated = rfilter.is_tabulated(filter_name)
    taps = (-1, 0, 1, 2) if tabulated else (0, 1)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    idxs, vals, keep = [], [], []
    for dx in taps:
        for dy in taps:
            px, py = x0 + dx, y0 + dy
            if tabulated:
                w = (rfilter.eval_approx(filter_name, fx - px)
                     * rfilter.eval_approx(filter_name, fy - py))
            else:
                w = (torch.clamp(1.0 - torch.abs(fx - px), min=0.0)
                     * torch.clamp(1.0 - torch.abs(fy - py), min=0.0))
            keep.append((px >= 0) & (px < res_x) & (py >= 0) & (py < res_y) & valid)
            idxs.append(py.to(torch.int64) * res_x + px.to(torch.int64))
            vals.append(value * w[:, None])
    keep = torch.cat(keep)
    _deposit(buf, torch.cat(idxs)[keep], torch.cat(vals)[keep])
    return buf


def _adjoint_correction(wi, wo, wi_w, wo_w, ng):
    """The shading-normal correction of adjoint transport (Bsdf.hpp:75-81):
    |(wo.ng * wi.z) / (wi.ng * wo.z)|, wi / wo local, wi_w / wo_w world."""
    return torch.abs((vo.dot(wo_w, ng) * wi[..., 2])
                     / torch.clamp(torch.abs(vo.dot(wi_w, ng) * wo[..., 2]), min=1e-20))


def _connect_to_camera(scene: FlatScene, buf, p, ng, frame, wi, mat_pre, uv, throughput,
                       medium, active, prim):
    """surfaceLensSample (TraceBase.cpp:176-244; light_tracer.py:81-124):
    the adjoint BSDF toward the lens, the generalized shadow walk, the
    filtered splat into buf."""
    meta = scene.meta
    mats, texs = scene.materials, scene.textures
    n = p.shape[0]
    d, dist, cam_w, pixel, valid = camera_sample_direct(scene.camera, meta, p)
    wo_l = vo.to_local(*frame, d)
    f = bsdf_eval(mats, mat_pre, uv, wi, wo_l, nonspecular_only=True, textures=texs)
    # adjoint: divide out the radiance eta^2, correct the normals
    eta2 = bsdf_eta_sq(mats, mat_pre, wi, wo_l)
    corr = _adjoint_correction(wi, wo_l, vo.to_global(*frame, wi), d, ng)
    f = f * (corr / torch.clamp(eta2, min=1e-20))[..., None]
    cand = active & valid & torch.any(f > 0.0, dim=-1)
    med = None
    if meta.has_media:
        # the lens ray starts in the medium on ITS side of the surface
        # (TraceBase.cpp:223-224); lanes that trace nothing walk no grid
        med = torch.where(cand, _select_medium_dir(scene, medium, prim, d, active, p=p), -1)
    ones = torch.ones((n,), dtype=torch.bool, device=p.device)
    w_sh, h_sh = _trace_transparent(scene, p, d, torch.where(cand, dist * SHADOW_FUDGE, 0.0),
                                    med, ones, ones)
    visible = cand & (h_sh.prim < 0)
    value = throughput * f * w_sh * cam_w[:, None]
    splat_filtered(buf, pixel, value, visible, meta.res_x, meta.res_y, meta.filter)


def trace_light_pass(scene: FlatScene, seed, lane_ids):
    """Trace one light path per lane (light_tracer.py:144-347); seed: the
    (s0, s1) pair of the pass. Returns the (W*H, 3) splat buffer,
    unnormalized (divide by the number of light paths), its non-finite
    entries zeroed."""
    meta = scene.meta
    mats, texs = scene.materials, scene.textures
    dev = lane_ids.device
    n = lane_ids.shape[0]
    seed = (int(seed[0]) & MASK32, int(seed[1]) & MASK32)
    sampler = Sampler.create(seed, lane_ids)
    buf = torch.zeros((meta.res_x * meta.res_y, 3), device=dev)
    media = meta.has_media

    # the emitter: a uniform light choice (chooseLightAdjoint, LightTracer.cpp:14-22)
    u_li, sampler = sampler.next_1d()
    li = torch.clamp((u_li * meta.n_lights).to(torch.int64), max=meta.n_lights - 1)
    light_pdf = 1.0 / meta.n_lights
    u_tri, sampler = sampler.next_1d()
    u_pos, sampler = sampler.next_2d()
    em = L.sample_emitter_position(scene, li, u_tri, u_pos)
    u_dir, sampler = sampler.next_2d()
    t_e, b_e = vo.tangent_frame(em.ng)
    d = vo.to_global(t_e, b_e, em.ng, warps.cosine_hemisphere(u_dir))
    throughput = em.weight / light_pdf  # the cosine direction's weight is 1
    alive = em.valid
    ones = torch.ones((n,), dtype=torch.bool, device=dev)
    medium = (scene.tri_med_ext[torch.clamp(em.tri, min=0)] if media
              else torch.full((n,), -1, dtype=torch.int64, device=dev))

    # emitter -> lens (LightTracer.cpp:27-38, min_bounces 0): pi*A*Le/pick
    # * Tr * lens weight * cos / pi (Quad.cpp:230-233), the (s=1, t=1)
    # technique the bounce loop never reaches
    if meta.min_bounces == 0:
        dc, distc, cam_w, pixel, vld = camera_sample_direct(scene.camera, meta, em.p)
        cos_e = torch.clamp(vo.dot(dc, em.ng), min=0.0)
        cand = alive & vld & (cos_e > 0.0)
        w_sh, h_sh = _trace_transparent(
            scene, em.p, dc, torch.where(cand, distc * SHADOW_FUDGE, 0.0),
            torch.where(cand, medium, -1) if media else None, ones, ones)
        splat_filtered(buf, pixel, throughput * w_sh * (cam_w * cos_e * warps.INV_PI)[:, None],
                       cand & (h_sh.prim < 0), meta.res_x, meta.res_y, meta.filter)

    o = em.p
    near = torch.full((n,), DEFAULT_EPSILON, device=dev)
    first_scatter = ones.clone()
    med_bounce = torch.zeros((n,), dtype=torch.int64, device=dev)
    base_dim = sampler.dim
    bounce = 0
    while bounce < meta.max_bounces - 1 and bool(alive.any().item()):
        smp = Sampler(seed, sampler.lane_id, base_dim + bounce * DIMS_PER_BOUNCE)
        hit = _intersect(scene, o, d, near, torch.where(alive, INF, 0.0))
        did_hit = (hit.prim >= 0) & alive

        if media:
            ms, smp = _medium_interaction(scene, smp, medium, o, d,
                                          torch.where(did_hit, hit.t, INF), alive,
                                          first_scatter, med_bounce)
            throughput = throughput * torch.where(alive[..., None], ms.weight, 1.0)
            scattered = ms.scattered & alive
            hit_surface = ms.exited & did_hit
            alive = alive & (scattered | hit_surface)
            # volume -> camera (volumeLensSample)
            mi = torch.clamp(medium, min=0)
            ptype, g = scene.media.phase_type[mi], scene.media.phase_g[mi]
            dc, distc, cw, pix, vld = camera_sample_direct(scene.camera, meta, ms.p)
            fp = phase_eval(ptype, g, d, dc)
            candv = scattered & vld
            wv, hv = _trace_transparent(
                scene, ms.p, dc, torch.where(candv, distc * SHADOW_FUDGE, 0.0),
                torch.where(candv, medium, -1), ~ones, ones)
            splat_filtered(buf, pix, throughput * wv * (fp * cw)[:, None],
                           candv & (hv.prim < 0), meta.res_x, meta.res_y, meta.filter)
            u_ph, smp = smp.next_2d()
            w_phase, _ = phase_sample(ptype, g, d, u_ph)
            med_bounce = torch.where(scattered, med_bounce + 1, med_bounce)
            first_scatter = first_scatter & ~scattered
        else:
            smp = smp.skip(6)
            scattered = ~ones
            hit_surface = did_hit
            alive = alive & did_hit

        # the surface vertex: connect to the camera, continue adjointly
        p, ng, ns, uv, mat_id, _ = _shading_data(scene, hit, o, d)
        mat_pre = gather(mats, texs, mat_id, uv)
        frame, wi = _local_frame(meta, ns, d, mat_pre[3])
        _connect_to_camera(scene, buf, p, ng, frame, wi, mat_pre, uv, throughput, medium,
                           hit_surface, hit.prim)

        u_c2, smp = smp.next_2d()
        u_c1, smp = smp.next_1d()
        bs = bsdf_sample(mats, mat_pre, uv, wi, u_c2, u_c1, textures=texs)
        wo_w = vo.to_global(*frame, bs.wo)
        eta2 = bsdf_eta_sq(mats, mat_pre, wi, bs.wo)
        corr = _adjoint_correction(wi, bs.wo, vo.to_global(*frame, wi), wo_w, ng)
        adj_weight = bs.weight * (corr / torch.clamp(eta2, min=1e-20))[..., None]
        throughput = throughput * torch.where(hit_surface[..., None], adj_weight, 1.0)
        alive = alive & torch.where(hit_surface, bs.valid, True)
        if media:
            medium, first_scatter, med_bounce = _medium_handoff(
                scene, hit.prim, wo_w, ng, hit_surface, medium, first_scatter, med_bounce)
            o = vo.where3(scattered, ms.p, p)
            d = vo.where3(scattered, w_phase, wo_w)
        else:
            o, d = p, wo_w
        alive = alive & (vo.max3(torch.abs(throughput)) > 0.0)
        u_rr, smp = smp.next_1d()
        throughput, alive = _roulette(throughput, alive, u_rr, bounce)
        near = torch.where(scattered, 0.0, DEFAULT_EPSILON)
        bounce += 1
    return torch.where(torch.isfinite(buf), buf, 0.0)


def trace_light_batch(scene: FlatScene, seed, lane_ids, base_pass: int, n_passes: int = 1):
    """The summed splat buffers of n_passes light-trace passes; pass i runs
    under the seed (seed[0], LT_PASS_SEED + base_pass + i)
    (light_tracer.py:127-141)."""
    n_pix = scene.meta.res_x * scene.meta.res_y
    acc = torch.zeros((n_pix, 3), device=lane_ids.device)
    for i in range(n_passes):
        acc = acc + trace_light_pass(scene, (seed[0], LT_PASS_SEED + base_pass + i), lane_ids)
    return acc
