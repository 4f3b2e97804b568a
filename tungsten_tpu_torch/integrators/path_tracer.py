"""Wavefront path tracers with NEE and MIS (torch): regenerating and lockstep.

Port of `trace_regen_batch`, `_trace_pass_fast` / `trace_pass` (both its
branches) / `trace_batch` and the helpers they call from
tungsten_tpu/integrators/path_tracer.py (lines 67-255, 278-412, 558-1232,
1236-2111) for the port's configuration: triangles and analytic prims,
every surface BSDF but the fibers, every light of the JAX flatten but the
skydome (area lights, analytic emitters with a disk's emission cone, any
number of envs, sampled or not, spherical caps, point lights with MIS
weight 1), the depth / normal / albedo AOVs (`_record_aovs`), the
participating media (homogeneous, exponential, atmosphere, voxel; every
transmittance model and phase function), no sample table. Forward lobes
(thinsheet, transparency, forward) take the lockstep tracer's crossing-walk
branch (`_trace_pass_forward`); regen refuses them, as the JAX package does.

Media (path_tracer.py's media lines): each lane carries its medium (-1 =
vacuum; the camera's at the start), and the MediumState {first_scatter,
med_bounce}. A bounce first samples the distance to a medium event
(`_medium_interaction`, three sampler dims; voxel media walk their grid
with K6, ops/grid_walk.py). A lane that scatters there is a medium vertex:
NEE with the phase function in place of the BSDF (`_unified_nee_prepare`,
regen's light strategy; `_volume_nee` on the forward branch), each shadow
segment attenuated by the medium on its side of the vertex
(`_select_medium_dir`, `medium_transmittance`), and the continuation by
phase sampling from the scatter point, near 0. A surface crossing hands the
lane over to the primitive's interior or exterior medium
(`_medium_handoff`). The JAX package's `_compact_sort` (a lane permutation
that changes no result) and the MLT sample table are not carried.

Regenerating (`trace_regen_batch`): a fixed-width wavefront of W lanes runs
the bounce loop; a lane whose path ends respawns a camera path from the
budget of n_passes * W paths. Single-sample MIS: the light strategy pairs
with the continuation sample, whose hit on an emitter (or escape to the env)
is weighted at the next vertex. Per iteration:

  sampler window prefetch -> shading data -> hit-emitter MIS -> one material
  gather + masked BSDF dispatch -> light choice and sample -> continuation +
  Russian roulette -> regen -> ONE 2N-lane walk carrying the shadow rays
  and the next rays -> one scatter-add into rad_pix.

Lockstep (`trace_pass` -> `_trace_pass_fast`, summed over passes by
`trace_batch`): every lane traces one path, all lanes bounce together. The
estimator is the reference's (TraceBase::estimateDirect): at each vertex one
chosen light, a light-strategy shadow ray and a separate bsdf-strategy ray.
Per bounce the shadow rays take the any-hit walk (`_occluded_raw`) and the
[bsdf-strategy | continuation] rays share ONE 2N-lane closest-hit walk
(`_intersect`). With forward lobes (`_trace_pass_forward`) a bounce walks
the path's ray, then both strategies' rays in one 2N-lane crossing walk
(`_trace_transparent`: up to 8 closest-hit walks, each crossing a
forward-lobed surface).

The intersector dispatch is the JAX package's TPU route (`_intersect`,
`_intersect_tris`, `_intersect_mixed`, `_occluded_raw`): analytic prims
first, their t clipping the triangle walk; then the first pack the scene
carries, pbvh8 (K3: closest hit through the fast walk with its exact repair,
any-hit through the exact walk's latch), gbvh (K1, closest, latched and
mixed in one per-lane walk), pbvh (K5; any-hit through K4 where pbvh3 is
there) or ptris (K2, which every scene has); brute force at 64 triangles or
fewer. The JAX package takes gbvh first on the TPU; the port keeps K3
first, its measured main path, and K1 second. The regen 2N walk latches the
shadow lanes (any-hit) on K3 and K1 and is a plain closest-hit walk on the
other routes (same booleans).

RNG streams key on the global path id (regen) or on (pass, lane) (lockstep),
so the image is a pure function of the seed as in the JAX package. Each loop
condition is one `.item()` per iteration (the JAX package's lax.while_loop
runs on the device).

Spans (utils/trace.py, recorded while a recording is open): `pt.batch` a
call of trace_regen_batch or trace_batch, in it `pt.iter` a regen iteration
or a lockstep bounce, run by its phases `pt.shade`, `pt.nee` and
`pt.refill` (regen: the respawn and the deposit) beside the walks'
`pt.walk` (with the counters walk.lanes and walk.live);
`pt.crossing` a crossing walk; `sync.pt.loop` / `sync.pt.crossing` the
loop conditions' reads.
"""
from __future__ import annotations

import contextlib

import torch

from ..math import vecops as vo
from ..models.bsdfs.common import Lobes
from ..models.bsdfs.dispatch import (N_TYPES, bsdf_eval, bsdf_pdf, bsdf_sample,
                                     forward_transparency, gather, stash_substrate)
from ..models.cameras.pinhole import camera_rays_w
from ..models.media.media import medium_sample_distance, medium_transmittance
from ..models.phase.phase import phase_eval, phase_sample
from ..models.primitives import lights as L
from ..models.primitives.analytic import (hit_geom, intersect_analytic, normal_at,
                                          occluded_analytic)
from ..models.textures.textures import eval_texture
from ..ops import bvh, bvh2, bvh8, gather_bvh
from ..ops.intersect import INF, Hit, intersect_brute
from ..ops.intersect_stream import intersect_stream
from ..sampling import warps
from ..sampling.sampler import MASK32, Sampler, _mul32, stratified_cam_2d
from ..scene.flatten import DEFAULT_EPSILON, FlatScene
from ..utils import trace

DIMS_PER_BOUNCE = 24
SHADOW_FUDGE = 1.0 - 1e-3  # cf. attenuatedEmission's 1+1e-3 (TraceBase.cpp:155)


BRUTE_MAX_TRIS = 64  # at or below: brute force, no pack (path_tracer.py:90, :106)

@contextlib.contextmanager
def count_bsdf_hits(device):
    """Count the surface vertices both tracers shade, per BSDF type id,
    while the context is open: yields a dict that holds {type id: hits}
    (types hit at least once) on exit. The counts are the recorder's device
    counter `bsdf.hits` (utils/trace.py; a recording opens for the block
    where none is open), read once on exit; `device` is the renders'. Off,
    it costs one `is None` test an iteration; on, one index_add_ an
    iteration, with no host sync."""
    out = {}
    with trace.recording(counters=("bsdf.hits",)) as rec:
        yield out
    hits = rec.totals["bsdf.hits"]
    out.update({t: n for t, n in enumerate(hits[:N_TYPES] if hits else ()) if n})


@contextlib.contextmanager
def count_light_choices(device):
    """Count the light rows that NEE chooses at the vertices where it runs,
    in both tracers, while the context is open: yields a dict that holds
    {light index: choices} (rows chosen at least once) on exit;
    `lights.light_kinds(scene)` names each row's kind. The counts are the
    recorder's device counter `light.choices`, as count_bsdf_hits's. Off, it
    costs one `is None` test a bounce; on, one index_add_ a bounce, with no
    host sync."""
    out = {}
    with trace.recording(counters=("light.choices",)) as rec:
        yield out
    out.update({i: n for i, n in enumerate(rec.totals["light.choices"] or ()) if n})


def _count_choices(rec, li, lanes, n_lights):
    """Add the chosen light rows of `lanes` to the recording's count."""
    rec.index_add("light.choices", n_lights, li, lanes)


def _count_hits(rec, shaded, mtype):
    """Add the shaded lanes' BSDF types to the recording's count (the last
    slot takes the other lanes)."""
    rec.index_add("bsdf.hits", N_TYPES + 1, torch.where(shaded, mtype, N_TYPES),
                  torch.ones_like(mtype))


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
    carries: pbvh8 (K3), gbvh (K1), pbvh (K5), else ptris (K2)
    (path_tracer.py:87-108). The JAX package takes gbvh first on the TPU;
    the port keeps K3 first, its measured main path."""
    if scene.tris.v0.shape[0] <= BRUTE_MAX_TRIS:
        return intersect_brute(scene.tris, o, d, tnear, tfar)
    if scene.pbvh8 is not None:
        return bvh8.intersect(scene.pbvh8, scene.tris, o, d, tnear, tfar)
    if scene.gbvh is not None:
        return gather_bvh.intersect_bvh_gather(scene.gbvh, o, d, tnear, tfar)
    if scene.pbvh is not None:
        return bvh.intersect_bvh(scene.pbvh, o, d, tnear, tfar)
    return intersect_stream(scene.ptris, o, d, tnear, tfar)


def _intersect(scene: FlatScene, o, d, tnear, tfar) -> Hit:
    """Closest hit over triangles and analytic prims."""
    with trace.walk(o.shape[0], tnear, tfar):
        return _with_analytic(scene, o, d, tnear, tfar,
                              lambda far: _intersect_tris(scene, o, d, tnear, far))


def _intersect_mixed(scene: FlatScene, o, d, tnear, tfar, latch) -> Hit:
    """ONE walk for a mixed [any-hit | closest-hit] wavefront: on K3, else
    on K1, latched lanes stop at their first hit (only prim >= 0 is
    meaningful); the other routes run closest hit on every lane, which gives
    the same booleans (path_tracer.py:1171-1198)."""
    with trace.walk(o.shape[0], tnear, tfar):
        if scene.tris.v0.shape[0] <= BRUTE_MAX_TRIS:
            return _intersect(scene, o, d, tnear, tfar)
        if scene.pbvh8 is not None:
            return _with_analytic(scene, o, d, tnear, tfar, lambda far: bvh8.intersect_mixed(
                scene.pbvh8, scene.tris, o, d, tnear, far, latch))
        if scene.gbvh is not None:
            return _with_analytic(scene, o, d, tnear, tfar, lambda far: (
                gather_bvh.intersect_bvh_gather_mixed(scene.gbvh, o, d, tnear, far, latch)))
        return _intersect(scene, o, d, tnear, tfar)


def _shading_data(scene: FlatScene, hit: Hit, o, d):
    """Gather surface info for hit lanes (garbage where prim < 0, masked out
    by the caller): ONE packed row gather per lane -> (p, ng, ns, uv, mat,
    light id). An analytic hit (virtual id >= T) takes Ns = Ng =
    normal_at(p) and uv = (hit.u, hit.v) (path_tracer.py:111-138)."""
    tri = torch.clamp(hit.prim, min=0)
    p = o + d * hit.t[..., None]
    u = hit.u[..., None]
    v = hit.v[..., None]
    w0 = 1.0 - u - v
    row = scene.shade_pack[tri]
    ng = row[..., 0:3]
    ns = vo.normalize(row[..., 3:6] * w0 + row[..., 6:9] * u + row[..., 9:12] * v)
    uv = row[..., 12:14] * w0 + row[..., 14:16] * u + row[..., 16:18] * v
    mat = row[..., 18].to(torch.int64)
    light = row[..., 19].to(torch.int64)
    if scene.ana is not None:
        n_tris = scene.tris.v0.shape[0]
        is_a = (hit.prim >= n_tris)[..., None]
        ng_a = normal_at(scene.ana, hit.prim - n_tris, p)
        ng = torch.where(is_a, ng_a, ng)
        ns = torch.where(is_a, ng_a, ns)
        uv = torch.where(is_a, torch.cat([u, v], -1), uv)
    return p, ng, ns, uv, mat, light


def _occluded_raw_tris(scene: FlatScene, p, d, near, far):
    """Any-hit over the triangles: pbvh8 -> K3's latch (exact f32: a phantom
    of the fast walk would occlude falsely), gbvh -> K1 with every lane
    latched, pbvh3 -> K4's any-hit walk, else the closest hit's prim >= 0
    (path_tracer.py:1213-1232)."""
    if scene.tris.v0.shape[0] > BRUTE_MAX_TRIS:
        if scene.pbvh8 is not None:
            return bvh8.occluded(scene.pbvh8, p, d, near, far)
        if scene.gbvh is not None:
            return gather_bvh.occluded_bvh_gather(scene.gbvh, p, d, near, far)
        if scene.pbvh3 is not None:
            return bvh2.occluded_bvh3(scene.pbvh3, p, d, near, far)
    return _intersect_tris(scene, p, d, near, far).prim >= 0


def _occluded_raw(scene: FlatScene, p, d, near, far):
    """Any-hit boolean for explicit [near, far] segments (the shadow
    strategy): analytic prims first; the lanes they block skip the triangle
    walk (far = 0) (path_tracer.py:1201-1210)."""
    with trace.walk(p.shape[0], near, far):
        if scene.ana is None:
            return _occluded_raw_tris(scene, p, d, near, far)
        blocked_a = occluded_analytic(scene.ana, p, d, near, far)
        return blocked_a | _occluded_raw_tris(scene, p, d, near,
                                              torch.where(blocked_a, 0.0, far))


def _shading_frame(scene: FlatScene, tri, ns, flip):
    """Local shading frame (t, b, n) with the two-sided flip applied.

    On a fiber (curve) triangle the frame follows the reference's
    Curves::tangentSpace convention (Curves.cpp:517-528; path_tracer.py
    :1100-1121): b = the fiber tangent, t = b x n, n = t x b; the fiber
    BCSDFs read sin(theta) = dir.y and measure phi in the (x, z) plane.
    `tri`: the hit's row in FlatScene.tri_tan (clamped, as the JAX gather)."""
    t_ax, b_ax = vo.tangent_frame(ns)
    n_ax = ns
    if scene.meta.has_fiber_tan:
        tan = scene.tri_tan[torch.clamp(tri, 0, scene.tri_tan.shape[0] - 1)]
        has = vo.length_sq(tan) > 1e-12
        b2 = vo.normalize(tan, eps=1e-12)
        t2 = vo.normalize(vo.cross(b2, ns), eps=1e-12)
        n2 = vo.cross(t2, b2)
        t_ax = vo.where3(has, t2, t_ax)
        b_ax = vo.where3(has, b2, b_ax)
        n_ax = vo.where3(has, n2, n_ax)
    t_ax = vo.where3(flip, -t_ax, t_ax)
    n_ax = vo.where3(flip, -n_ax, n_ax)
    return t_ax, b_ax, n_ax


def _local_frame(scene: FlatScene, prim, ns, d, lobes):
    """(frame, wi): the shading frame of the hit `prim`, flipped where a
    backside hit meets a non-transmissive material under two-sided shading
    (makeLocalScatterEvent, TraceBase.cpp:24-51), and -d in it."""
    hit_backside = vo.dot(ns, d) > 0.0
    if scene.meta.enable_two_sided:
        flip = hit_backside & ~Lobes.is_transmissive(lobes)
    else:
        flip = torch.zeros_like(hit_backside)
    frame = _shading_frame(scene, torch.clamp(prim, min=0), ns, flip)
    return frame, vo.to_local(*frame, -d)


def _select_medium_dir(scene: FlatScene, medium, prim, d_dir, on_surface, p=None):
    """Primitive::selectMedium for a ray LEAVING a surface vertex along d_dir
    (Primitive.hpp:177-183; path_tracer.py:255-275): the interior or exterior
    medium by the side of the geometric normal d_dir leaves through, where
    the primitive overrides media; medium-scatter (non-surface) lanes keep
    the current medium. p: the vertex, for the analytic prims' normals."""
    tri = torch.clamp(prim, min=0)
    ng = scene.tri_ng[tri]
    if scene.ana is not None and p is not None:
        n_tris = scene.tris.v0.shape[0]
        ng = torch.where((prim >= n_tris)[..., None], normal_at(scene.ana, prim - n_tris, p), ng)
    backside = vo.dot(d_dir, ng) < 0.0
    override = scene.tri_med_override[tri] & on_surface & (prim >= 0)
    sel = torch.where(backside, scene.tri_med_int[tri], scene.tri_med_ext[tri])
    return torch.where(override, sel, medium)


def _medium_handoff(scene: FlatScene, prim, wo, ng, lanes, medium, first_scatter, med_bounce):
    """The medium state after the continuation leaves a surface along wo on
    `lanes` (selectMedium at the crossing, Primitive.hpp:177; path_tracer.py
    :1656-1668): the primitive's interior or exterior medium where it
    overrides media, a fresh MediumState. -> (medium, first_scatter,
    med_bounce)."""
    tri = torch.clamp(prim, min=0)
    backside = vo.dot(wo, ng) < 0.0
    override = scene.tri_med_override[tri] & lanes
    new_med = torch.where(backside, scene.tri_med_int[tri], scene.tri_med_ext[tri])
    return (torch.where(override, new_med, medium), torch.where(lanes, True, first_scatter),
            torch.where(lanes, 0, med_bounce))


def _medium_interaction(scene: FlatScene, smp: Sampler, medium, o, d, far, alive, first_scatter,
                        med_bounce):
    """Sample the distance to the next medium event on every live lane
    (PathTracer.cpp:52-62; path_tracer.py:817-847, 1396-1420): three sampler
    dims. Dead lanes are passed as vacuum: the tracers never read their
    sample, so their grid walks are skipped. -> (MediumSample, sampler)."""
    u_mc, smp = smp.next_1d()
    u_md, smp = smp.next_1d()
    u_mb, smp = smp.next_1d()
    ms = medium_sample_distance(scene.media, torch.where(alive, medium, -1), o, d, far,
                                first_scatter, med_bounce, u_mc, u_md, u_mb)
    return ms, smp


def _nee_gate(meta, hit_surface_lane, scattered, med_bounce, bounce):
    """The vertices whose NEE counts: surface vertices, and medium vertices
    with volume light sampling on (past the first medium bounce unless
    low_order_scattering), before the last bounce (path_tracer.py:1547-1557).
    med_bounce: the lanes' medium bounces after this vertex's."""
    gate = ((hit_surface_lane | (scattered & meta.enable_volume_light_sampling))
            & (bounce < meta.max_bounces - 1))
    if meta.has_media and not meta.low_order_scattering:
        gate = gate & torch.where(scattered, med_bounce > 1, True)
    return gate


def _sample_chosen_light(scene: FlatScene, smp: Sampler, li, is_env_choice, p):
    """sampleDirect of the chosen light li as seen from p: the area (or
    analytic) sample, replaced by the env's, the cap's or the point's where
    one of those was chosen (path_tracer.py:1146-1166). Draws a point pair,
    then the triangle pick (the pending half of the choice's draw, where
    there is one). Returns (LightSample, is_cap, is_point, sampler)."""
    meta = scene.meta
    u_point, smp = smp.next_2d()
    u_tri, smp = smp.next_1d()
    ls = L.sample_area_direct(scene, li, p, u_tri, u_point)
    if any(i >= 0 for i in meta.env_light_idx):
        ls = L._merge_ls(is_env_choice, L.sample_env_direct(scene, li, u_point), ls)
    is_cap = is_point = torch.zeros_like(is_env_choice)
    if any(i >= 0 for i in meta.cap_light_idx):
        is_cap = scene.lights.cap_slot[li] >= 0
        ls = L._merge_ls(is_cap, L.sample_cap_direct(scene, li, u_point), ls)
    if meta.point_light_index >= 0:
        is_point = scene.lights.pt_slot[li] >= 0
        ls = L._merge_ls(is_point, L.sample_point_direct(scene, li, p), ls)
    return ls, is_cap, is_point, smp


def _choose_and_sample_light(scene: FlatScene, smp: Sampler, p):
    """Radiance-weighted light choice (TraceBase::chooseLight) + sampleDirect
    over the light kinds (area / analytic / env / cap / point). Consumes 4
    sampler dims. Returns (li, is_env, is_cap, is_point, LightSample,
    choice_pdf, sampler); LightSample.pdf excludes the choice pdf. With one
    light the choice, its pdf and whether it is an env are static
    (path_tracer.py:1123-1168)."""
    meta = scene.meta
    n = p.shape[0]
    u_choose, smp = smp.next_1d()
    if meta.n_lights == 1:
        li = torch.zeros((n,), dtype=torch.int64, device=p.device)
        choice_pdf = torch.ones((n,), device=p.device)
        is_env_choice = torch.full((n,), 0 in meta.env_light_idx, device=p.device)
    else:
        li, choice_weight = L.choose_light(scene, u_choose, p)
        choice_pdf = torch.where(choice_weight > 0.0,
                                 1.0 / torch.clamp(choice_weight, min=1e-30), 0.0)
        is_env_choice = scene.lights.is_env[li]
    ls, is_cap, is_point, smp = _sample_chosen_light(scene, smp, li, is_env_choice, p)
    return li, is_env_choice, is_cap, is_point, ls, choice_pdf, smp


def _aov_state(n, dev):
    """A lane's AOV fields, zero (path_tracer.py:789-795)."""
    return dict(aov_recorded=torch.zeros((n,), dtype=torch.bool, device=dev),
                aov_depth=torch.zeros((n,), device=dev), aov_dist=torch.zeros((n,), device=dev),
                aov_normal=torch.zeros((n, 3), device=dev),
                aov_albedo=torch.zeros((n, 3), device=dev))


def _record_aovs(s, did_hit, t, shaded, lobes, ns, albedo, light_id, e_hit):
    """The AOVs of a path's first non-specular surface vertex
    (PathTracer.cpp:78-96; path_tracer.py:887-898): depth is the distance
    the path travelled to it (aov_dist sums every hit's t), normal the
    shading normal, albedo the albedo texture plus an emitter's emission
    (e_hit, None without surface emitters). `shaded`: the lanes that shade a
    surface here. Returns the lane's new AOV fields."""
    dist = s["aov_dist"] + torch.where(did_hit, t, 0.0)
    rec = shaded & ~s["aov_recorded"] & ~Lobes.is_pure_specular(lobes)
    if e_hit is not None:
        albedo = albedo + torch.where((light_id >= 0)[..., None], e_hit, 0.0)
    return dict(aov_recorded=s["aov_recorded"] | rec, aov_dist=dist,
                aov_depth=torch.where(rec, dist, s["aov_depth"]),
                aov_normal=vo.where3(rec, ns, s["aov_normal"]),
                aov_albedo=vo.where3(rec, albedo, s["aov_albedo"]))


def _aux(aov):
    """The tracers' AOV output {depth, normal, albedo} from the lane fields."""
    return dict(depth=aov["aov_depth"], normal=aov["aov_normal"], albedo=aov["aov_albedo"])


def _deposit(buf, idx, val):
    """buf[idx] += val, the lanes that share a pixel summed in one fixed
    order, so that a render is a function of its seed bit for bit (a resumed
    render equals a straight one): on the card index_add_ adds with atomics
    in any order, while index_put_ with accumulate sorts the indices first;
    on the CPU index_add_ adds them one after another."""
    if buf.is_cuda:
        buf.index_put_((idx,), val, accumulate=True)
    else:
        buf.index_add_(0, idx, val)


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
    smp = Sampler.create(seed, lane_key, samp_idx=samp_idx, pix_key=pix_key, strat=strat)
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
    if "medium" in s:  # a respawned path starts in the camera's medium
        out["medium"] = torch.where(take, meta.camera_medium, s["medium"])
        out["first_scatter"] = s["first_scatter"] | take
        out["med_bounce"] = torch.where(take, 0, s["med_bounce"])
    if "aov_dist" in s:  # a respawned path starts its AOVs afresh
        out["aov_recorded"] = s["aov_recorded"] & ~take
        out["aov_depth"] = torch.where(take, 0.0, s["aov_depth"])
        out["aov_dist"] = torch.where(take, 0.0, s["aov_dist"])
        out["aov_normal"] = torch.where(t3, 0.0, s["aov_normal"])
        out["aov_albedo"] = torch.where(t3, 0.0, s["aov_albedo"])
    return out


@trace.spanned("pt.batch")
def trace_regen_batch(scene: FlatScene, seed, px_cycle, py_cycle, pix_cycle,
                      pass_base: int, n_passes: int = 1):
    """Regenerating wavefront PT over W = len(px_cycle) lanes and
    n_passes * W paths. seed: (s0, s1) uint32 pair. Returns rad (n_pix, 3),
    the per-pixel radiance SUM, and with AOVs (rad, {depth (n_pix,), normal
    (n_pix, 3), albedo (n_pix, 3)}), the per-pixel sums of the finished
    paths' AOVs (path_tracer.py:1771-1775)."""
    meta = scene.meta
    if meta.has_forward:  # path_tracer.py:1262 asserts the same
        raise NotImplementedError("regen path: forward lobes need trace_pass (lockstep)")
    want_aovs = bool(meta.aovs)
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

    with trace.span("sync.h2d.state"):  # a host list copied up: the stream waits
        z_dir = torch.tensor([0.0, 0.0, 1.0], device=dev)
    state = dict(
        o=full(0.0, shape=(W, 3)),
        d=z_dir.expand(W, 3),
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
    media = meta.has_media
    if media:
        state.update(medium=full(meta.camera_medium, torch.int64),
                     first_scatter=full(True, torch.bool), med_bounce=full(0, torch.int64))
    if want_aovs:
        state.update(_aov_state(W, dev))
    # per pixel: radiance, and with AOVs depth, normal and albedo; one deposit
    acc_pix = torch.zeros((n_pix, 10 if want_aovs else 3), dtype=torch.float32, device=dev)

    def regen(s):
        return _regen(scene, s, seed, px_cycle, py_cycle, pix_cycle, pass_base, W, total, strat)

    with trace.span("pt.refill"):
        state = regen(state)
    hit = _intersect(scene, state["o"], state["d"], state["near"],
                     torch.where(state["alive"], INF, 0.0))
    texs = scene.textures
    latch2 = torch.cat([full(True, torch.bool), full(False, torch.bool)])

    while trace.to_host("sync.pt.loop", state["alive"].any()):
        with trace.span("pt.iter") as it:
            it.phase("pt.shade")
            s = state
            bounce = s["bounce"]
            smp = Sampler(seed, s["lane_key"], 2 + bounce * DIMS_PER_BOUNCE, s["samp_idx"],
                          s["pix_key"], strat).prefetch(8)
            o, d, alive = s["o"], s["d"], s["alive"]
            throughput, emission = s["throughput"], s["emission"]
            did_hit = (hit.prim >= 0) & alive

            # ---- medium interaction (path_tracer.py:1396-1420) ----
            if media:
                medium, first_scatter = s["medium"], s["first_scatter"]
                med_bounce = s["med_bounce"]
                ms, smp = _medium_interaction(scene, smp, medium, o, d,
                                              torch.where(did_hit, hit.t, INF), alive,
                                              first_scatter, med_bounce)
                if scene.media.has_emissive_grid:  # before the weight (PathTracer.cpp:56-57)
                    emission = emission + torch.where(alive[..., None], throughput * ms.emission,
                                                      0.0)
                throughput = throughput * torch.where(alive[..., None], ms.weight, 1.0)
                scattered = ms.scattered & alive
                hit_surface_lane = ms.exited & did_hit
                alive = alive & (scattered | hit_surface_lane)
                med_bounce = torch.where(scattered, med_bounce + 1, med_bounce)
                first_scatter = first_scatter & ~scattered
                mi = torch.clamp(medium, min=0)
                ptype, g = scene.media.phase_type[mi], scene.media.phase_g[mi]
            else:
                smp = smp.skip(3)
                scattered = full(False, torch.bool)
                hit_surface_lane = did_hit
                alive = alive & did_hit

            # ---- misses: environment, MIS against the previous light sample ----
            miss = s["alive"] & (hit.prim < 0) & ~scattered
            mis_applies = ((~s["was_specular"] & s["nee_active"]) if do_nee
                           else torch.zeros_like(miss))
            if meta.has_env or meta.has_cap:
                if do_nee:
                    lp_inf = (L.infinite_winner_pdf(scene, d)
                              * L.infinite_winner_choice_pdf(scene, d, o))
                    w_env = torch.where(mis_applies,
                                        warps.power_heuristic(s["pdf_cont"], lp_inf), 1.0)
                else:
                    w_env = full(1.0)
                add_env = miss & (bounce >= meta.min_bounces)
                emission = emission + torch.where(
                    add_env[..., None],
                    throughput * L.infinite_radiance(scene, d) * w_env[..., None], 0.0)

            # ---- surface shading data + ONE material gather ----
            p, ng, ns, uv, mat_id, light_id = _shading_data(scene, hit, o, d)
            # with gpack3 the gather brings the substrate rows too: stashed for
            # the wrappers' nested calls (path_tracer.py:1459-1466)
            mats, mat_pre = stash_substrate(scene.materials, gather(scene.materials, texs,
                                                                    mat_id, uv))
            if (rec := trace.counter("bsdf.hits")) is not None:
                _count_hits(rec, hit_surface_lane, mat_pre[1])
            lobes = mat_pre[3]
            frame, wi = _local_frame(scene, hit.prim, ns, d, lobes)

            # ---- hit an emitter: MIS against the previous vertex's light strategy ----
            if scene.lights.has_surface:
                li_hit = torch.clamp(light_id, min=0)
                geo_front = -vo.dot(d, ng) > torch.clamp(scene.lights.cone_cos[li_hit], min=0.0)
                if do_nee:
                    lp_hit = (L.area_direct_pdf(scene, torch.clamp(hit.prim, min=0), o, p, d)
                              * L.light_choice_pdf(scene, li_hit, o))
                    w_emit = torch.where(mis_applies,
                                         warps.power_heuristic(s["pdf_cont"], lp_hit), 1.0)
                else:
                    w_emit = full(1.0)
                add_emit = (hit_surface_lane & (light_id >= 0) & geo_front
                            & (bounce >= meta.min_bounces))
                e_hit = eval_texture(texs, scene.lights.tex[li_hit], uv,
                                     may=scene.lights.emit_kinds)
                emission = emission + torch.where(
                    add_emit[..., None], throughput * e_hit * w_emit[..., None], 0.0)
            else:
                e_hit = None
            if want_aovs:
                aov = _record_aovs(s, did_hit, hit.t, hit_surface_lane, lobes, ns, mat_pre[2],
                                   light_id, e_hit)

            vp = vo.where3(scattered, ms.p, p) if media else p
            throughput_vertex = throughput

            # ---- NEE: light strategy only (the continuation is the bsdf half) ----
            if do_nee:
                it.phase("pt.nee")
                li, is_env_c, is_cap_c, is_point_c, ls, cp_pick, smp = _choose_and_sample_light(
                    scene, smp, vp)
                wo_l = vo.to_local(*frame, ls.d)
                f_l = bsdf_eval(mats, mat_pre, uv, wi, wo_l, nonspecular_only=True,
                                textures=texs)
                # the competing strategy is the continuation sampler's density
                # over continuous directions: the full pdf, lobe choice included
                pdf_b = bsdf_pdf(mats, mat_pre, uv, wi, wo_l, textures=texs)
                if media:  # a medium vertex: the phase function (path_tracer.py:1532-1540)
                    fp = phase_eval(ptype, g, d, ls.d)
                    f_l = torch.where(scattered[..., None], fp[..., None], f_l)
                    pdf_b = torch.where(scattered, fp, pdf_b)
                w_light = warps.power_heuristic(ls.pdf * cp_pick, pdf_b)
                w_light = torch.where(is_point_c, 1.0, w_light)  # dirac: no bsdf strategy
                if L.any_infinite_sampled(meta):
                    # a masked infinite choice: the continuation's escape credits
                    # only the LAST infinite light that ls.d meets; where that is
                    # not the chosen light, the light strategy is its only
                    # estimator and takes weight 1 (path_tracer.py:1582-1593)
                    wl_d, _, _ = L.escape_winner(scene, ls.d, want_radiance=False)
                    w_light = torch.where((is_env_c | is_cap_c) & (wl_d != li), 1.0, w_light)
                skip_l = (Lobes.is_pure_specular(lobes) | (lobes == Lobes.FORWARD)
                          | (lobes == 0)) & ~scattered
                nee_gate = _nee_gate(meta, hit_surface_lane, scattered,
                                     med_bounce if media else None, bounce)
                if (rec := trace.counter("light.choices")) is not None:
                    _count_choices(rec, li, nee_gate, meta.n_lights)
                cand = (ls.valid & (ls.pdf > 0.0) & torch.any(f_l > 0.0, dim=-1)
                        & ~skip_l & nee_gate)
                shadow_far = torch.where(
                    cand, torch.where(ls.dist >= INF, INF, ls.dist * SHADOW_FUDGE), 0.0)
                near_nee = torch.where(scattered, 0.0, DEFAULT_EPSILON)
                contrib_l = f_l * ls.radiance * (
                    w_light / torch.clamp(ls.pdf * cp_pick, min=1e-30))[..., None]
                if media:  # the shadow segment's transmittance (path_tracer.py:1601-1613)
                    med_l = _select_medium_dir(scene, medium, hit.prim, ls.d, hit_surface_lane,
                                               p=vp)
                    contrib_l = contrib_l * medium_transmittance(
                        scene.media, torch.where(cand, med_l, -1), ls.dist, ~scattered,
                        torch.ones_like(cand), vp, ls.d)
                contrib_l = torch.where(
                    torch.all(torch.isfinite(contrib_l), dim=-1)[..., None], contrib_l, 0.0)
                nee_add = torch.where(cand[..., None], throughput_vertex * contrib_l, 0.0)
            else:
                smp = smp.skip(4)
                nee_gate = full(False, torch.bool)
                nee_add = None

            # ---- continuation sample ----
            it.phase("pt.shade")
            u_c2, smp = smp.next_2d()
            u_c1, smp = smp.next_1d()
            bs = bsdf_sample(mats, mat_pre, uv, wi, u_c2, u_c1, textures=texs)
            wo_w = vo.to_global(*frame, bs.wo)
            pdf_cont = bs.pdf
            weight_step = bs.weight
            was_specular = s["was_specular"]
            if media:  # a medium vertex continues by the phase function (:1576-1590)
                w_phase, pdf_phase = phase_sample(ptype, g, d, u_c2)
                wo_w = vo.where3(scattered, w_phase, wo_w)
                pdf_cont = torch.where(scattered, pdf_phase, pdf_cont)
                weight_step = torch.where(scattered[..., None], 1.0, weight_step)
                was_specular = torch.where(scattered, not meta.enable_volume_light_sampling,
                                           was_specular)
            throughput = throughput * torch.where(alive[..., None], weight_step, 1.0)
            was_specular = torch.where(hit_surface_lane, Lobes.has_specular(bs.lobe), was_specular)
            alive = alive & torch.where(hit_surface_lane, bs.valid, True)
            if media:
                medium, first_scatter, med_bounce = _medium_handoff(
                    scene, hit.prim, wo_w, ng, hit_surface_lane, medium, first_scatter, med_bounce)
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
            it.phase("pt.refill")
            fin = s["alive"] & ~alive
            em_clean = torch.where(torch.isfinite(emission), emission, 0.0)
            dep_val = torch.where(fin[..., None], em_clean, 0.0)
            old_pix = s["pix"]
            s2 = dict(s)
            s2.update(o=vp, d=wo_w, near=torch.where(scattered, 0.0, DEFAULT_EPSILON),
                      throughput=throughput, emission=emission, alive=alive,
                      was_specular=was_specular, bounce=bounce + 1, pdf_cont=pdf_cont,
                      nee_active=nee_gate)
            if media:
                s2.update(medium=medium, first_scatter=first_scatter, med_bounce=med_bounce)
            if want_aovs:  # a finished path deposits its AOVs (path_tracer.py:1720-1735)
                s2.update(aov)
                fin3 = fin[..., None]
                aov_dep = torch.cat([torch.where(fin3, aov["aov_depth"][..., None], 0.0),
                                     torch.where(fin3, aov["aov_normal"], 0.0),
                                     torch.where(fin3, aov["aov_albedo"], 0.0)], -1)
            s2 = regen(s2)

            # ---- next-ray closest hit merged with the shadow batch: one 2N walk ----
            it.phase(None)
            far_next = torch.where(s2["alive"], INF, 0.0)
            if nee_add is not None:
                h2 = _intersect_mixed(
                    scene, torch.cat([vp, s2["o"]]), torch.cat([ls.d, s2["d"]]),
                    torch.cat([near_nee, s2["near"]]), torch.cat([shadow_far, far_next]), latch2)
                blocked = h2.prim[:n] >= 0
                hit = Hit(t=h2.t[n:], prim=h2.prim[n:], u=h2.u[n:], v=h2.v[n:])
                # finished-path deposit + NEE, by the pre-regen pixel
                dep_val = dep_val + torch.where(blocked[..., None], 0.0, nee_add)
            else:
                hit = _intersect(scene, s2["o"], s2["d"], s2["near"], far_next)
            # ONE scatter a step: radiance and the AOVs side by side
            it.phase("pt.refill")
            _deposit(acc_pix, old_pix,
                     torch.cat([dep_val, aov_dep], -1) if want_aovs else dep_val)
            state = s2
    if want_aovs:
        return acc_pix[:, :3], dict(depth=acc_pix[:, 3], normal=acc_pix[:, 4:7],
                                    albedo=acc_pix[:, 7:10])
    return acc_pix


# ---------------------------------------------------------------------------
# lockstep wavefront: every lane one path, all lanes bounce together
# ---------------------------------------------------------------------------

def _unified_nee_prepare(scene: FlatScene, smp: Sampler, vp, frame, wi, mat_pre, uv, lobes,
                         scattered=None, d_in=None, ptype=None, g=None):
    """NEE setup at a surface or medium vertex: one chosen light, the
    light-sampling and the bsdf-sampling (phase-sampling at the `scattered`
    lanes, incoming direction d_in, phase ptype / g) strategy
    (path_tracer.py:558-647). Consumes 7 sampler dims. Returns the sampler
    and the deferred-ray data; the visibility rays are traced by the caller.
    Both strategies see the non-specular lobes only: a dirac lobe cannot
    meet a sampled light direction."""
    mats, texs = scene.materials, scene.textures
    u_choose, smp = smp.next_1d()
    li, choice_weight = L.choose_light(scene, u_choose, vp)
    is_env_choice = scene.lights.is_env[li]
    ls, _, is_point, smp = _sample_chosen_light(scene, smp, li, is_env_choice, vp)

    # strategy 1: f and pdf at the sampled light direction
    wo_l = vo.to_local(*frame, ls.d)
    f_l = bsdf_eval(mats, mat_pre, uv, wi, wo_l, nonspecular_only=True, textures=texs)
    pdf_fwd = bsdf_pdf(mats, mat_pre, uv, wi, wo_l, nonspecular_only=True, textures=texs)
    if scattered is not None:  # the phase function at the medium vertices
        f_vol = phase_eval(ptype, g, d_in, ls.d)
        f_l = torch.where(scattered[..., None], f_vol[..., None], f_l)
        pdf_fwd = torch.where(scattered, f_vol, pdf_fwd)
    mis_l = warps.power_heuristic(ls.pdf, pdf_fwd)
    mis_l = torch.where(is_point, 1.0, mis_l)  # dirac: no bsdf strategy
    cand = ls.valid & (ls.pdf > 0.0) & torch.any(f_l > 0.0, dim=-1)

    # strategy 2: bsdf (phase) sampling
    u_bs2, smp = smp.next_2d()
    u_bs1, smp = smp.next_1d()
    bs = bsdf_sample(mats, mat_pre, uv, wi, u_bs2, u_bs1, nonspecular_only=True,
                     textures=texs)
    wo_mis, w_mis, pdf_mis = vo.to_global(*frame, bs.wo), bs.weight, bs.pdf
    mis_cand = bs.valid & torch.any(bs.weight > 0.0, dim=-1)
    skip = Lobes.is_pure_specular(lobes) | (lobes == Lobes.FORWARD) | (lobes == 0)
    if scattered is not None:
        w_ph, pdf_ph = phase_sample(ptype, g, d_in, u_bs2)
        wo_mis = vo.where3(scattered, w_ph, wo_mis)
        w_mis = torch.where(scattered[..., None], 1.0, w_mis)
        pdf_mis = torch.where(scattered, pdf_ph, pdf_mis)
        mis_cand = mis_cand | scattered
        skip = skip & ~scattered

    shadow_far = torch.where(
        cand & ~skip, torch.where(ls.dist >= INF, INF, ls.dist * SHADOW_FUDGE), 0.0)
    mis_far = torch.where(mis_cand & ~skip, INF, 0.0)
    return smp, dict(
        li=li, is_env=is_env_choice, ls=ls, f_l=f_l, mis_l=mis_l, cand=cand,
        wo_mis=wo_mis, w_mis=w_mis, pdf_mis=pdf_mis,
        mis_cand=mis_cand, skip=skip, shadow_far=shadow_far, mis_far=mis_far, vp=vp,
        choice_weight=choice_weight)


def _strategy_match(scene: FlatScene, li, is_env_choice, vp, wo, h: Hit):
    """Did the bsdf (phase) strategy's ray from vp along wo, whose closest hit
    is h, reach the chosen light li? Its front side (within a disk's emission
    cone) where li is an area light, or an escape where li is an infinite
    light the ray meets. -> (its radiance e (N, 3), the light pdf, match)."""
    tri_hit = torch.clamp(h.prim, min=0)
    hit_light = torch.where(h.prim >= 0, scene.tri_light[tri_hit], -1)
    hp = vp + wo * h.t[..., None]
    ng_hit, uvh = hit_geom(scene, tri_hit, hp, h.u, h.v)
    front = -vo.dot(wo, ng_hit) > torch.clamp(
        scene.lights.cone_cos[torch.clamp(hit_light, min=0)], min=0.0)
    # e_area is read where li is an area light only, so its kinds suffice
    e_area = eval_texture(scene.textures, scene.lights.tex[li], uvh,
                          may=scene.lights.emit_kinds)
    match_area = ~is_env_choice & (hit_light == li) & front & (h.prim >= 0)
    pdf_area = L.area_direct_pdf(scene, tri_hit, vp, hp, wo)
    if L.any_infinite_sampled(scene.meta):
        m_inf, e_inf, pdf_inf = L.chosen_infinite_eval(scene, li, wo)
        match_inf = (h.prim < 0) & m_inf
        e = torch.where(match_inf[..., None], e_inf,
                        torch.where(match_area[..., None], e_area, 0.0))
        return e, torch.where(match_inf, pdf_inf, pdf_area), match_inf | match_area
    return torch.where(match_area[..., None], e_area, 0.0), pdf_area, match_area


def _unified_nee_finish(scene: FlatScene, data, blocked, h_mis: Hit, w_shadow=None,
                        w_mis_ray=None, medium_l=None, medium_b=None, scattered=None):
    """The visibility results -> the vertex's NEE contribution (N, 3)
    (path_tracer.py:650-722). `blocked` is the shadow strategy's
    occlusion boolean, `h_mis` the bsdf strategy's closest hit: it counts
    where it lands on the front of the chosen area light, or escapes while
    the chosen light is the env. Through forward lobes (`_nee`,
    path_tracer.py:278-412) each strategy's ray carries the transparency of
    the surfaces it crossed: `w_shadow`, `w_mis_ray` (N, 3). With media each
    strategy's ray is attenuated by the medium on its side of the vertex,
    medium_l / medium_b, a segment from a surface unless `scattered`."""
    media = scene.meta.has_media and medium_l is not None
    ls, li, is_env_choice = data["ls"], data["li"], data["is_env"]
    vp, wo_mis = data["vp"], data["wo_mis"]
    contrib_l = data["f_l"] * ls.radiance * (
        data["mis_l"] / torch.clamp(ls.pdf, min=1e-30))[..., None]
    use_l = data["cand"] & ~blocked
    if media:  # lanes whose contribution is dropped skip the grid walks
        contrib_l = contrib_l * medium_transmittance(
            scene.media, torch.where(use_l, medium_l, -1), ls.dist, ~scattered,
            torch.ones_like(use_l), vp, ls.d)
    if w_shadow is not None:
        contrib_l = contrib_l * w_shadow
    contrib_l = torch.where(use_l[..., None], contrib_l, 0.0)

    h = h_mis
    e, light_pdf, match = _strategy_match(scene, li, is_env_choice, vp, wo_mis, h)
    mis_b = warps.power_heuristic(data["pdf_mis"], light_pdf)
    contrib_b = e * data["w_mis"] * mis_b[..., None]
    use_b = data["mis_cand"] & match
    if media:
        contrib_b = contrib_b * medium_transmittance(
            scene.media, torch.where(use_b, medium_b, -1), torch.where(h.prim >= 0, h.t, INF),
            ~scattered, torch.ones_like(use_b), vp, wo_mis)
    if w_mis_ray is not None:
        contrib_b = contrib_b * w_mis_ray
    contrib_b = torch.where(use_b[..., None], contrib_b, 0.0)
    total = (contrib_l + contrib_b) * data["choice_weight"][..., None]
    return torch.where(data["skip"][..., None], 0.0, total)


def _add_hit_emission(scene: FlatScene, emission, throughput, lanes, d, ng, uv, light_id,
                      was_specular, bounce):
    """emission + what the emitters hit on `lanes` send back, counted where
    NEE did not sample it (after a specular bounce, or with light sampling
    off) and only on their front (lockstep; TraceBase::evalDirect). Returns
    (emission, the emitters' radiance e_hit, None without surface emitters)."""
    meta = scene.meta
    if not scene.lights.has_surface:  # no row carries a light id
        return emission, None
    li_hit = torch.clamp(light_id, min=0)
    geo_front = -vo.dot(d, ng) > torch.clamp(scene.lights.cone_cos[li_hit], min=0.0)
    add = lanes & (light_id >= 0) & geo_front & (bounce >= meta.min_bounces)
    if meta.enable_light_sampling:
        add = add & was_specular
    e_hit = eval_texture(scene.textures, scene.lights.tex[li_hit], uv,
                         may=scene.lights.emit_kinds)
    return emission + torch.where(add[..., None], throughput * e_hit, 0.0), e_hit


def _roulette(throughput, alive, u_rr, bounce):
    """Russian roulette from the fourth bounce (PathTracer.cpp:111-117):
    a path whose max |throughput| fell below 0.1 survives with that
    probability, its throughput divided by it. -> (throughput, alive)."""
    if bounce <= 2:
        return throughput, alive
    rp = vo.max3(torch.abs(throughput))
    do_rr = rp < 0.1
    survive = u_rr < rp
    throughput = torch.where((do_rr & survive & alive)[..., None],
                             throughput / torch.clamp(rp, min=1e-30)[..., None], throughput)
    return throughput, alive & (~do_rr | survive)


def _strat_fields(meta, seed, lane_ids, px, py):
    """Per-lane Sobol' sample index and pixel key (renderer
    "stratified_sampler"), (None, None) otherwise. Lanes are m repetitions of
    the pixel grid, so rep = lane // n_pix; the pass index rides in seed[1]
    (path_tracer.py:725-738)."""
    if not meta.stratified:
        return None, None
    n_pix = meta.res_x * meta.res_y
    m = max(px.shape[0] // n_pix, 1)
    rep = (lane_ids.to(torch.int64) & MASK32) // n_pix
    samp = ((int(seed[1]) & MASK32) * m + rep) & MASK32
    pix = (py.to(torch.int64) * meta.res_x + px.to(torch.int64)) & MASK32
    return samp, pix


def _trace_pass_fast(scene: FlatScene, seed, lane_ids, px, py, table=None):
    """One sample per lane, all lanes in lockstep (path_tracer.py:741-1097,
    no compaction). seed: (s0, s1) uint32 pair, the pass index folded into
    s1. table: an MLT primary-sample table (N, D, 2): stratification off,
    slot 0 (the chain's pixel) skipped, no (0,2)-sequence AA
    (path_tracer.py:741-760). Returns radiance (N, 3), and with AOVs
    (radiance, {depth, normal, albedo}) at the lanes' own indices.

    Per bounce: the shadow rays take the any-hit walk, the [bsdf-strategy |
    continuation] rays one 2N-lane closest-hit walk."""
    meta = scene.meta
    dev = px.device
    n = px.shape[0]
    mats, texs = scene.materials, scene.textures
    seed = (int(seed[0]) & MASK32, int(seed[1]) & MASK32)
    samp_idx, pix_key = _strat_fields(meta, seed, lane_ids, px, py)
    strat = samp_idx is not None and table is None
    sampler = Sampler.create(seed, lane_ids, table, samp_idx, pix_key, strat)
    if table is not None:
        sampler = sampler.skip(1)  # table slot 0 is the MLT pixel position
    u_cam, sampler = sampler.next_2d()
    u_lens, sampler = sampler.next_2d()
    if table is None and not strat:
        # stratified (0,2)-sequence AA over passes
        u_cam = stratified_cam_2d(sampler.lane_id, seed[1])
    o, d, cam_w = camera_rays_w(scene.camera, meta, px, py, u_cam, u_lens)
    o, d = o.contiguous(), d.contiguous()
    base_dim = sampler.dim

    def full(v, dtype=torch.float32):
        return torch.full((n,), v, dtype=dtype, device=dev)

    hit = _intersect(scene, o, d, full(1e-4), torch.where(cam_w > 0.0, INF, 0.0))
    throughput = cam_w[..., None].expand(n, 3)
    emission = torch.zeros((n, 3), device=dev)
    alive = cam_w > 0.0
    was_specular = full(True, torch.bool)
    do_nee = meta.enable_light_sampling and meta.n_lights > 0
    aov = _aov_state(n, dev) if meta.aovs else None
    media = meta.has_media
    if media:
        medium = full(meta.camera_medium, torch.int64)
        first_scatter = full(True, torch.bool)
        med_bounce = full(0, torch.int64)

    bounce = 0
    while bounce < meta.max_bounces and trace.to_host("sync.pt.loop", alive.any()):
        with trace.span("pt.iter"):
            smp = Sampler(seed, sampler.lane_id, base_dim + bounce * DIMS_PER_BOUNCE,
                          samp_idx, pix_key, strat, table=table).prefetch(8)
            alive_in = alive
            did_hit = (hit.prim >= 0) & alive

            # ---- medium interaction (path_tracer.py:817-847) ----
            if media:
                ms, smp = _medium_interaction(scene, smp, medium, o, d,
                                              torch.where(did_hit, hit.t, INF), alive,
                                              first_scatter, med_bounce)
                if scene.media.has_emissive_grid:  # before the weight (PathTracer.cpp:56-57)
                    emission = emission + torch.where(alive[..., None], throughput * ms.emission,
                                                      0.0)
                throughput = throughput * torch.where(alive[..., None], ms.weight, 1.0)
                scattered = ms.scattered & alive
                hit_surface_lane = ms.exited & did_hit
                alive = alive & (scattered | hit_surface_lane)
                med_bounce = torch.where(scattered, med_bounce + 1, med_bounce)
                first_scatter = first_scatter & ~scattered
                mi = torch.clamp(medium, min=0)
                ptype, g = scene.media.phase_type[mi], scene.media.phase_g[mi]
            else:
                smp = smp.skip(3)
                scattered = full(False, torch.bool)
                hit_surface_lane = did_hit
                alive = alive & did_hit

            # ---- misses: environment ----
            if meta.has_env or meta.has_cap:
                miss = alive_in & (hit.prim < 0) & ~scattered
                gate = L.infinite_needs_escape_add(scene, d, was_specular)
                add_env = miss & gate & (bounce >= meta.min_bounces)
                emission = emission + torch.where(
                    add_env[..., None], throughput * L.infinite_radiance(scene, d), 0.0)

            # ---- surface shading data ----
            p, ng, ns, uv, mat_id, light_id = _shading_data(scene, hit, o, d)
            mat_pre = gather(mats, texs, mat_id, uv)
            if (rec := trace.counter("bsdf.hits")) is not None:
                _count_hits(rec, hit_surface_lane, mat_pre[1])
            lobes = mat_pre[3]
            frame, wi = _local_frame(scene, hit.prim, ns, d, lobes)

            emission, e_hit = _add_hit_emission(scene, emission, throughput, hit_surface_lane, d,
                                                ng, uv, light_id, was_specular, bounce)
            if aov is not None:
                aov = _record_aovs(aov, did_hit, hit.t, hit_surface_lane, lobes, ns, mat_pre[2],
                                   light_id, e_hit)

            vp = vo.where3(scattered, ms.p, p) if media else p
            throughput_vertex = throughput
            # the NEE rays start in the medium AT the vertex, before the
            # continuation's handoff (TraceBase.cpp:261-262)
            medium_vertex = medium if media else None

            # ---- NEE prepare ----
            if do_nee:
                smp, nee = _unified_nee_prepare(
                    scene, smp, vp, frame, wi, mat_pre, uv, lobes,
                    *((scattered, d, ptype, g) if media else ()))
                nee_gate = _nee_gate(meta, hit_surface_lane, scattered,
                                     med_bounce if media else None, bounce)
                if (rec := trace.counter("light.choices")) is not None:
                    _count_choices(rec, nee["li"], nee_gate, meta.n_lights)
                shadow_far = torch.where(nee_gate, nee["shadow_far"], 0.0)
                mis_far = torch.where(nee_gate, nee["mis_far"], 0.0)
            else:
                smp = smp.skip(5)

            # ---- continuation sample ----
            u_c2, smp = smp.next_2d()
            u_c1, smp = smp.next_1d()
            bs = bsdf_sample(mats, mat_pre, uv, wi, u_c2, u_c1, textures=texs)
            wo_w = vo.to_global(*frame, bs.wo)
            weight_step = bs.weight
            if media:  # a medium vertex continues by the phase function
                w_phase, _ = phase_sample(ptype, g, d, u_c2)
                wo_w = vo.where3(scattered, w_phase, wo_w)
                weight_step = torch.where(scattered[..., None], 1.0, weight_step)
                was_specular = torch.where(scattered, not meta.enable_volume_light_sampling,
                                           was_specular)
            throughput = throughput * torch.where(alive[..., None], weight_step, 1.0)
            was_specular = torch.where(hit_surface_lane, Lobes.has_specular(bs.lobe), was_specular)
            alive = alive & torch.where(hit_surface_lane, bs.valid, True)
            if media:
                medium, first_scatter, med_bounce = _medium_handoff(
                    scene, hit.prim, wo_w, ng, hit_surface_lane, medium, first_scatter, med_bounce)
            alive = alive & (vo.max3(torch.abs(throughput)) > 0.0)

            u_rr, smp = smp.next_1d()
            throughput, alive = _roulette(throughput, alive, u_rr, bounce)
            cont_far = torch.where(alive, INF, 0.0) if bounce + 1 < meta.max_bounces else full(0.0)

            # ---- any-hit shadows + merged [mis | continuation] closest hit ----
            # (a medium vertex's rays start at the vertex itself: near 0)
            near = torch.where(scattered, 0.0, DEFAULT_EPSILON)
            if do_nee:
                shadow_blocked = _occluded_raw(scene, vp, nee["ls"].d, near, shadow_far)
                h2 = _intersect(scene, torch.cat([vp, vp]), torch.cat([nee["wo_mis"], wo_w]),
                                torch.cat([near, near]), torch.cat([mis_far, cont_far]))
                h_mis = Hit(t=h2.t[:n], prim=h2.prim[:n], u=h2.u[:n], v=h2.v[:n])
                prim_v = hit.prim
                hit = Hit(t=h2.t[n:], prim=h2.prim[n:], u=h2.u[n:], v=h2.v[n:])
                if media:  # each strategy's medium (path_tracer.py:995-1004); the lanes
                    # outside the gate, whose contribution is dropped, walk no grid
                    med_l = _select_medium_dir(scene, medium_vertex, prim_v, nee["ls"].d,
                                               hit_surface_lane, p=vp)
                    med_b = _select_medium_dir(scene, medium_vertex, prim_v, nee["wo_mis"],
                                               hit_surface_lane, p=vp)
                    med_l = torch.where(nee_gate, med_l, -1)
                    med_b = torch.where(nee_gate, med_b, -1)
                    contrib = _unified_nee_finish(scene, nee, shadow_blocked, h_mis,
                                                  medium_l=med_l, medium_b=med_b,
                                                  scattered=scattered)
                else:
                    contrib = _unified_nee_finish(scene, nee, shadow_blocked, h_mis)
                emission = emission + torch.where(nee_gate[..., None],
                                                  throughput_vertex * contrib, 0.0)
            else:
                hit = _intersect(scene, vp, wo_w, near, cont_far)
            o, d = vp, wo_w
            bounce += 1
    rad = torch.where(torch.isfinite(emission), emission, 0.0)
    return rad if aov is None else (rad, _aux(aov))


# ---------------------------------------------------------------------------
# lockstep with forward lobes: the transparency lottery and the crossing walk
# ---------------------------------------------------------------------------

MAX_CROSSINGS = 8  # the crossing walk's steps (path_tracer.py:185)


@trace.spanned("pt.crossing")
def _trace_transparent(scene: FlatScene, o, d, far, medium=None, start_on_surface=None,
                       end_on_surface=None):
    """The generalized shadow walk (TraceBase::generalizedShadowRayImpl;
    path_tracer.py:170-255): intersect, cross a forward-lobed surface
    (weight *= its transparency, the medium handed over where the surface
    overrides media), stop at any other hit, for at most MAX_CROSSINGS
    closest-hit walks. With media (medium, start_on_surface, end_on_surface:
    (N,)) every segment is attenuated by its medium with the surface /
    medium endpoint cases. Returns (weight (N, 3), the terminal Hit with t
    from the original origin); a lane still crossing after the last step
    ends with weight 0. The JAX package runs every step; here the loop stops
    once every lane is done (one `.item()` a step), where the further steps
    would change nothing."""
    mats, texs = scene.materials, scene.textures
    n, dev = o.shape[0], o.device
    eps = torch.full((n,), DEFAULT_EPSILON, device=dev)
    weight = torch.ones((n, 3), device=dev)
    t_base = torch.zeros((n,), device=dev)
    cur_o, remaining = o, far
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    media = scene.meta.has_media and medium is not None
    cur_med, start_surf = medium, start_on_surface
    fin = Hit(t=torch.full((n,), INF, device=dev),
              prim=torch.full((n,), -1, dtype=torch.int64, device=dev),
              u=torch.zeros((n,), device=dev), v=torch.zeros((n,), device=dev))
    for _ in range(MAX_CROSSINGS):
        h = _intersect(scene, cur_o, d, eps, torch.where(done, 0.0, remaining))
        did_hit = (h.prim >= 0) & ~done
        if media:  # done lanes keep their weight and skip the grid walks
            tr = medium_transmittance(scene.media, torch.where(done, -1, cur_med),
                                      torch.where(did_hit, h.t, remaining), start_surf,
                                      did_hit | end_on_surface, cur_o, d)
            weight = torch.where(done[..., None], weight, weight * tr)
        ng_h, uvh = hit_geom(scene, h.prim, cur_o + d * h.t[..., None], h.u, h.v)
        mat_id = scene.shade_pack[torch.clamp(h.prim, min=0), 18].to(torch.int64)  # tri_mat
        pre = gather(mats, texs, mat_id, uvh)
        t_ax, b_ax = vo.tangent_frame(ng_h)
        trans = forward_transparency(mats, pre, uvh, vo.to_local(t_ax, b_ax, ng_h, -d), texs)
        can_cross = Lobes.has_forward(pre[3]) & torch.any(trans > 0.0, dim=-1)
        terminal = did_hit & ~can_cross
        fin = Hit(t=torch.where(terminal, t_base + h.t, fin.t),
                  prim=torch.where(terminal, h.prim, fin.prim),
                  u=torch.where(terminal, h.u, fin.u), v=torch.where(terminal, h.v, fin.v))
        crossing = did_hit & can_cross
        weight = torch.where(crossing[..., None], weight * trans, weight)
        if media:
            tri = torch.clamp(h.prim, min=0)
            new_med = torch.where(vo.dot(d, ng_h) < 0.0, scene.tri_med_int[tri],
                                  scene.tri_med_ext[tri])
            cur_med = torch.where(crossing & scene.tri_med_override[tri], new_med, cur_med)
            start_surf = start_surf | crossing
        done = done | terminal | ~did_hit
        t_base = torch.where(crossing, t_base + h.t, t_base)
        remaining = torch.where(crossing, remaining - h.t, remaining)
        cur_o = torch.where(crossing[..., None], cur_o + d * h.t[..., None], cur_o)
        if trace.to_host("sync.pt.crossing", done.all()):
            break
    return torch.where(done[..., None], weight, 0.0), fin


def _volume_nee(scene: FlatScene, smp: Sampler, p, d_in, medium, ptype, g, gate):
    """volumeEstimateDirect (TraceBase.cpp:323-381; path_tracer.py:415-519):
    one chosen light from the medium scatter point p, the light-sampling
    and the phase-sampling strategy with power-heuristic MIS, both rays in
    ONE 2N crossing walk attenuated by the current medium (segments from a
    medium point). Consumes 6 sampler dims. gate: the lanes whose
    contribution the caller keeps; the others trace nothing.
    -> (contribution (N, 3), sampler)."""
    n = p.shape[0]
    u_choose, smp = smp.next_1d()
    li, choice_weight = L.choose_light(scene, u_choose, p)
    is_env_choice = scene.lights.is_env[li]
    ls, _, is_point, smp = _sample_chosen_light(scene, smp, li, is_env_choice, p)

    f_l = phase_eval(ptype, g, d_in, ls.d)
    cand = ls.valid & (ls.pdf > 0.0) & (f_l > 0.0)
    mis_l = warps.power_heuristic(ls.pdf, f_l)  # the phase pdf is its value
    mis_l = torch.where(is_point, 1.0, mis_l)  # dirac: no phase strategy

    u_ph, smp = smp.next_2d()
    w_ph, pdf_ph = phase_sample(ptype, g, d_in, u_ph)

    shadow_far = torch.where(cand, torch.where(ls.dist >= INF, INF, ls.dist * SHADOW_FUDGE), 0.0)
    med = torch.where(gate, medium, -1)
    w2, h2 = _trace_transparent(
        scene, torch.cat([p, p]), torch.cat([ls.d, w_ph]),
        torch.cat([torch.where(gate, shadow_far, 0.0), torch.where(gate, INF, 0.0)]),
        torch.cat([med, med]), torch.zeros((2 * n,), dtype=torch.bool, device=p.device),
        torch.ones((2 * n,), dtype=torch.bool, device=p.device))
    blocked = h2.prim[:n] >= 0
    h = Hit(t=h2.t[n:], prim=h2.prim[n:], u=h2.u[n:], v=h2.v[n:])
    contrib_l = (f_l * mis_l / torch.clamp(ls.pdf, min=1e-30))[..., None] * ls.radiance * w2[:n]
    contrib_l = torch.where((cand & ~blocked)[..., None], contrib_l, 0.0)

    e, light_pdf, match = _strategy_match(scene, li, is_env_choice, p, w_ph, h)
    mis_b = warps.power_heuristic(pdf_ph, light_pdf)
    contrib_b = torch.where(match[..., None], e * w2[n:] * mis_b[..., None], 0.0)
    return (contrib_l + contrib_b) * choice_weight[..., None], smp


def _trace_pass_forward(scene: FlatScene, seed, lane_ids, px, py, table=None):
    """One sample per lane for scenes with forward lobes: trace_pass's slow
    branch without compaction (path_tracer.py:1803-2111); returns as
    `_trace_pass_fast` does. table: an MLT primary-sample table, read by
    the bounces' samplers only: the camera's draws hash as without one
    and no slot is skipped (path_tracer.py:1813-1815, 1856-1859).
    Per bounce one closest-hit walk for the path, the medium interaction
    (with `_volume_nee` at the medium vertices, handleVolume), the
    transparency lottery (pass straight through a forward-lobed surface with
    probability avg(transparency), TraceBase.cpp:528-537), and NEE with both
    strategies' rays in ONE 2N-lane crossing walk (`_trace_transparent`),
    each starting in the medium on its side of the surface."""
    meta = scene.meta
    dev = px.device
    n = px.shape[0]
    mats, texs = scene.materials, scene.textures
    seed = (int(seed[0]) & MASK32, int(seed[1]) & MASK32)
    samp_idx, pix_key = _strat_fields(meta, seed, lane_ids, px, py)
    strat = samp_idx is not None
    sampler = Sampler.create(seed, lane_ids, samp_idx=samp_idx, pix_key=pix_key, strat=strat)
    u_cam, sampler = sampler.next_2d()  # no (0,2)-sequence AA on this branch
    u_lens, sampler = sampler.next_2d()
    o, d, cam_w = camera_rays_w(scene.camera, meta, px, py, u_cam, u_lens)
    o, d = o.contiguous(), d.contiguous()
    base_dim = sampler.dim

    def full(v, dtype=torch.float32):
        return torch.full((n,), v, dtype=dtype, device=dev)

    throughput = cam_w[..., None].expand(n, 3)
    emission = torch.zeros((n, 3), device=dev)
    alive = cam_w > 0.0
    was_specular = full(True, torch.bool)
    near = full(1e-4)
    do_nee = meta.enable_light_sampling and meta.n_lights > 0
    aov = _aov_state(n, dev) if meta.aovs else None
    media = meta.has_media
    if media:
        medium = full(meta.camera_medium, torch.int64)
        first_scatter = full(True, torch.bool)
        med_bounce = full(0, torch.int64)
    scattered = full(False, torch.bool)

    bounce = 0
    while bounce < meta.max_bounces and trace.to_host("sync.pt.loop", alive.any()):
        with trace.span("pt.iter"):
            smp = Sampler(seed, sampler.lane_id, base_dim + bounce * DIMS_PER_BOUNCE,
                          samp_idx, pix_key, strat, table=table).prefetch(8)
            hit = _intersect(scene, o, d, near, torch.where(alive, INF, 0.0))
            did_hit = (hit.prim >= 0) & alive

            # ---- medium interaction (path_tracer.py:1871-1891; no grid
            # emission on this branch, as in the JAX package) ----
            if media:
                ms, smp = _medium_interaction(scene, smp, medium, o, d,
                                              torch.where(did_hit, hit.t, INF), alive,
                                              first_scatter, med_bounce)
                throughput = throughput * torch.where(alive[..., None], ms.weight, 1.0)
                scattered = ms.scattered & alive
                hit_surface_lane = ms.exited & did_hit
                alive = alive & (scattered | ms.exited)  # failed samples end the path
                med_bounce = torch.where(scattered, med_bounce + 1, med_bounce)
                first_scatter = first_scatter & ~scattered
            else:
                smp = smp.skip(3)
                hit_surface_lane = did_hit

            # ---- misses: environment ----
            if meta.has_env or meta.has_cap:
                gate = L.infinite_needs_escape_add(scene, d, was_specular)
                add_env = alive & ~did_hit & ~scattered & gate & (bounce >= meta.min_bounces)
                emission = emission + torch.where(
                    add_env[..., None], throughput * L.infinite_radiance(scene, d), 0.0)
            alive = alive & (did_hit | scattered)

            # ---- volume scattering (handleVolume, TraceBase.cpp:496-514) ----
            if media:
                mi = torch.clamp(medium, min=0)
                ptype, g = scene.media.phase_type[mi], scene.media.phase_g[mi]
                if meta.enable_volume_light_sampling and meta.n_lights > 0:
                    do_vnee = scattered & (bounce < meta.max_bounces - 1)
                    if not meta.low_order_scattering:
                        do_vnee = do_vnee & (med_bounce > 1)
                    vnee, smp = _volume_nee(scene, smp, ms.p, d, medium, ptype, g, do_vnee)
                    emission = emission + torch.where(do_vnee[..., None], throughput * vnee, 0.0)
                else:
                    smp = smp.skip(5)
                u_ph, smp = smp.next_2d()
                w_phase, _ = phase_sample(ptype, g, d, u_ph)
            else:
                smp = smp.skip(6)  # the volume NEE and phase dims

            # ---- surface shading data ----
            p, ng, ns, uv, mat_id, light_id = _shading_data(scene, hit, o, d)
            mat_pre = gather(mats, texs, mat_id, uv)
            if (rec := trace.counter("bsdf.hits")) is not None:
                _count_hits(rec, hit_surface_lane, mat_pre[1])
            lobes = mat_pre[3]
            frame, wi = _local_frame(scene, hit.prim, ns, d, lobes)

            # ---- the transparency lottery ----
            u_fwd, smp = smp.next_1d()
            trans_f = forward_transparency(mats, mat_pre, uv, wi, texs)
            trans_scalar = vo.avg3(trans_f)
            go_forward = hit_surface_lane & (u_fwd < trans_scalar)
            fwd_weight = trans_f / torch.clamp(trans_scalar, min=1e-20)[..., None]
            shaded = hit_surface_lane & ~go_forward

            emission, e_hit = _add_hit_emission(scene, emission, throughput, shaded, d, ng, uv,
                                                light_id, was_specular, bounce)
            if aov is not None:  # a lane passing straight through records none (:1980-1991)
                aov = _record_aovs(aov, did_hit, hit.t, shaded, lobes, ns, mat_pre[2], light_id,
                                   e_hit)

            # ---- NEE: both strategies' rays in one 2N crossing walk ----
            if do_nee:
                smp, nee = _unified_nee_prepare(scene, smp, p, frame, wi, mat_pre, uv, lobes)
                nee_gate = shaded & (bounce < meta.max_bounces - 1)
                if (rec := trace.counter("light.choices")) is not None:
                    _count_choices(rec, nee["li"], nee_gate, meta.n_lights)
                far2 = torch.cat([torch.where(nee_gate, nee["shadow_far"], 0.0),
                                  torch.where(nee_gate, nee["mis_far"], 0.0)])
                med_args = ()
                if media:  # each ray starts in the medium on its side (path_tracer.py:378-388)
                    on_surf = torch.ones_like(nee_gate)
                    med2 = torch.cat([
                        _select_medium_dir(scene, medium, hit.prim, nee["ls"].d, on_surf, p=p),
                        _select_medium_dir(scene, medium, hit.prim, nee["wo_mis"], on_surf, p=p)])
                    on2 = torch.cat([on_surf, on_surf])
                    med_args = (torch.where(torch.cat([nee_gate, nee_gate]), med2, -1), on2, on2)
                w2, h2 = _trace_transparent(scene, torch.cat([p, p]),
                                            torch.cat([nee["ls"].d, nee["wo_mis"]]), far2,
                                            *med_args)
                h_mis = Hit(t=h2.t[n:], prim=h2.prim[n:], u=h2.u[n:], v=h2.v[n:])
                contrib = _unified_nee_finish(scene, nee, h2.prim[:n] >= 0, h_mis, w2[:n], w2[n:])
                emission = emission + torch.where(nee_gate[..., None], throughput * contrib, 0.0)
            else:
                smp = smp.skip(5)

            # ---- continuation: the bsdf sample, or straight on through ----
            u_c2, smp = smp.next_2d()
            u_c1, smp = smp.next_1d()
            bs = bsdf_sample(mats, mat_pre, uv, wi, u_c2, u_c1, textures=texs)
            wo_w = vo.where3(go_forward, d, vo.to_global(*frame, bs.wo))
            step = vo.where3(go_forward, fwd_weight, bs.weight)
            throughput = throughput * torch.where(hit_surface_lane[..., None], step, 1.0)
            if media:
                was_specular = torch.where(scattered, not meta.enable_volume_light_sampling,
                                           was_specular)
            was_specular = torch.where(shaded, Lobes.has_specular(bs.lobe), was_specular)
            alive = alive & torch.where(shaded, bs.valid, True)
            if media:  # the handoff at surface crossings (path_tracer.py:2016-2024)
                medium, first_scatter, med_bounce = _medium_handoff(
                    scene, hit.prim, wo_w, ng, hit_surface_lane, medium, first_scatter, med_bounce)
            alive = alive & (vo.max3(torch.abs(throughput)) > 0.0)

            u_rr, smp = smp.next_1d()
            throughput, alive = _roulette(throughput, alive, u_rr, bounce)
            if media:  # a medium vertex continues from the scatter point, near 0
                o = vo.where3(scattered, ms.p, p)
                d = vo.where3(scattered, w_phase, wo_w)
                near = torch.where(scattered, 0.0, DEFAULT_EPSILON)
            else:
                o, d, near = p, wo_w, full(DEFAULT_EPSILON)
            bounce += 1
    rad = torch.where(torch.isfinite(emission), emission, 0.0)
    return rad if aov is None else (rad, _aux(aov))


def trace_pass(scene: FlatScene, seed, lane_ids, px, py, table=None):
    """Trace one sample for each lane; returns radiance (N, 3), and with
    AOVs (radiance, {depth, normal, albedo}). As the JAX package dispatches
    (path_tracer.py:1810): `_trace_pass_fast` without forward lobes, the
    crossing-walk branch `_trace_pass_forward` with them. table: an
    optional MLT primary-sample table (N, D, 2) (see Sampler)."""
    meta = scene.meta
    if meta.has_forward:
        return _trace_pass_forward(scene, seed, lane_ids, px, py, table)
    return _trace_pass_fast(scene, seed, lane_ids, px, py, table)


@trace.spanned("pt.batch")
def trace_batch(scene: FlatScene, seed, lane_base, px, py, pass_start: int, n_passes: int = 1):
    """Sum of n_passes lockstep passes (N, 3), and with AOVs (sum, {depth,
    normal, albedo} sums); pass i runs under the seed (seed[0], seed[1] +
    pass_start + i) (path_tracer.py:1781-1799)."""
    zero = torch.zeros(px.shape + (3,), dtype=torch.float32, device=px.device)
    acc = zero
    if scene.meta.aovs:
        acc = (zero, dict(depth=torch.zeros(px.shape, device=px.device), normal=zero,
                          albedo=zero))
    for i in range(n_passes):
        pass_seed = (int(seed[0]) & MASK32, (int(seed[1]) + int(pass_start) + i) & MASK32)
        out = trace_pass(scene, pass_seed, lane_base, px, py)
        if scene.meta.aovs:
            acc = (acc[0] + out[0], {k: v + out[1][k] for k, v in acc[1].items()})
        else:
            acc = acc + out
    return acc
