"""Photon mapping / SPPM (stochastic progressive photon mapping), torch.

Port of tungsten_tpu/integrators/photon_map.py (PhotonTracer::
tracePhotonPath deposits the surface photons; traceSensorPath walks the
specular chains and estimates the density at the first non-specular hit;
ProgressivePhotonMapIntegrator.cpp drives the iterations, renderer/render.py
`render_sppm`).

  * `trace_photons`: one photon path a lane from `sample_emitter_position`,
    k_max bounces, a photon at every diffuse or glossy surface hit and, in
    media, a volume photon at every scatter (points), one short beam a
    medium segment (beams) and, for the plane modes, two plane slots a
    vertex from the continued free flight;
  * `build_photon_grid`, `build_beam_grid` (64 stations a beam),
    `build_plane_list` (MAX_PLANES rows, uniformly thinned with power
    compensation): the photons sorted by a spatial hash of their cell
    (GRID_SIZE cells, a stable sort, so a cell's first MAX_PER_CELL rows are
    its first photons in emission order), and the overflow compensation;
  * `gather_pass`: the camera walk and the density estimates. The candidate
    loops of the surface gather (fixed radius or kNN), of the volume points
    and of the short beams are K7 (ops/photon_walk.py), which returns the
    accepted (lane, row) pairs with their geometry; the physics (the BSDF,
    the phase function, the transmittance, the density) runs here on the
    pairs only, with the functions every tracer uses, and the per-lane sums
    go through `_deposit` (a sorted `index_put_` on the card, so an image
    repeats bit for bit);
  * the plane gathers (`_plane0d_gather`, `_plane1d_gather`): a sweep of
    the plane table in 32 chunks with a streaming reservoir and one any-hit
    walk a ray, plain torch over the lanes in the medium.

The loops stop once no lane lives (the JAX fori_loops run their last
bounces on dead lanes, which deposit nothing). The TUNGSTEN_PHOTON_CELL_CAP
knob is not carried: MAX_PER_CELL is 32.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..math import vecops as vo
from ..models.bsdfs.common import Lobes
from ..models.bsdfs.dispatch import bsdf_eta_sq, bsdf_eval, bsdf_sample, gather
from ..models.cameras.pinhole import camera_rays_w
from ..models.media.media import (_hetero_density, _hetero_ray, medium_sample_distance,
                                  medium_transmittance)
from ..models.phase.phase import phase_eval, phase_sample
from ..models.primitives import lights as L
from ..models.textures.textures import eval_texture
from ..ops import photon_walk
from ..ops.photon_walk import (GRID_SIZE, MAX_PER_CELL, MAX_VOL_STEPS, _f32,  # noqa: F401
                               cell_of, hash_cell)
from ..sampling import warps
from ..sampling.sampler import MASK32, Sampler, _mul32
from ..scene.flatten import DEFAULT_EPSILON, FlatScene
from .path_tracer import (DIMS_PER_BOUNCE, INF, SHADOW_FUDGE, _deposit, _intersect,
                          _local_frame, _occluded_raw, _shading_data)

BEAM_STATIONS = 64  # hash-grid insertion points a beam (spacing r_beam)
MAX_PLANES = 4096
PLANE_CHUNK = 128
PAIR_CHUNK = 1 << 22  # pairs whose physics runs at once
PLANE_LANES = 1 << 17  # lanes a plane sweep holds at once
VOLUME_PHOTON_TYPES = ("points", "beams", "planes", "planes_1d")  # PhotonMapSettings.hpp:16-23
_LUM = (0.2126, 0.7152, 0.0722)


_hash_cell = hash_cell  # photon_map.py:40-47, the name the JAX package gives it


def _u32(x):
    return (x.to(torch.int64) if torch.is_tensor(x) else torch.tensor(int(x))) & MASK32


def _mix01(a, b, c):
    """Counter hash -> [0, 1) (photon_map.py:628-635), in uint32 arithmetic."""
    h = _mul32(_u32(a), 0x85EBCA6B)
    h = _mul32(h ^ _u32(b), 0xC2B2AE35)
    h = _mul32(h ^ _u32(c), 0x27D4EB2F)
    h = h ^ (h >> 15)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _lum(x):
    return (x[..., 0] * _LUM[0] + x[..., 1] * _LUM[1]) + x[..., 2] * _LUM[2]


# ---------------------------------------------------------------------------
# the photon pass


def trace_photons(scene: FlatScene, seed, lane_ids, k_max=6, want_planes=False):
    """One photon path a lane (photon_map.py:50-350); seed: the (s0, s1)
    pair. Returns (surf, vol, beams, planes) as the JAX package does, each
    flattened lane-major to (N * k_max, ...) (planes (N * k_max * 2, ...)):
    surf = (pos, power, wi, valid, bounce); with media vol = (vpos, vpow,
    vdir, vvalid, bounce), beams = (bo, bd, blen, bpow, bmed, bvalid,
    bounce), and with want_planes planes = (pp0, pp1, pd1, pl1, ppow, pval,
    pbounce); None otherwise."""
    meta = scene.meta
    mats, texs = scene.materials, scene.textures
    dev = lane_ids.device
    n = lane_ids.shape[0]
    seed = (int(seed[0]) & MASK32, int(seed[1]) & MASK32)
    sampler = Sampler.create(seed, lane_ids)
    media = meta.has_media
    planes_on = media and want_planes

    u_li, sampler = sampler.next_1d()
    li = torch.clamp((u_li * meta.n_lights).to(torch.int64), max=meta.n_lights - 1)
    u_tri, sampler = sampler.next_1d()
    u_pos, sampler = sampler.next_2d()
    em = L.sample_emitter_position(scene, li, u_tri, u_pos)
    u_dir, sampler = sampler.next_2d()
    t_e, b_e = vo.tangent_frame(em.ng)
    d = vo.to_global(t_e, b_e, em.ng, warps.cosine_hemisphere(u_dir))
    o = em.p
    power = em.weight * meta.n_lights  # pi * A * Le / pick
    alive = em.valid

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros((n, k_max) + shape, dtype=dtype, device=dev)

    rec = dict(pos=zeros(3), pw=zeros(3), wi=zeros(3), val=zeros(dtype=torch.bool))
    if media:
        medium = scene.tri_med_ext[torch.clamp(em.tri, min=0)]
        first_scatter = torch.ones((n,), dtype=torch.bool, device=dev)
        med_bounce = torch.zeros((n,), dtype=torch.int64, device=dev)
        since_surface = torch.zeros((n,), dtype=torch.int64, device=dev)
        rec.update(vpos=zeros(3), vpow=zeros(3), vdir=zeros(3), vval=zeros(dtype=torch.bool),
                   bo=zeros(3), bd=zeros(3), blen=zeros(), bpow=zeros(3),
                   bmed=zeros(dtype=torch.int64), bval=zeros(dtype=torch.bool))
        if planes_on:
            rec.update(pp0=zeros(2, 3), pp1=zeros(2, 3), pd1=zeros(2, 3), pl1=zeros(2),
                       ppow=zeros(2, 3), pval=zeros(2, dtype=torch.bool))
            prev_pos = em.p
            prev_med = torch.zeros((n,), dtype=torch.bool, device=dev)
    low = bool(meta.low_order_scattering)
    near = torch.full((n,), DEFAULT_EPSILON, device=dev)
    base_dim = sampler.dim
    for k in range(k_max):
        if not bool(alive.any()):
            break
        smp = Sampler(seed, sampler.lane_id, base_dim + k * DIMS_PER_BOUNCE)
        hit = _intersect(scene, o, d, near, torch.where(alive, INF, 0.0))
        did_hit = (hit.prim >= 0) & alive

        if media:
            u_mc, smp = smp.next_1d()
            u_md, smp = smp.next_1d()
            u_mb, smp = smp.next_1d()
            far = torch.where(did_hit, hit.t, INF)
            # dead lanes pass as vacuum: no record of theirs is kept
            live_med = torch.where(alive, medium, -1)
            ms = medium_sample_distance(scene.media, live_med, o, d, far, first_scatter,
                                        med_bounce, u_mc, u_md, u_mb, want_continued=planes_on)
            # a short beam over the segment up to its realized end
            # (photon_map.py:132-163)
            seg_end = torch.where(ms.scattered & alive, ms.t,
                                  torch.where(hit.prim >= 0, hit.t, INF))
            if planes_on:
                beam_ok = (alive & (medium >= 0) & (seg_end < INF) & low
                           & (since_surface == 0))
            else:
                beam_ok = (alive & (medium >= 0) & (seg_end < INF)
                           & ((since_surface > 0) | low))
            rec["bo"][:, k] = o
            rec["bd"][:, k] = d
            rec["blen"][:, k] = torch.where(beam_ok, seg_end, 0.0)
            rec["bpow"][:, k] = torch.where(beam_ok[..., None], power, 0.0)
            rec["bmed"][:, k] = medium
            rec["bval"][:, k] = beam_ok
            if planes_on:
                # slot 0: the plane of the previous scatter vertex
                # (photon_map.py:164-182)
                in_med = alive & (medium >= 0)
                dep0 = in_med & prev_med & (ms.continued_t > 0.0)
                l0 = vo.length(o - prev_pos)
                pw0 = (l0 * ms.continued_t)[..., None] * power * ms.continued_weight
                rec["pp0"][:, k, 0] = prev_pos
                rec["pp1"][:, k, 0] = o
                rec["pd1"][:, k, 0] = d
                rec["pl1"][:, k, 0] = torch.where(dep0, ms.continued_t, 0.0)
                rec["ppow"][:, k, 0] = torch.where(dep0[..., None], pw0, 0.0)
                rec["pval"][:, k, 0] = dep0
            power = power * torch.where(alive[..., None], ms.weight, 1.0)
            scattered = ms.scattered & alive
            did_hit = ms.exited & did_hit
            since = since_surface + 1
            # points skip single scattering unless low_order (photon_map.py:187-195)
            dep_vol = scattered & ((since > 1) | low)
            rec["vpos"][:, k] = torch.where(dep_vol[..., None], ms.p, 0.0)
            rec["vpow"][:, k] = torch.where(dep_vol[..., None], power, 0.0)
            rec["vdir"][:, k] = d
            rec["vval"][:, k] = dep_vol
            u_ph, smp = smp.next_2d()
            mi = torch.clamp(medium, min=0)
            w_phase, _ = phase_sample(scene.media.phase_type[mi], scene.media.phase_g[mi], d,
                                      u_ph)
            if planes_on:
                # slot 1: the virtual continuation where a medium segment
                # ends on a surface (photon_map.py:201-226)
                u_mc2, smp = smp.next_1d()
                u_md2, smp = smp.next_1d()
                u_mb2, smp = smp.next_1d()
                ms2 = medium_sample_distance(scene.media, live_med, ms.p, w_phase,
                                             torch.full((n,), INF, device=dev), first_scatter,
                                             med_bounce, u_mc2, u_md2, u_mb2,
                                             want_continued=True)
                dep1 = alive & (medium >= 0) & did_hit & (ms2.continued_t > 0.0)
                pw1 = (ms.t * ms2.continued_t)[..., None] * power * ms2.continued_weight
                rec["pp0"][:, k, 1] = o
                rec["pp1"][:, k, 1] = ms.p
                rec["pd1"][:, k, 1] = w_phase
                rec["pl1"][:, k, 1] = torch.where(dep1, ms2.continued_t, 0.0)
                rec["ppow"][:, k, 1] = torch.where(dep1[..., None], pw1, 0.0)
                rec["pval"][:, k, 1] = dep1
            med_bounce = torch.where(scattered, med_bounce + 1, med_bounce)
            first_scatter = torch.where(scattered, False, first_scatter)
            since_surface = since
        else:
            smp = smp.skip(5)
            scattered = torch.zeros((n,), dtype=torch.bool, device=dev)

        p, ng, ns, uv, mat_id, _ = _shading_data(scene, hit, o, d)
        mat_pre = gather(mats, texs, mat_id, uv)
        lobes = mat_pre[3]
        frame, wi_l = _local_frame(meta, ns, d, lobes)
        # a photon at the non-pure-specular hits
        deposit = did_hit & ~Lobes.is_pure_specular(lobes) & (lobes != 0)
        rec["pos"][:, k] = torch.where(deposit[..., None], p, 0.0)
        rec["pw"][:, k] = torch.where(deposit[..., None], power, 0.0)
        rec["wi"][:, k] = -d
        rec["val"][:, k] = deposit

        # continue adjointly (photon_map.py:253-276)
        u2, smp = smp.next_2d()
        u1, smp = smp.next_1d()
        bs = bsdf_sample(mats, mat_pre, uv, wi_l, u2, u1, textures=texs)
        wo_w = vo.to_global(*frame, bs.wo)
        eta2 = bsdf_eta_sq(mats, mat_pre, wi_l, bs.wo)
        corr = torch.abs((vo.dot(wo_w, ng) * wi_l[..., 2])
                         / torch.clamp(torch.abs(vo.dot(-d, ng) * bs.wo[..., 2]), min=1e-20))
        power = power * torch.where(
            did_hit[..., None], bs.weight * (corr / torch.clamp(eta2, min=1e-20))[..., None], 1.0)
        alive = ((did_hit & bs.valid) | scattered) & (vo.max3(torch.abs(power)) > 0.0)
        rp = torch.clamp(vo.max3(torch.abs(power)), max=1.0)
        u_rr, smp = smp.next_1d()
        do_rr = (k > 1) & (rp < 0.5)
        survive = u_rr < rp
        power = torch.where((do_rr & survive)[..., None],
                            power / torch.clamp(rp, min=1e-20)[..., None], power)
        alive = alive & (~do_rr | survive)

        if media:
            o_new = torch.where(scattered[..., None], o + d * ms.t[..., None], p)
            d_new = vo.where3(scattered, w_phase, wo_w)
            tri = torch.clamp(hit.prim, min=0)
            backside_new = vo.dot(wo_w, ng) < 0.0
            override = scene.tri_med_override[tri] & did_hit
            new_med = torch.where(backside_new, scene.tri_med_int[tri], scene.tri_med_ext[tri])
            medium = torch.where(override, new_med, medium)
            first_scatter = torch.where(did_hit, True, first_scatter)
            med_bounce = torch.where(did_hit, 0, med_bounce)
            since_surface = torch.where(did_hit, 0, since_surface)
            if planes_on:
                prev_pos = o
                prev_med = scattered
            o, d = o_new, d_new
        else:
            o, d = p, wo_w

    bounce = torch.arange(1, k_max + 1, dtype=torch.int32, device=dev).repeat(n)
    flat = {k: v.reshape((n * k_max,) + tuple(v.shape[2:])) for k, v in rec.items()}
    surf = (flat["pos"], flat["pw"], flat["wi"], flat["val"], bounce)
    vol = beams = planes = None
    if media:
        vol = (flat["vpos"], flat["vpow"], flat["vdir"], flat["vval"], bounce)
        beams = (flat["bo"], flat["bd"], flat["blen"], flat["bpow"], flat["bmed"], flat["bval"],
                 bounce)
    if planes_on:
        # slot 0 of iteration k belongs to the scatter of iteration k - 1
        # (bounce k), slot 1's virtual vertex to the segment's own (k + 1)
        pb0 = torch.arange(k_max, dtype=torch.int32, device=dev)
        pbounce = torch.stack([pb0, pb0 + 1], dim=-1).repeat(n, 1).reshape(-1)
        planes = tuple(rec[k].reshape((-1,) + tuple(rec[k].shape[3:]))
                       for k in ("pp0", "pp1", "pd1", "pl1", "ppow", "pval")) + (pbounce,)
    return surf, vol, beams, planes


# ---------------------------------------------------------------------------
# the grids


def _ranges(key_s):
    """starts, counts (GRID_SIZE,) int32 of the sorted keys' cells."""
    ids = torch.arange(GRID_SIZE, dtype=key_s.dtype, device=key_s.device)
    starts = torch.searchsorted(key_s, ids, side="left")
    ends = torch.searchsorted(key_s, ids, side="right")
    return starts.to(torch.int32), (ends - starts).to(torch.int32)


def build_photon_grid(pos, power, wi, valid, cell_size, bounce=None):
    """Sort the photons by hash cell (photon_map.py:353-395): returns (pack
    (M, 10) [pos power wi bounce], starts, counts, overflow). Invalid
    photons take key GRID_SIZE and sort last. The first MAX_PER_CELL rows of
    an overflowing cell (its first photons in emission order: the sort is
    stable) carry the cell's whole power."""
    dev = pos.device
    cs = _f32(cell_size, dev)
    cell = torch.where(valid[:, None], cell_of(pos, cs), 1 << 28)
    key = torch.where(valid, hash_cell(cell[:, 0], cell[:, 1], cell[:, 2]), GRID_SIZE)
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    if bounce is None:
        bounce = torch.zeros((pos.shape[0],), dtype=torch.int32, device=dev)
    pack = torch.cat([pos, power, wi, bounce.to(torch.float32)[:, None]], dim=1)[order]
    starts, counts = _ranges(key_s)
    overflow = torch.sum(torch.clamp(counts - MAX_PER_CELL, min=0))
    ks = torch.clamp(key_s, max=GRID_SIZE - 1)
    cnt_of = counts[ks].to(torch.int64)
    st_of = starts[ks].to(torch.int64)
    en_of = st_of + cnt_of
    rank = torch.arange(pack.shape[0], device=dev) - st_of
    csum = torch.cat([torch.zeros((1, 3), device=dev), torch.cumsum(pack[:, 3:6], dim=0)], 0)
    tot_c = csum[en_of] - csum[st_of]
    kept_c = csum[torch.minimum(st_of + MAX_PER_CELL, en_of)] - csum[st_of]
    comp = (rank < MAX_PER_CELL) & (cnt_of > MAX_PER_CELL) & (key_s < GRID_SIZE)
    scale = torch.where(comp[:, None], tot_c / torch.clamp(kept_c, min=1e-30), 1.0)
    pack[:, 3:6] = pack[:, 3:6] * scale
    return pack, starts, counts, overflow


def build_beam_grid(bo, bd, blen, bpow, bmed, valid, bounce, r_beam):
    """Insert the beams into the hash grid as BEAM_STATIONS stations r_beam
    apart (photon_map.py:402-453; cells 2 r_beam wide). Returns (pack,
    starts, counts, overflow, truncated): 13 floats a station [o d len
    power bounce medium s0]. The pack holds the valid stations only, in the
    order the JAX package's stable sort of all stations gives them (the
    invalid ones sort last there and no gather reads them); `truncated` is
    the beam length past the last station."""
    dev = bo.device
    nb = bo.shape[0]
    r = _f32(r_beam, dev)
    cell_sz, step = 2.0 * r, r
    s0 = torch.arange(BEAM_STATIONS, dtype=torch.float32, device=dev)[None, :] * step
    st_valid = (valid[:, None] & (s0 < blen[:, None])).reshape(-1)
    idx = torch.nonzero(st_valid).squeeze(1)  # station ids, increasing
    beam, si = idx // BEAM_STATIONS, idx % BEAM_STATIONS
    s0_v = s0[0, si]
    st_pos = bo[beam] + bd[beam] * torch.minimum(
        s0_v + 0.5 * step, torch.clamp(blen[beam] - 1e-6, min=0.0))[:, None]
    cell = cell_of(st_pos, cell_sz)
    key = hash_cell(cell[:, 0], cell[:, 1], cell[:, 2])
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    beam_s = beam[order]
    row = torch.cat([bo, bd, blen[:, None], bpow, bounce.to(torch.float32)[:, None],
                     bmed.to(torch.float32)[:, None]], dim=1)
    pack = torch.cat([row[beam_s], s0_v[order][:, None]], dim=1)
    starts, counts = _ranges(key_s)
    overflow = torch.sum(torch.clamp(counts - MAX_PER_CELL, min=0))
    truncated = torch.sum(torch.where(valid, torch.clamp(blen - BEAM_STATIONS * step, min=0.0),
                                      0.0))
    return pack, starts, counts, overflow, truncated


def build_plane_list(pp0, pp1, pd1, pl1, ppow, pval, pbounce, seed=0):
    """The plane table (photon_map.py:584-622): MAX_PLANES rows [p0 p1 d1
    l1 power bounce], a uniform random subset with power x n_valid /
    MAX_PLANES where more are valid, padded where fewer records exist.
    Returns (rows, vmask, thinned)."""
    dev = pp0.device
    nrec = pval.shape[0]
    r = hash_cell(torch.arange(nrec, device=dev), torch.full((nrec,), int(seed) & MASK32,
                                                             device=dev),
                  torch.full((nrec,), 0x9E3779B9, device=dev))
    n_valid = torch.sum(pval)
    scale = torch.clamp(n_valid.to(torch.float32) / MAX_PLANES, min=1.0)
    rows = torch.cat([pp0, pp1, pd1, pl1[:, None], ppow * scale,
                      pbounce.to(torch.float32)[:, None]], dim=1)
    if nrec >= MAX_PLANES:
        key = torch.where(pval, r, MASK32)
        take = torch.argsort(key, stable=True)[:MAX_PLANES]
        rows, vmask = rows[take], pval[take]
    else:
        pad = MAX_PLANES - nrec
        rows = torch.cat([rows, torch.zeros((pad, rows.shape[1]), device=dev)], 0)
        vmask = torch.cat([pval, torch.zeros((pad,), dtype=torch.bool, device=dev)], 0)
    thinned = torch.clamp(n_valid - MAX_PLANES, min=0)
    return rows, vmask, thinned


# ---------------------------------------------------------------------------
# the gathers


def _pair_chunks(total):
    for s in range(0, total, PAIR_CHUNK):
        yield slice(s, min(s + PAIR_CHUNK, total))


def _volume_beam_gather(scene, o, d, seg, medium, active, vpack, vstarts, vcounts, r_vol,
                        cam_bounce):
    """Volume photon points (photon_map.py:938-1035, pointContribution,
    PhotonTracer.cpp:282-293): over every photon K7 accepts along the
    segment, 3 / (pi r^2) (1 - d^2 / r^2)^2 * phase(p.dir, -d) * Tr(0 ->
    t*) * power. Returns (N, 3)."""
    meta = scene.meta
    n = o.shape[0]
    dev = o.device
    r = float(np.float32(r_vol))
    r_t = _f32(r, dev)
    r2 = r_t * r_t
    seg = torch.where(active, seg, 0.0)
    bounce = torch.full((n,), cam_bounce, dtype=torch.int32, device=dev)
    lane, row, t_star, dist2 = photon_walk.walk(
        "points", vpack, vstarts, vcounts, o.contiguous(), d.contiguous(), seg.contiguous(),
        bounce, active, float(2.0 * r_t), r, meta.min_bounces, meta.max_bounces)
    acc = torch.zeros((n, 3), device=dev)
    mi = torch.clamp(medium, min=0)
    for sl in _pair_chunks(lane.shape[0]):
        pl, ph = lane[sl], vpack[row[sl]]
        dist = dist2[sl]
        kern = 3.0 * warps.INV_PI * (1.0 - dist / r2) ** 2 / r2
        fp = phase_eval(scene.media.phase_type[mi[pl]], scene.media.phase_g[mi[pl]],
                        ph[:, 6:9], -d[pl])
        ones = torch.ones_like(pl, dtype=torch.bool)
        tr = medium_transmittance(scene.media, medium[pl], t_star[sl], ones, ~ones, o[pl], d[pl])
        _deposit(acc, pl, (kern * fp)[:, None] * tr * ph[:, 3:6])
    return acc


def _beam1d_gather(scene, o, d, seg, medium, active, bpack, bstarts, bcounts, r_beam,
                   cam_bounce):
    """Short photon beams, the 1D estimator (photon_map.py:456-577;
    intersectBeam1D + evalBeam1D, PhotonTracer.cpp:35-66, 120-135): over
    every station K7 accepts, sigma_t(x) / sin / (2 r) * phase(b.dir, -d) *
    Tr(0 -> t) * power. Returns (N, 3)."""
    meta = scene.meta
    n = o.shape[0]
    dev = o.device
    r = float(np.float32(r_beam))
    r_t = _f32(r, dev)
    seg = torch.where(active, seg, 0.0)
    bounce = torch.full((n,), cam_bounce, dtype=torch.int32, device=dev)
    lane, row, t, inv_sin = photon_walk.walk(
        "beams", bpack, bstarts, bcounts, o.contiguous(), d.contiguous(), seg.contiguous(),
        bounce, active, float(2.0 * r_t), r, meta.min_bounces, meta.max_bounces)
    acc = torch.zeros((n, 3), device=dev)
    mi = torch.clamp(medium, min=0)
    for sl in _pair_chunks(lane.shape[0]):
        pl, b = lane[sl], bpack[row[sl]]
        tt = t[sl]
        hp = _hetero_ray(scene.media, mi[pl], o[pl], d[pl])
        dens = _hetero_density(hp, tt)
        sig_t = scene.media.sigma_t[mi[pl]] * dens[:, None]
        fp = phase_eval(scene.media.phase_type[mi[pl]], scene.media.phase_g[mi[pl]], b[:, 3:6],
                        -d[pl])
        ones = torch.ones_like(pl, dtype=torch.bool)
        tr = medium_transmittance(scene.media, medium[pl], torch.clamp(tt, min=0.0), ones, ~ones,
                                  o[pl], d[pl])
        contrib = sig_t * (inv_sin[sl] / (2.0 * r_t) * fp)[:, None] * tr * b[:, 7:10]
        _deposit(acc, pl, contrib)
    return acc


def _occluded(scene, p, d, dist):
    """Is [eps, dist * fudge] blocked (path_tracer.py:141-150)?"""
    far = torch.where(dist >= INF, INF, dist * SHADOW_FUDGE)
    near = torch.full(p.shape[:-1], DEFAULT_EPSILON, device=p.device)
    return _occluded_raw(scene, p.contiguous(), d.contiguous(), near, far)


def _plane_lanes(active):
    """The lanes of `active` in blocks of at most PLANE_LANES."""
    idx = torch.nonzero(active).squeeze(1)
    return [idx[s:s + PLANE_LANES] for s in range(0, idx.shape[0], PLANE_LANES)]


def _reservoir_pick(lum, lane_u, ci, tag, seed_u):
    """One candidate of a chunk drawn ~ its luminance (photon_map.py:725-738):
    (the chunk's luminance sum, the candidate's index a lane)."""
    C = lum.shape[1]
    w_chunk = torch.sum(lum, dim=1)
    cum = torch.cumsum(lum, dim=1)
    u1 = _mix01(lane_u, ci + tag, seed_u)
    jsel = torch.clamp(torch.sum((cum < (u1 * w_chunk)[:, None]).to(torch.int64), dim=1),
                       max=C - 1)
    return w_chunk, jsel


def _take(x, jsel):
    """x (n, C, ...) at (lane, jsel[lane])."""
    return x[torch.arange(x.shape[0], device=x.device), jsel]


def _plane0d_gather(scene, o, d, seg, medium, active, prows, pmask, cam_bounce, seed_u=0):
    """Photon planes, the 0D estimator (photon_map.py:638-764; evalPlane0D,
    PhotonTracer.cpp:138-159): the camera ray against every plane of the
    table in chunks of PLANE_CHUNK, one crossing a ray kept by a streaming
    reservoir ~ its luminance, and its one any-hit walk. Returns (N, 3)."""
    meta = scene.meta
    n = o.shape[0]
    dev = o.device
    C = PLANE_CHUNK
    est = torch.zeros((n, 3), device=dev)
    seg = torch.where(active, seg, 0.0)
    for lanes in _plane_lanes(active):
        m = lanes.shape[0]
        lo, ld, lseg, lmed = o[lanes], d[lanes], seg[lanes], medium[lanes]
        mi = torch.clamp(lmed, min=0)
        ptype, g = scene.media.phase_type[mi], scene.media.phase_g[mi]
        hp_c = _hetero_ray(scene.media, mi.repeat_interleave(C), lo.repeat_interleave(C, 0),
                           ld.repeat_interleave(C, 0))
        rx = torch.zeros((m, 3), device=dev)
        rdir = torch.zeros((m, 3), device=dev)
        rlen = torch.zeros((m,), device=dev)
        rcon = torch.zeros((m, 3), device=dev)
        rlum = torch.zeros((m,), device=dev)
        W = torch.zeros((m,), device=dev)
        for ci in range(MAX_PLANES // C):
            rows = prows[ci * C:(ci + 1) * C]
            m_ok = pmask[ci * C:(ci + 1) * C]
            p0, p1, d1 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
            l1, pw = rows[:, 9], rows[:, 10:13]
            pb = rows[:, 13].to(torch.int32)
            e1 = p1 - p0
            e2 = d1 * l1[:, None]
            P = vo.cross(ld[:, None, :].expand(m, C, 3), e2[None].expand(m, C, 3))
            det = vo.dot(e1[None], P)
            inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
            T = lo[:, None, :] - p0[None]
            u = vo.dot(T, P) * inv_det
            Q = vo.cross(T, e1[None].expand(m, C, 3))
            v = vo.dot(ld[:, None, :], Q) * inv_det
            t = vo.dot(e2[None], Q) * inv_det
            full_b = cam_bounce + pb[None, :] - 1
            ok = (m_ok[None, :] & (torch.abs(det) > 1e-7) & (u >= 0.0) & (u <= 1.0)
                  & (v >= 0.0) & (v <= 1.0) & (t > 1e-4) & (t < lseg[:, None])
                  & (full_b >= meta.min_bounces) & (full_b < meta.max_bounces))
            x = lo[:, None, :] + ld[:, None, :] * t[..., None]
            dens = _hetero_density(hp_c, torch.clamp(t, min=0.0).reshape(-1)).reshape(m, C)
            sig = scene.media.sigma_t[mi][:, None, :] * dens[..., None]
            fp = phase_eval(ptype.repeat_interleave(C), g.repeat_interleave(C),
                            d1[None].expand(m, C, 3).reshape(-1, 3),
                            (-ld).repeat_interleave(C, 0)).reshape(m, C)
            ones = torch.ones((m * C,), dtype=torch.bool, device=dev)
            tr = medium_transmittance(scene.media, lmed.repeat_interleave(C),
                                      torch.clamp(t, min=0.0).reshape(-1), ones, ~ones,
                                      lo.repeat_interleave(C, 0),
                                      ld.repeat_interleave(C, 0)).reshape(m, C, 3)
            contrib = sig * sig * (torch.abs(inv_det) * fp)[..., None] * tr * pw[None]
            contrib = torch.where(ok[..., None] & torch.isfinite(contrib), contrib, 0.0)
            lum = torch.clamp(_lum(contrib), min=0.0)
            w_chunk, jsel = _reservoir_pick(lum, lanes, ci, 0, seed_u)
            W_new = W + w_chunk
            u2 = _mix01(lanes, ci + 0x8000, seed_u)
            keep = (w_chunk > 0.0) & (u2 * W_new < w_chunk)
            rx = vo.where3(keep, _take(x, jsel), rx)
            rdir = vo.where3(keep, -d1[jsel], rdir)
            rlen = torch.where(keep, _take(v * l1[None], jsel), rlen)
            rcon = vo.where3(keep, _take(contrib, jsel), rcon)
            rlum = torch.where(keep, _take(lum, jsel), rlum)
            W = W_new
        has = (W > 0.0) & (rlum > 0.0)
        blocked = _occluded(scene, rx, rdir, torch.where(has, rlen, 0.0))
        est[lanes] = torch.where((has & ~blocked)[..., None],
                                 rcon / torch.clamp(rlum, min=1e-30)[..., None] * W[..., None],
                                 0.0)
    return est


def _plane1d_gather(scene, o, d, seg, medium, active, prows, pmask, r_pl, cam_bounce, seed_u=0):
    """Photon planes, the 1D estimator (photon_map.py:767-935; evalPlane1D,
    PhotonTracer.cpp:160-198): each plane extruded to thickness 2 r_pl, the
    camera ray's overlap with it slab-clipped, one point sampled in it; the
    control-variate term summed exactly over every crossed plane, the
    occlusion correction reservoir-sampled with one any-hit walk a ray.
    Returns (N, 3)."""
    meta = scene.meta
    n = o.shape[0]
    dev = o.device
    C = PLANE_CHUNK
    r_t = _f32(float(np.float32(r_pl)), dev)
    est = torch.zeros((n, 3), device=dev)
    seg = torch.where(active, seg, 0.0)
    for lanes in _plane_lanes(active):
        m = lanes.shape[0]
        lo, ld, lseg, lmed = o[lanes], d[lanes], seg[lanes], medium[lanes]
        mi = torch.clamp(lmed, min=0)
        ptype, g = scene.media.phase_type[mi], scene.media.phase_g[mi]
        sig_base = scene.media.sigma_t[mi]
        est_add = torch.zeros((m, 3), device=dev)
        rx = torch.zeros((m, 3), device=dev)
        rdir = torch.zeros((m, 3), device=dev)
        rlen = torch.zeros((m,), device=dev)
        rcon = torch.zeros((m, 3), device=dev)
        rlum = torch.zeros((m,), device=dev)
        W = torch.zeros((m,), device=dev)
        for ci in range(MAX_PLANES // C):
            rows = prows[ci * C:(ci + 1) * C]
            m_ok = pmask[ci * C:(ci + 1) * C]
            p0, p1, d1 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
            l1, pw = rows[:, 9], rows[:, 10:13]
            pb = rows[:, 13].to(torch.int32)
            a = p1 - p0
            b = d1 * l1[:, None]
            axd = vo.cross(a, d1)
            c = axd * (2.0 * r_t / torch.sqrt(torch.clamp(vo.length_sq(axd), min=1e-30)))[:, None]
            det = torch.abs(vo.dot(a, vo.cross(b, c)))
            geom_ok = m_ok & (det > 1e-8) & torch.isfinite(det)
            inv_det = 1.0 / torch.clamp(det, min=1e-30)
            U = vo.cross(b, c) * inv_det[:, None]
            V = vo.cross(c, a) * inv_det[:, None]
            Wx = vo.cross(a, b) * inv_det[:, None]
            P = p0 - 0.5 * c
            ro = lo[:, None, :] - P[None]
            o_l = torch.stack([vo.dot(ro, U[None]), vo.dot(ro, V[None]), vo.dot(ro, Wx[None])], -1)
            d_l = torch.stack([vo.dot(ld[:, None, :], U[None]), vo.dot(ld[:, None, :], V[None]),
                               vo.dot(ld[:, None, :], Wx[None])], -1)
            inv_dl = 1.0 / torch.where(torch.abs(d_l) < 1e-12, 1e-12, d_l)
            t0 = -o_l * inv_dl
            t1 = t0 + inv_dl
            tmin = torch.clamp(torch.amax(torch.minimum(t0, t1), -1), min=1e-4)
            tmax = torch.minimum(torch.amin(torch.maximum(t0, t1), -1), lseg[:, None])
            ctr = ((_u32(lanes)[:, None] * MAX_PLANES + ci * C
                    + torch.arange(C, device=dev)[None]) & MASK32)
            u_t = _mix01(ctr, 0x51D0, seed_u)
            t = tmin + (tmax - tmin) * u_t
            uvw = o_l + d_l * t[..., None]
            full_b = cam_bounce + pb[None, :] - 1
            ok = (geom_ok[None, :] & (tmin < tmax) & torch.all((uvw >= 0.0) & (uvw <= 1.0), -1)
                  & (full_b >= meta.min_bounces) & (full_b < meta.max_bounces))
            v1 = p0[None] + uvw[..., 0:1] * a[None]
            v2 = v1 + uvw[..., 1:2] * b[None]
            hp_v2 = _hetero_ray(scene.media, mi.repeat_interleave(C), v2.reshape(-1, 3),
                                torch.zeros((m * C, 3), device=dev))
            dens = _hetero_density(hp_v2, torch.zeros((m * C,), device=dev)).reshape(m, C)
            sigT = sig_base[:, None, :] * dens[..., None]
            fp = phase_eval(ptype.repeat_interleave(C), g.repeat_interleave(C),
                            d1[None].expand(m, C, 3).reshape(-1, 3),
                            (-ld).repeat_interleave(C, 0)).reshape(m, C)
            k_coef = sigT * sigT * (fp * inv_det[None])[..., None] * pw[None]
            k_coef = torch.where(ok[..., None] & torch.isfinite(k_coef), k_coef, 0.0)
            tm0 = torch.where(ok, tmin, 0.0)[..., None]
            tm1 = torch.where(ok, tmax, 0.0)[..., None]
            s_safe = torch.clamp(sigT, min=1e-12)
            cv = (torch.exp(-s_safe * tm0) - torch.exp(-s_safe * tm1)) / s_safe
            cv = torch.where(sigT > 1e-12, cv, tm1 - tm0)
            est_add = est_add + torch.sum(k_coef * cv, dim=1)
            ones = torch.ones((m * C,), dtype=torch.bool, device=dev)
            tr = medium_transmittance(scene.media, lmed.repeat_interleave(C),
                                      torch.where(ok, torch.clamp(t, min=0.0), 0.0).reshape(-1),
                                      ones, ~ones, lo.repeat_interleave(C, 0),
                                      ld.repeat_interleave(C, 0)).reshape(m, C, 3)
            Bc = k_coef * tr * (tm1 - tm0)
            Bc = torch.where(torch.isfinite(Bc), Bc, 0.0)
            lum = torch.clamp(_lum(Bc), min=0.0)
            w_chunk, jsel = _reservoir_pick(lum, lanes, ci, 0x4444, seed_u)
            len_sel = _take(uvw[..., 1], jsel) * l1[jsel] * 0.99
            W_new = W + w_chunk
            u2 = _mix01(lanes, ci + 0xC444, seed_u)
            keep = (w_chunk > 0.0) & (u2 * W_new < w_chunk)
            rx = vo.where3(keep, _take(v1, jsel), rx)
            rdir = vo.where3(keep, d1[jsel], rdir)
            rlen = torch.where(keep, len_sel, rlen)
            rcon = vo.where3(keep, _take(Bc, jsel), rcon)
            rlum = torch.where(keep, _take(lum, jsel), rlum)
            W = W_new
        has = (W > 0.0) & (rlum > 0.0)
        blocked = _occluded(scene, rx, rdir, torch.where(has, rlen, 0.0))
        est_sub = torch.where((has & blocked)[..., None],
                              rcon / torch.clamp(rlum, min=1e-30)[..., None] * W[..., None], 0.0)
        est[lanes] = est_add - est_sub
    return est


def _surface_gather(scene, gp, gn, gt, gb, gwi, gmat, guv, gbounce, gathered, pack, starts,
                    counts, radius, knn_count):
    """The photon density at the gather points (photon_map.py:1190-1282):
    (contrib (N, 3), r^2 a lane). K7 gives the pairs (and the kNN
    histogram); the BSDF over |cos wo| times the photon power runs on them."""
    meta = scene.meta
    mats, texs = scene.materials, scene.textures
    n = gp.shape[0]
    dev = gp.device
    rad = float(np.float32(radius))
    r_t = _f32(rad, dev)
    r2_max = r_t * r_t
    gb32 = gbounce.to(torch.int32)
    args = (pack, starts, counts, gp.contiguous(), None)
    if knn_count is not None:
        B = photon_walk.N_BINS
        hist = photon_walk.walk("hist", *args, r2_max.expand(n).contiguous(), gb32, gathered, rad,
                                0.0, meta.min_bounces, meta.max_bounces)
        cum = torch.cumsum(hist, dim=-1)
        reach = cum >= knn_count
        bin_k = torch.argmax(reach.to(torch.int32), dim=-1)
        r2_use = torch.where(torch.any(reach, dim=-1),
                             (bin_k + 1).to(torch.float32) / B * r2_max, r2_max)
    else:
        r2_use = r2_max.expand(n)
    lane, row = photon_walk.walk("surface", *args, r2_use.contiguous(), gb32, gathered, rad, 0.0,
                                 meta.min_bounces, meta.max_bounces)
    wi_l = vo.to_local(gt, gb, gn, gwi)
    contrib = torch.zeros((n, 3), device=dev)
    for sl in _pair_chunks(lane.shape[0]):
        pl, ph = lane[sl], pack[row[sl]]
        wo_ph = vo.to_local(gt[pl], gb[pl], gn[pl], ph[:, 6:9])
        pre = gather(mats, texs, gmat[pl], guv[pl])
        f = bsdf_eval(mats, pre, guv[pl], wi_l[pl], wo_ph, nonspecular_only=True, textures=texs)
        f = f / torch.clamp(torch.abs(wo_ph[:, 2]), min=1e-6)[:, None]
        _deposit(contrib, pl, f * ph[:, 3:6])
    return contrib, r2_use


def gather_pass(scene: FlatScene, seed, lane_ids, px, py, pack, starts, counts, radius,
                n_emitted, vpack=None, vstarts=None, vcounts=None, v_radius=None,
                scene_far=None, bpack=None, bstarts=None, bcounts=None, b_radius=None,
                prows=None, pmask=None, p1d_radius=None, knn_count=None):
    """The camera pass (photon_map.py:1037-1286; traceSensorPath): the
    specular chain from the camera for min(max_bounces, 8) bounces, the
    gather point at the first non-pure-specular hit with the throughput
    that reached it, the escaped and hit emission; with a volume table the
    volume estimate over every camera segment in a medium, then its
    transmittance; and the surface density. Returns (N, 3) radiance, its
    non-finite entries zeroed."""
    meta = scene.meta
    mats, texs = scene.materials, scene.textures
    dev = px.device
    n = px.shape[0]
    seed = (int(seed[0]) & MASK32, int(seed[1]) & MASK32)
    sampler = Sampler.create(seed, lane_ids)
    u_cam, sampler = sampler.next_2d()
    u_lens, sampler = sampler.next_2d()
    o, d, cam_w = camera_rays_w(scene.camera, meta, px, py, u_cam, u_lens)
    do_volume = meta.has_media and vpack is not None
    do_beams = meta.has_media and bpack is not None
    do_planes = meta.has_media and prows is not None
    n_em = _f32(n_emitted, dev)
    far_t = _f32(scene_far, dev) if scene_far is not None else None

    def vec(v=0.0):
        return torch.full((n, 3), v, device=dev)

    throughput = cam_w[..., None].expand(n, 3)
    emission = vec()
    alive = cam_w > 0.0
    gathered = torch.zeros((n,), dtype=torch.bool, device=dev)
    gp, gn, gwi, gt, gb, gthr = vec(), vec(), vec(), vec(), vec(), vec(1.0)
    gmat = torch.zeros((n,), dtype=torch.int64, device=dev)
    guv = torch.zeros((n, 2), device=dev)
    gbounce = torch.zeros((n,), dtype=torch.int64, device=dev)
    near = torch.full((n,), 1e-4, device=dev)
    medium = torch.full((n,), meta.camera_medium, dtype=torch.int64, device=dev)
    ones = torch.ones((n,), dtype=torch.bool, device=dev)
    base_dim = sampler.dim
    for k in range(min(meta.max_bounces, 8)):
        if not bool(alive.any()):
            break
        smp = Sampler(seed, sampler.lane_id, base_dim + k * DIMS_PER_BOUNCE)
        thr_in = throughput
        o, d = o.contiguous(), d.contiguous()
        hit = _intersect(scene, o, d, near, torch.where(alive, INF, 0.0))
        did_hit = (hit.prim >= 0) & alive

        if do_volume or do_beams or do_planes:
            seg = torch.where(did_hit, hit.t, far_t)
            in_med = alive & (medium >= 0)
            if do_volume:
                est = _volume_beam_gather(scene, o, d, seg, medium, in_med, vpack, vstarts,
                                          vcounts, v_radius, k + 1)
                emission = emission + throughput * est / n_em
            if do_beams:
                est_b = _beam1d_gather(scene, o, d, seg, medium, in_med, bpack, bstarts,
                                       bcounts, b_radius, k + 1)
                emission = emission + throughput * est_b / n_em
            if do_planes:
                su = (seed[1] ^ ((k * 0x9E37) & MASK32)) & MASK32
                if p1d_radius is not None:
                    est_p = _plane1d_gather(scene, o, d, seg, medium, in_med, prows, pmask,
                                            p1d_radius, k + 1, seed_u=su)
                else:
                    est_p = _plane0d_gather(scene, o, d, seg, medium, in_med, prows, pmask,
                                            k + 1, seed_u=su)
                emission = emission + throughput * est_p / n_em
            tr = medium_transmittance(scene.media, torch.where(in_med, medium, -1), seg, ones,
                                      ones, o, d)
            throughput = throughput * torch.where(in_med[..., None], tr, 1.0)

        if meta.has_env or meta.esc_caps:
            miss = alive & ~did_hit
            emission = emission + torch.where(miss[..., None],
                                              throughput * L.infinite_radiance(scene, d), 0.0)

        p, ng, ns, uv, mat_id, light_id = _shading_data(scene, hit, o, d)
        mat_pre = gather(mats, texs, mat_id, uv)
        lobes = mat_pre[3]
        frame, wi_l = _local_frame(meta, ns, d, lobes)
        if scene.lights.has_surface:
            geo_front = vo.dot(d, ng) < 0.0
            e_hit = eval_texture(texs, scene.lights.tex[torch.clamp(light_id, min=0)], uv,
                                 may=scene.lights.emit_kinds)
            emission = emission + torch.where((did_hit & (light_id >= 0) & geo_front)[..., None],
                                              throughput * e_hit, 0.0)

        # the gather point: the first non-pure-specular hit, with the
        # throughput that entered this bounce (photon_map.py:1141-1185)
        is_spec = Lobes.is_pure_specular(lobes)
        record = did_hit & ~is_spec & (lobes != 0)
        gp = vo.where3(record, p, gp)
        gn = vo.where3(record, frame[2], gn)
        gt = vo.where3(record, frame[0], gt)
        gb = vo.where3(record, frame[1], gb)
        gwi = vo.where3(record, -d, gwi)
        gmat = torch.where(record, mat_id, gmat)
        guv = torch.where(record[..., None], uv, guv)
        gbounce = torch.where(record, k + 1, gbounce)
        gthr = vo.where3(record & ~gathered, thr_in, gthr)
        gathered = gathered | record

        u2, smp = smp.next_2d()
        u1, smp = smp.next_1d()
        bs = bsdf_sample(mats, mat_pre, uv, wi_l, u2, u1, textures=texs)
        wo_w = vo.to_global(*frame, bs.wo)
        throughput = throughput * torch.where((did_hit & is_spec)[..., None], bs.weight, 1.0)
        alive = did_hit & is_spec & bs.valid & ~record
        if meta.has_media:
            tri = torch.clamp(hit.prim, min=0)
            backside_new = vo.dot(wo_w, ng) < 0.0
            override = scene.tri_med_override[tri] & did_hit
            new_med = torch.where(backside_new, scene.tri_med_int[tri], scene.tri_med_ext[tri])
            medium = torch.where(override, new_med, medium)
        o, d = p, wo_w
        near = torch.full((n,), DEFAULT_EPSILON, device=dev)

    contrib, r2_use = _surface_gather(scene, gp, gn, gt, gb, gwi, gmat, guv, gbounce, gathered,
                                      pack, starts, counts, radius, knn_count)
    density = contrib / (math.pi * r2_use[:, None] * n_em)
    emission = emission + torch.where(gathered[..., None], gthr * density, 0.0)
    return torch.where(torch.isfinite(emission), emission, 0.0)
