"""Wavefront bidirectional path tracer, torch.

Port of tungsten_tpu/integrators/bdpt.py (LightPath.cpp: tracePath
:180-206, bdptConnect :323, bdptCameraConnect, misWeight :96-178;
BidirectionalPathTracer.cpp:21-68): one camera subpath and one light
subpath a sample, every (s, t) connection weighted by area-measure MIS that
honours dirac vertices.

Each subpath is traced in lockstep into a fixed-K vertex store (`_Verts`,
(N, K, ...) tensors; K = min(max_bounces + 1, bdpt_max_vertices)) with its
surface and medium vertices, forward pass-through events folded out of the
path (their segment lengths and edge pdfs carried to the next vertex), and
the media's edge pdfs folded into the stored forward and reverse area pdfs.
The connections then run as a Python loop over the static (s, t) families:
s = 0 (the camera subpath hits a light), t >= 2 with s >= 1 (a visibility
walk between two subpath vertices) and t = 1 (a light-subpath vertex
splats to the camera through the light tracer's `splat_filtered`). Each
family is one full-wavefront crossing walk (`_trace_transparent`); the MIS
weight is the balance of pdf-ratio products with the four junction
overrides of the family (`_mis_weight_static`), as in the JAX package.
The subpath loop stops once no lane lives (one `.item()` a vertex), its
sampler advanced as if it had run every step.

Not carried: the MLT arguments of the JAX `_bdpt_sample` (the primary-sample
`table` with `skip_dims`, the technique selector `sel`, `collect` and
`return_verts`); the Kelemen and multiplexed slices add them where the
sampler is created and where each family's contribution lands.
"""
from __future__ import annotations

import torch

from ..math import vecops as vo
from ..models.bsdfs.common import Lobes
from ..models.bsdfs.dispatch import (bsdf_eta_sq, bsdf_eval, bsdf_pdf, bsdf_sample,
                                     forward_transparency, gather)
from ..models.cameras.connect import camera_sample_direct
from ..models.cameras.pinhole import camera_rays_w
from ..models.media.media import medium_distance_pdf
from ..models.phase.phase import phase_eval, phase_sample
from ..models.primitives import lights as L
from ..models.textures.textures import eval_texture
from ..sampling import warps
from ..sampling.sampler import MASK32, Sampler
from ..scene.flatten import DEFAULT_EPSILON, FlatScene
from .light_tracer import _adjoint_correction, splat_filtered
from .path_tracer import (INF, SHADOW_FUDGE, _intersect, _medium_handoff, _medium_interaction,
                          _select_medium_dir, _shading_data, _trace_transparent)

# vertex kinds
V_INVALID = 0
V_SURFACE = 1
V_MEDIUM = 2
V_LIGHT = 3  # the light subpath's root, on an emitter
V_CAMERA = 4  # the camera subpath's root

BDPT_PASS_SEED = 0x20000  # pass i runs under (seed, BDPT_PASS_SEED + i) (bdpt.py:491)

# the vertex store's fields: (trailing shape, dtype, fill)
_FIELDS = {
    "kind": ((), torch.int64, V_INVALID),
    "p": ((3,), torch.float32, 0.0),
    "ng": ((3,), torch.float32, 0.0),
    "nf": ((3,), torch.float32, 0.0),  # the shading normal, flipped two-sided
    "wi": ((3,), torch.float32, 0.0),  # unit direction toward the previous vertex
    "throughput": ((3,), torch.float32, 0.0),
    "pdf_fwd": ((), torch.float32, 0.0),  # area pdf of this vertex from the previous
    "pdf_rev": ((), torch.float32, 0.0),  # area pdf of this vertex from the next
    "edge_med_bwd": ((), torch.float32, 1.0),  # medium backward pdf of the edge to the next
    "mat": ((), torch.int64, 0),
    "uv": ((2,), torch.float32, 0.0),
    "light": ((), torch.int64, -1),
    "dirac": ((), torch.bool, False),
    "medium": ((), torch.int64, -1),
    "tri": ((), torch.int64, -1),  # the surface prim (media selection)
    "flip": ((), torch.bool, False),  # the two-sided shading-frame flip
}


def _remap0(x):
    return torch.where(x > 0.0, x, 1.0)


def _solid_to_area(pdf_solid, d, dist_sq, ng, kind):
    """A solid-angle pdf at the source -> the area pdf at the target vertex
    (no cosine at a medium vertex)."""
    cos_t = torch.abs(vo.dot(d, ng))
    jac = torch.where(kind == V_MEDIUM, 1.0, cos_t) / torch.clamp(dist_sq, min=1e-20)
    return pdf_solid * jac


class _Verts:
    """SoA vertex store: one (N, K, ...) tensor per field of `_FIELDS`."""

    def __init__(self, n, k, dev):
        self.lanes = torch.arange(n, device=dev)
        for name, (shape, dtype, fill) in _FIELDS.items():
            setattr(self, name, torch.full((n, k) + shape, fill, dtype=dtype, device=dev))

    def set_slot(self, k, **fields):
        """Slot k (static) of every lane."""
        for name, val in fields.items():
            getattr(self, name)[:, k] = val

    def get(self, idx, names):
        """{name: field at the per-lane slot idx (N,)}."""
        return {name: getattr(self, name)[self.lanes, idx] for name in names}

    def put(self, idx, store, **fields):
        """field[lane, idx] = val where store, per lane."""
        for name, val in fields.items():
            arr = getattr(self, name)
            old = arr[self.lanes, idx]
            mask = store.reshape(store.shape + (1,) * (old.dim() - 1))
            arr[self.lanes, idx] = torch.where(mask, val, old)

    def at(self, scene, i):
        """Every field at static slot i, contiguous (the walks take its
        points as ray origins), and the slot's gathered material rows under
        "pre" (read by `_vertex_fg`)."""
        v = {name: getattr(self, name)[:, i].contiguous() for name in _FIELDS}
        v["pre"] = gather(scene.materials, scene.textures, v["mat"], v["uv"])
        return v


def _vertex_fg(scene: FlatScene, v, wi_world, wo_world):
    """f * cos (the phase function at a medium vertex) and the forward
    solid-angle pdf at a stored vertex, for the direction wi_world toward
    the previous vertex and wo_world out (bdpt.py:111-133). v: "nf", "uv",
    "pre" (its gathered material rows), "medium", "kind"."""
    mats, texs = scene.materials, scene.textures
    t_ax, b_ax = vo.tangent_frame(v["nf"])
    wi_l = vo.to_local(t_ax, b_ax, v["nf"], wi_world)
    wo_l = vo.to_local(t_ax, b_ax, v["nf"], wo_world)
    f = bsdf_eval(mats, v["pre"], v["uv"], wi_l, wo_l, textures=texs)
    p = bsdf_pdf(mats, v["pre"], v["uv"], wi_l, wo_l, textures=texs)
    if scene.meta.has_media:
        mi = torch.clamp(v["medium"], min=0)
        # the phase convention: eval(d_in, d_out), d_in the propagation direction
        fp = phase_eval(scene.media.phase_type[mi], scene.media.phase_g[mi], -wi_world, wo_world)
        is_med = v["kind"] == V_MEDIUM
        f = torch.where(is_med[..., None], fp[..., None], f)
        p = torch.where(is_med, fp, p)
    return f, p


def _adjoint_factor(v, wo_world):
    """The shading-normal correction at a light-subpath vertex (Bsdf.hpp's
    adjoint branch; bdpt.py:463-476); 1 at medium vertices."""
    corr = torch.abs((vo.dot(wo_world, v["ng"]) * vo.dot(v["wi"], v["nf"]))
                     / torch.clamp(torch.abs(vo.dot(v["wi"], v["ng"])
                                             * vo.dot(wo_world, v["nf"])), min=1e-20))
    return torch.where(v["kind"] == V_MEDIUM, 1.0, corr)


def _trace_subpath(scene: FlatScene, sampler: Sampler, o, d, beta, pdf_dir, root, root_alive,
                   root_medium, k_max, adjoint):
    """Trace a subpath from (o, d) (bdpt.py:136-382): slot 0 the root (its
    fields `root`), slots 1.. the scattering vertices. beta: the throughput
    after the root; pdf_dir: the solid-angle pdf of d. Returns (_Verts, the
    lanes' vertex counts (N,), the sampler after k_max - 1 steps)."""
    meta = scene.meta
    mats, texs = scene.materials, scene.textures
    n, dev = o.shape[0], o.device
    media = meta.has_media
    verts = _Verts(n, k_max, dev)
    verts.set_slot(0, **root)
    alive = root_alive
    medium = root_medium
    first_scatter = torch.ones((n,), dtype=torch.bool, device=dev)
    med_bounce = torch.zeros((n,), dtype=torch.int64, device=dev)
    n_verts = torch.ones((n,), dtype=torch.int64, device=dev)
    near = torch.full((n,), DEFAULT_EPSILON, device=dev)
    seg_base = torch.zeros((n,), device=dev)
    edge_fwd_base = torch.ones((n,), device=dev)
    false = torch.zeros((n,), dtype=torch.bool, device=dev)
    smp = sampler
    step_dims = 0
    for k in range(1, k_max):
        if not bool(alive.any().item()):
            # the remaining steps would store nothing: advance the sampler
            # as they would have (every step consumes the same dims)
            smp = smp.skip(step_dims * (k_max - k))
            break
        dim0 = smp.dim
        hit = _intersect(scene, o, d, near, torch.where(alive, INF, 0.0))
        did_hit = (hit.prim >= 0) & alive
        if media:
            ms, smp = _medium_interaction(scene, smp, medium, o, d,
                                          torch.where(did_hit, hit.t, INF), alive,
                                          first_scatter, med_bounce)
            beta = beta * torch.where(alive[..., None], ms.weight, 1.0)
            scattered = ms.scattered & alive
            hit_surface = ms.exited & did_hit
            alive = alive & (scattered | hit_surface)
            # the edge's medium pdfs (PathVertex.cpp:156-163): forward, the
            # distance sampler's pdf of this segment
            edge_fwd_med = torch.where(medium >= 0, ms.pdf, 1.0)
        else:
            smp = smp.skip(3)
            scattered = false
            hit_surface = did_hit
            alive = alive & did_hit

        p_srf, ng, ns, uv, mat_id, light_id = _shading_data(scene, hit, o, d)
        pre = gather(mats, texs, mat_id, uv)
        lobes = pre[3]
        flip = ((vo.dot(ns, d) > 0.0) & ~Lobes.is_transmissive(lobes) if meta.enable_two_sided
                else false)
        nf = vo.where3(flip, -ns, ns)
        if media:
            vp = vo.where3(scattered, ms.p, p_srf)
            kind = torch.where(scattered, V_MEDIUM, torch.where(hit_surface, V_SURFACE, V_INVALID))
            seg_sq = torch.where(scattered, ms.t, hit.t) ** 2
        else:
            vp = p_srf
            kind = torch.where(hit_surface, V_SURFACE, V_INVALID)
            seg_sq = hit.t ** 2

        # a pure forward event (a window the path looks through) is folded
        # out of the path (LightPath.cpp:36-53): no vertex, the ray goes on
        # straight, and the summed segment length feeds the next vertex's
        # area pdf
        fwd_evt = hit_surface & Lobes.is_forward(lobes)
        seg_len = torch.sqrt(torch.clamp(seg_sq, min=0.0)) + seg_base
        seg_sq = seg_len * seg_len
        pdf_fwd_area = _solid_to_area(pdf_dir, d, seg_sq, ng, kind)
        if media:  # LightPath.cpp:66-71: pdfForward *= edge.pdfForward
            pdf_fwd_area = pdf_fwd_area * edge_fwd_base * edge_fwd_med
        store = alive & ~fwd_evt
        idx = torch.clamp(n_verts, 0, k_max - 1)
        nf_v = vo.where3(scattered, -d, nf) if media else nf
        verts.put(idx, store, kind=kind, p=vp, ng=vo.where3(scattered, -d, ng) if media else ng,
                  nf=nf_v, wi=-d, throughput=beta, pdf_fwd=pdf_fwd_area, mat=mat_id, uv=uv,
                  light=torch.where(hit_surface, light_id, -1), dirac=false, medium=medium,
                  tri=torch.where(hit_surface, hit.prim, -1), flip=flip & hit_surface)
        n_verts = torch.where(store, n_verts + 1, n_verts)

        # the continuation
        t_ax, b_ax = vo.tangent_frame(nf)
        t_ax = vo.where3(flip, -t_ax, t_ax)
        wi_l = vo.to_local(t_ax, b_ax, nf, -d)
        u2, smp = smp.next_2d()
        u1, smp = smp.next_1d()
        bs = bsdf_sample(mats, pre, uv, wi_l, u2, u1, textures=texs)
        wo_w = vo.to_global(t_ax, b_ax, nf, bs.wo)
        w_step, pdf_next = bs.weight, bs.pdf
        if adjoint:
            eta2 = bsdf_eta_sq(mats, pre, wi_l, bs.wo)
            corr = _adjoint_correction(wi_l, bs.wo, -d, wo_w, ng)
            w_step = w_step * (corr / torch.clamp(eta2, min=1e-20))[..., None]
        if media:
            mi = torch.clamp(medium, min=0)
            w_ph, pdf_ph = phase_sample(scene.media.phase_type[mi], scene.media.phase_g[mi], d, u2)
            wo_w = vo.where3(scattered, w_ph, wo_w)
            w_step = torch.where(scattered[..., None], 1.0, w_step)
            pdf_next = torch.where(scattered, pdf_ph, pdf_next)
        if meta.has_forward:
            transp = forward_transparency(mats, pre, uv, wi_l, texs)
            wo_w = vo.where3(fwd_evt, d, wo_w)
            w_step = torch.where(fwd_evt[..., None], transp, w_step)
            pdf_next = torch.where(fwd_evt, pdf_dir, pdf_next)
        verts.put(idx, store, dirac=Lobes.has_specular(bs.lobe) & hit_surface)

        # the reverse pdf of the PREVIOUS vertex: sampling (wo -> wi) here
        _, p_rev_solid = _vertex_fg(scene, dict(nf=nf_v, uv=uv, pre=pre, medium=medium,
                                                kind=kind), wo_w, -d)
        pidx = torch.clamp(idx - 1, min=0)
        prev = verts.get(pidx, ("p", "ng", "kind"))
        dvec = prev["p"] - vp
        p_rev_area = _solid_to_area(p_rev_solid, vo.normalize(dvec, eps=1e-12),
                                    vo.length_sq(dvec), prev["ng"], prev["kind"])
        if media:
            # LightPath.cpp:70: pdfBackward *= edge.pdfBackward, the reverse
            # segment's distance pdf with its endpoint types swapped
            # (PathVertex.cpp:161-163); kept apart too, for the junction
            # overrides that replace pdf_rev over the same edge
            edge_bwd = medium_distance_pdf(
                scene.media, torch.where(store, medium, -1), vp, -d,
                torch.sqrt(torch.clamp(seg_sq, min=1e-24)), start_on_surface=kind != V_MEDIUM,
                end_on_surface=prev["kind"] != V_MEDIUM)
            emb = torch.where(medium >= 0, edge_bwd, 1.0)
            p_rev_area = p_rev_area * emb
            verts.put(pidx, store, edge_med_bwd=emb)
        verts.put(pidx, store, pdf_rev=p_rev_area)

        beta = beta * torch.where(alive[..., None], w_step, 1.0)
        alive = alive & torch.where(hit_surface & ~fwd_evt, bs.valid, True)
        alive = alive & (vo.max3(torch.abs(beta)) > 0.0)
        if media:
            first_scatter = first_scatter & ~scattered
            med_bounce = torch.where(scattered, med_bounce + 1, med_bounce)
            medium, first_scatter, med_bounce = _medium_handoff(
                scene, hit.prim, wo_w, ng, hit_surface, medium, first_scatter, med_bounce)
            edge_fwd_base = torch.where(fwd_evt, edge_fwd_base * edge_fwd_med, 1.0)
        o, d, pdf_dir = vp, wo_w, pdf_next
        near = torch.where(scattered, 0.0, DEFAULT_EPSILON)
        seg_base = torch.where(fwd_evt, seg_len, 0.0)
        smp = smp.skip(0)
        step_dims = smp.dim - dim0
    return verts, n_verts, smp


def _mis_weight_static(cv: _Verts, lv: _Verts, s, t, over_rev_c1, over_rev_c2, over_rev_l1,
                       over_rev_l2):
    """The balance heuristic of strategy (s, t) as a sum of pdf-ratio
    products (PBRT's form of LightPath::misWeight; bdpt.py:413-452), with the
    four junction reverse-pdf overrides (cam[t-1], cam[t-2], light[s-1],
    light[s-2]); s and t are Python ints, so the walks unroll."""
    n = cv.pdf_fwd.shape[0]
    dev = cv.pdf_fwd.device
    sum_ri = torch.zeros((n,), device=dev)

    def rev_c(i):
        if i == t - 1 and over_rev_c1 is not None:
            return over_rev_c1
        if i == t - 2 and over_rev_c2 is not None:
            return over_rev_c2
        return cv.pdf_rev[:, i]

    def rev_l(i):
        if i == s - 1 and over_rev_l1 is not None:
            return over_rev_l1
        if i == s - 2 and over_rev_l2 is not None:
            return over_rev_l2
        return lv.pdf_rev[:, i]

    ri = torch.ones((n,), device=dev)
    for i in range(t - 1, 0, -1):
        ri = ri * _remap0(rev_c(i)) / _remap0(cv.pdf_fwd[:, i])
        # the i == 1 term is the technique (s + t - 1, 1); (1, 1) is not in
        # the estimator's set (an area light has no directional splat,
        # Primitive::evalDirectionalEmission == 0), so it drops out
        if not (i == 1 and s + t < 3):
            ok = ~cv.dirac[:, i] & ~cv.dirac[:, i - 1]
            sum_ri = sum_ri + torch.where(ok, ri, 0.0)
    ri = torch.ones((n,), device=dev)
    for i in range(s - 1, -1, -1):
        ri = ri * _remap0(rev_l(i)) / _remap0(lv.pdf_fwd[:, i])
        ok = ~lv.dirac[:, i]
        if i > 0:
            ok = ok & ~lv.dirac[:, i - 1]
        sum_ri = sum_ri + torch.where(ok, ri, 0.0)
    return 1.0 / (1.0 + sum_ri)


def _camera_dir_pdf(scene: FlatScene, d):
    """The pinhole's solid-angle pdf of direction d (N, 3) leaving it:
    1 / (film area at unit distance * cos^3)."""
    meta, cam = scene.meta, scene.camera
    ratio = meta.res_y / meta.res_x
    cosz = torch.clamp((d @ cam.rot)[..., 2], min=1e-6)
    inv_plane_area = 1.0 / ((2.0 / cam.plane_dist) * (2.0 * ratio / cam.plane_dist))
    return inv_plane_area / cosz ** 3


def _bdpt_sample(scene: FlatScene, seed, lane_ids, px, py, pyramid=False):
    """One BDPT sample per lane (bdpt.py:517-860, without the MLT
    arguments). Returns (eye (N, 3), splat (W*H, 3)), and with `pyramid`
    also {(s, t): the family's per-lane add (t >= 2) or splat buffer
    (t = 1)}, the reference's ImagePyramid decomposition."""
    meta = scene.meta
    dev = px.device
    n = px.shape[0]
    media = meta.has_media
    # LightPath(maxBounces + 1) vertices a subpath (BidirectionalPathTracer.cpp:14-15),
    # capped by the scene's bdpt_max_vertices
    k_max = min(meta.max_bounces + 1, meta.bdpt_max_vertices)
    seed = (int(seed[0]) & MASK32, int(seed[1]) & MASK32)
    sampler = Sampler.create(seed, lane_ids)
    ones = torch.ones((n,), dtype=torch.bool, device=dev)
    no_med = torch.full((n,), -1, dtype=torch.int64, device=dev)

    # ---- the camera subpath ----
    u_cam, sampler = sampler.next_2d()
    u_lens, sampler = sampler.next_2d()
    o, d, cam_w = camera_rays_w(scene.camera, meta, px, py, u_cam, u_lens)
    cam_n = scene.camera.rot[:, 2].expand(n, 3)
    # not dirac: the t = 1 splat technique takes part in MIS
    cam_root = dict(kind=V_CAMERA, p=scene.camera.pos.expand(n, 3), ng=cam_n, nf=cam_n,
                    throughput=1.0, pdf_fwd=1.0, dirac=False)
    cv, n_cv, sampler = _trace_subpath(
        scene, sampler, o.contiguous(), d.contiguous(), cam_w[..., None].expand(n, 3),
        _camera_dir_pdf(scene, d), cam_root, ones, torch.full_like(no_med, meta.camera_medium),
        k_max, adjoint=False)

    # ---- the light subpath ----
    u_li, sampler = sampler.next_1d()
    li = torch.clamp((u_li * meta.n_lights).to(torch.int64), max=meta.n_lights - 1)
    pick = 1.0 / meta.n_lights
    u_tri, sampler = sampler.next_1d()
    u_pos, sampler = sampler.next_2d()
    em = L.sample_emitter_position(scene, li, u_tri, u_pos)
    u_dir, sampler = sampler.next_2d()
    d_loc = warps.cosine_hemisphere(u_dir)
    t_e, b_e = vo.tangent_frame(em.ng)
    beta_l = em.weight / pick  # pi * A * Le / pick; the cosine direction's weight is 1
    light_root = dict(kind=V_LIGHT, p=em.p, ng=em.ng, nf=em.ng, uv=em.uv, throughput=beta_l,
                      pdf_fwd=pick / torch.clamp(scene.lights.area[li], min=1e-20),
                      dirac=False, light=li)
    # an emitted ray leaves into the light surface's exterior medium
    root_med = scene.tri_med_ext[torch.clamp(em.tri, min=0)] if media else no_med
    lv, n_lv, sampler = _trace_subpath(
        scene, sampler, em.p, vo.to_global(t_e, b_e, em.ng, d_loc), beta_l,
        warps.cosine_hemisphere_pdf(d_loc), light_root, em.valid, root_med, k_max, adjoint=True)

    cvs = [cv.at(scene, i) for i in range(k_max)]
    lvs = [lv.at(scene, i) for i in range(k_max)]
    eye = torch.zeros((n, 3), device=dev)
    splat = torch.zeros((meta.res_x * meta.res_y, 3), device=dev)
    pyr = {}

    # ---- s = 0: the camera subpath hits a light ----
    for t in range(2, k_max + 1):
        C, P = cvs[t - 1], cvs[t - 2]
        lid = torch.clamp(C["light"], min=0)
        on_light = (C["light"] >= 0) & (C["kind"] == V_SURFACE) & (t <= n_cv)
        front = vo.dot(-C["wi"], C["ng"]) < 0.0  # emission is one-sided, along +ng
        le = eval_texture(scene.textures, scene.lights.tex[lid], C["uv"])
        # the junction overrides: rev(C_{t-1}) = the light's position pdf,
        # rev(C_{t-2}) = its cosine direction pdf as an area pdf
        over_c1 = pick / torch.clamp(scene.lights.area[lid], min=1e-20)
        dvec = P["p"] - C["p"]
        dn = vo.normalize(dvec, eps=1e-12)
        over_c2 = _solid_to_area(torch.abs(vo.dot(dn, C["ng"])) * warps.INV_PI, dn,
                                 vo.length_sq(dvec), P["ng"], P["kind"])
        if media:
            over_c2 = over_c2 * cv.edge_med_bwd[:, t - 2]
        w = _mis_weight_static(cv, lv, 0, t, over_c1, over_c2, None, None)
        add = torch.where((on_light & front)[..., None], C["throughput"] * le * w[..., None], 0.0)
        eye = eye + add
        if pyramid:
            pyr[(0, t)] = add

    # ---- s >= 1, t >= 2: connect a camera vertex to a light vertex ----
    for t in range(2, k_max + 1):
        for s in range(1, k_max + 1 - t):  # s + t - 1 segments <= max_bounces
            C, Lv, P = cvs[t - 1], lvs[s - 1], cvs[t - 2]
            exists = ((t <= n_cv) & (s <= n_lv) & ~C["dirac"] & ~Lv["dirac"]
                      & (C["kind"] != V_INVALID) & (Lv["kind"] != V_INVALID))
            dvec = Lv["p"] - C["p"]
            dsq = torch.clamp(vo.length_sq(dvec), min=1e-20)
            dist = torch.sqrt(dsq)
            dn = dvec / dist[..., None]
            fC, pC_solid = _vertex_fg(scene, C, C["wi"], dn)
            if s == 1:
                cos_l = torch.clamp(vo.dot(-dn, Lv["ng"]), min=0.0)
                fL = (cos_l * warps.INV_PI)[..., None].expand(n, 3)
                pLC_solid = cos_l * warps.INV_PI
            else:
                fL, pLC_solid = _vertex_fg(scene, Lv, Lv["wi"], -dn)
                fL = fL * _adjoint_factor(Lv, -dn)[..., None]
            contrib = C["throughput"] * fC * fL * Lv["throughput"] / dsq[..., None]
            cand = exists & torch.any(contrib > 0.0, dim=-1)
            c_surf, l_surf = C["kind"] != V_MEDIUM, Lv["kind"] != V_MEDIUM
            med = None
            if media:
                # the connection leaves C toward Lv in C's medium on that side
                # (LightPath.cpp:358, PathVertex.cpp:379-388)
                med = torch.where(cand, _select_medium_dir(scene, C["medium"], C["tri"], dn,
                                                           C["kind"] == V_SURFACE, p=C["p"]), -1)
            w_vis, h_vis = _trace_transparent(scene, C["p"], dn,
                                              torch.where(cand, dist * SHADOW_FUDGE, 0.0), med,
                                              c_surf, l_surf)
            visible = cand & (h_vis.prim < 0)
            contrib = contrib * w_vis
            # the connection edge's medium distance pdfs (LightPath.cpp:358-361,
            # PathVertex.cpp:303-325), folded into the junction overrides
            if media:
                edge_cl = medium_distance_pdf(scene.media, med, C["p"], dn, dist, c_surf, l_surf)
                edge_lc = medium_distance_pdf(scene.media, med, Lv["p"], -dn, dist, l_surf,
                                              c_surf)
            else:
                edge_cl = edge_lc = 1.0
            # rev(C_{t-1}): C from Lv; rev(C_{t-2}): C scattering backward
            over_c1 = _solid_to_area(pLC_solid, -dn, dsq, C["ng"], C["kind"]) * edge_lc
            bvec = P["p"] - C["p"]
            bsq = torch.clamp(vo.length_sq(bvec), min=1e-20)
            bn = bvec / torch.sqrt(bsq)[..., None]
            _, pCB_solid = _vertex_fg(scene, C, dn, bn)
            over_c2 = _solid_to_area(pCB_solid, bn, bsq, P["ng"], P["kind"])
            if media:
                over_c2 = over_c2 * cv.edge_med_bwd[:, t - 2]
            # rev(L_{s-1}): Lv from C; rev(L_{s-2}): Lv scattering backward
            over_l1 = _solid_to_area(pC_solid, dn, dsq, Lv["ng"], Lv["kind"]) * edge_cl
            over_l2 = _over_l2(scene, lv, lvs, s, -dn) if s >= 2 else None
            w = _mis_weight_static(cv, lv, s, t, over_c1, over_c2, over_l1, over_l2)
            add = torch.where(visible[..., None], contrib * w[..., None], 0.0)
            eye = eye + add
            if pyramid:
                pyr[(s, t)] = add

    # ---- t = 1: light-subpath vertices splat to the camera ----
    for s in range(2, k_max):
        Lv = lvs[s - 1]
        exists = (s <= n_lv) & ~Lv["dirac"] & (Lv["kind"] != V_INVALID)
        dc, distc, cam_w, pixel, vld = camera_sample_direct(scene.camera, meta, Lv["p"])
        fL, _ = _vertex_fg(scene, Lv, Lv["wi"], dc)
        fL = fL * _adjoint_factor(Lv, dc)[..., None]
        cand = exists & vld & torch.any(fL > 0.0, dim=-1)
        l_surf = Lv["kind"] != V_MEDIUM
        med = None
        if media:  # the splat walk leaves Lv toward the camera (LightPath.cpp:344)
            med = torch.where(cand, _select_medium_dir(scene, Lv["medium"], Lv["tri"], dc,
                                                       Lv["kind"] == V_SURFACE, p=Lv["p"]), -1)
        w_vis, h_vis = _trace_transparent(scene, Lv["p"], dc,
                                          torch.where(cand, distc * SHADOW_FUDGE, 0.0), med,
                                          l_surf, ones)
        visible = cand & (h_vis.prim < 0)
        value = Lv["throughput"] * fL * w_vis * cam_w[:, None]
        # MIS: the camera side is the root alone; rev(L_{s-1}) = the
        # camera's direction pdf as an area pdf
        over_l1 = _solid_to_area(_camera_dir_pdf(scene, -dc), -dc, distc ** 2, Lv["ng"],
                                 Lv["kind"])
        if media:  # the camera edge's distance pdf, camera -> Lv (a surface endpoint)
            over_l1 = over_l1 * medium_distance_pdf(scene.media, med,
                                                    Lv["p"] + dc * distc[..., None], -dc, distc,
                                                    ones, l_surf)
        over_l2 = _over_l2(scene, lv, lvs, s, dc)
        w = _mis_weight_static(cv, lv, s, 1, None, None, over_l1, over_l2)
        value = value * w[..., None]
        splat_filtered(splat, pixel, value, visible, meta.res_x, meta.res_y, meta.filter)
        if pyramid:
            pyr[(s, 1)] = splat_filtered(torch.zeros_like(splat), pixel, value, visible,
                                         meta.res_x, meta.res_y, meta.filter)

    eye = torch.where(torch.isfinite(eye), eye, 0.0)
    splat = torch.where(torch.isfinite(splat), splat, 0.0)
    if pyramid:
        return eye, splat, pyr
    return eye, splat


def _over_l2(scene: FlatScene, lv: _Verts, lvs, s, w_out):
    """rev(L_{s-2}): the pdf at L_{s-1} of scattering back toward L_{s-2}
    when its path leaves along w_out, as an area pdf at L_{s-2}, with the
    stored edge's medium pdf."""
    Lv, Q = lvs[s - 1], lvs[s - 2]
    qvec = Q["p"] - Lv["p"]
    qsq = torch.clamp(vo.length_sq(qvec), min=1e-20)
    qn = qvec / torch.sqrt(qsq)[..., None]
    _, p_solid = _vertex_fg(scene, Lv, w_out, qn)
    out = _solid_to_area(p_solid, qn, qsq, Q["ng"], Q["kind"])
    if scene.meta.has_media:
        out = out * lv.edge_med_bwd[:, s - 2]
    return out


def trace_bdpt_pass(scene: FlatScene, seed, lane_ids, px, py):
    """One BDPT sample per lane (bdpt.py:510-514). Returns (eye radiance
    (N, 3), splat buffer (W*H, 3)); the t = 1 techniques land in the splat
    buffer, normalized per light path as the light tracer's."""
    return _bdpt_sample(scene, seed, lane_ids, px, py)


def trace_bdpt_pass_pyramid(scene: FlatScene, seed, lane_ids, px, py):
    """One BDPT sample with the per-technique (s, t) decomposition kept
    (ImagePyramid.cpp:20-40; bdpt.py:502-506): (eye, splat, {(s, t): the
    per-lane add, or the t = 1 splat buffer})."""
    return _bdpt_sample(scene, seed, lane_ids, px, py, pyramid=True)


def trace_bdpt_batch(scene: FlatScene, seed, lane_ids, px, py, base_pass: int,
                     n_passes: int = 1):
    """The summed (eye, splat) of n_passes BDPT passes; pass i runs under
    the seed (seed[0], BDPT_PASS_SEED + base_pass + i) (bdpt.py:483-498)."""
    n_pix = scene.meta.res_x * scene.meta.res_y
    eye = torch.zeros((px.shape[0], 3), device=px.device)
    splat = torch.zeros((n_pix, 3), device=px.device)
    for i in range(n_passes):
        e, s = trace_bdpt_pass(scene, (seed[0], BDPT_PASS_SEED + base_pass + i), lane_ids, px, py)
        eye, splat = eye + e, splat + s
    return eye, splat
