"""Reversible-jump MLT (Bitterli & Jarosz 2017), torch.

Port of tungsten_tpu/integrators/rjmlt.py (src/core/integrators/
reversible_jump_mlt/). MMLT keeps one chain population per path length V
and samples the technique s inside the chain, but changing s draws the
whole path anew. RJ-MLT adds a strategy perturbation that keeps the
geometric path and jumps to another technique (s', t' = V - s') by
inverting the path back into primary-sample space for the new split
(ReversibleJumpMltTracer.cpp:154-209, LightPath::invert): the acceptance
then weighs one path under two techniques.

The chain state is the (N, D, 2) table (kelemen.py). A strategy step
replays the current tables with their vertex stores kept, gathers the
realized chain z_0 .. z_{V-1} (camera root .. light root), and rewrites
the table slots that differ under s':
  - camera scatter groups i in [t_old - 1, t_new - 1): bsdf_invert at z_i;
  - the light root's slots (s_old == 0 -> s' >= 1): the emitter CDF and
    barycentric inversion of z_{V-1};
  - the light's first direction (s_old <= 1 -> s' >= 2): the cosine inverse;
  - light scatter groups j in [max(s_old - 1, 1), s_new - 1): bsdf_invert;
  - the pixel and filter slots (t_old == 1 -> t' >= 2): the pinhole film
    inversion.
Every other slot is kept, so the unchanged subpath prefixes replay bit for
bit. A lane whose chain holds a vertex that does not invert (a medium
vertex, a wrapper BSDF, a pixel outside the filter's support) gets
proposal weight 0, the reference's failure path.

Every STRATEGY_EVERY-th step is a strategy move for all lanes (a cycle of
MCMC kernels), the others the Kelemen mutations of kelemen.mlt_steps_bdpt.
"""
from __future__ import annotations

import torch

from ..math import vecops as vo
from ..parallel import mesh as pm
from ..sampling import warps
from ..scene.flatten import FlatScene
from .bdpt import V_SURFACE, _bdpt_sample
from .kelemen import (_chain_pixels, _luminance, _ntech_lanes, _pixel_f, _rand, _row0, _scale_ev,
                      _select_technique, _splat_pair, _ev_accept, mlt_steps_bdpt)

STRATEGY_EVERY = 4  # every 4th mutation is a strategy perturbation
_STRATEGY_SALT = 0xC0FFEE  # the strategy step's seed word: seed[0] xor this
STRATEGY_STEP0 = 0x4000  # the strategy step after step it runs as step 0x4000 + it


def _take_slot(tree, idx):
    """Slot idx (N,) of every (N, K, ...) field of a vertex store."""
    out = {}
    for name, arr in tree.items():
        ix = torch.clamp(idx, 0, arr.shape[1] - 1)
        out[name] = arr[torch.arange(arr.shape[0], device=arr.device), ix]
    return out


def _where_tree(on, a, b):
    return {k: torch.where(on.reshape((-1,) + (1,) * (a[k].dim() - 1)), a[k], b[k]) for k in a}


def _chain_at(cv, lv, t_old, v, i):
    """Vertex z_i of the realized chain: the camera side for i < t_old, the
    light side (reversed) beyond. i a Python int, t_old and v (N,)."""
    c = {k: a[:, min(i, a.shape[1] - 1)] for k, a in cv.items()}
    return _where_tree(i < t_old, c, _take_slot(lv, v - 1 - i))


def _chain_dyn(cv, lv, t_old, v, idx):
    """Vertex z_idx of the realized chain, idx (N,)."""
    return _where_tree(idx < t_old, _take_slot(cv, idx), _take_slot(lv, v - 1 - idx))


def _local_frame(nf, flip):
    t_ax, b_ax = vo.tangent_frame(nf)
    return vo.where3(flip, -t_ax, t_ax), b_ax, nf


def _tent_cdf(t):
    return torch.where(t < 0.0, 0.5 * (t + 1.0) ** 2, 1.0 - 0.5 * (1.0 - t) ** 2)


def _invert_camera_pixel(scene: FlatScene, meta, d, mu):
    """The pinhole film inversion: a world direction -> (u_pix (N, 2), u_cam
    (N, 2), ok). Only the pinhole with the box, tent or dirac filter
    inverts; another camera or filter reports ok=False (rejected)."""
    n, dev = d.shape[0], d.device
    if meta.camera_type != "pinhole" or meta.filter not in ("box", "tent", "dirac"):
        z2 = torch.full((n, 2), 0.5, device=dev)
        return z2, z2, torch.zeros((n,), dtype=torch.bool, device=dev)
    w, h = meta.res_x, meta.res_y
    ratio = h / w
    local = d @ scene.camera.rot
    ok = local[..., 2] > 1e-6
    scale = scene.camera.plane_dist / torch.clamp(local[..., 2], min=1e-6)
    film_x = (local[..., 0] * scale + 1.0) * (w / 2.0)
    film_y = (ratio - local[..., 1] * scale) * (w / 2.0)
    if meta.filter == "box":
        px = torch.floor(film_x)
        py = torch.floor(film_y)
        ux = film_x - px - 0.5 + 0.5  # f0 + 0.5 with f0 = u - 0.5
        uy = film_y - py - 0.5 + 0.5
    elif meta.filter == "tent":
        px = torch.round(film_x - 0.5)
        py = torch.round(film_y - 0.5)
        ux = _tent_cdf(film_x - 0.5 - px)
        uy = _tent_cdf(film_y - 0.5 - py)
    else:  # dirac: the offset must be ~0
        px = torch.round(film_x - 0.5)
        py = torch.round(film_y - 0.5)
        ok = ok & (torch.abs(film_x - 0.5 - px) < 1e-3) & (torch.abs(film_y - 0.5 - py) < 1e-3)
        ux = torch.full_like(film_x, 0.5)
        uy = torch.full_like(film_y, 0.5)
    ok = ok & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    u_pix = torch.stack([(px + 0.5) / w, (py + 0.5) / h], dim=-1)
    u_cam = torch.stack([torch.clamp(ux, 0.0, 1.0), torch.clamp(uy, 0.0, 1.0)], dim=-1)
    return u_pix, u_cam, ok


def _invert_emitter_root(scene: FlatScene, vert, mu):
    """The inverse of sample_emitter_position at a camera-subpath vertex on
    an area light: (u_li, u_tri, u_pos (N, 2), ok)."""
    lights = scene.lights
    li = torch.clamp(vert["light"], min=0)
    tri = torch.clamp(vert["tri"], min=0)
    n = li.shape[0]
    # the triangle's slot in its light's triangle list (a bounded scan)
    off, count = lights.offset[li], lights.count[li]
    k = torch.zeros((n,), dtype=torch.int64, device=li.device)
    found = torch.zeros((n,), dtype=torch.bool, device=li.device)
    for j in range(int(lights.max_count)):
        idx = torch.clamp(off + j, 0, lights.tri_idx.shape[0] - 1)
        match = (lights.tri_idx[idx] == tri) & (j < count) & ~found
        k = torch.where(match, j, k)
        found = found | match
    cdf_off = lights.cdf_offset[li]
    top = lights.cdf.shape[0] - 1
    cdf_lo = lights.cdf[torch.clamp(cdf_off + k, 0, top)]
    cdf_hi = lights.cdf[torch.clamp(cdf_off + k + 1, 0, top)]
    u_tri = cdf_lo + mu * torch.clamp(cdf_hi - cdf_lo, min=0.0)
    # p's barycentrics in (v0, e1, e2)
    v0, e1, e2 = scene.tris.v0[tri], scene.tris.e1[tri], scene.tris.e2[tri]
    dp = vert["p"] - v0
    g11, g12, g22 = vo.dot(e1, e1), vo.dot(e1, e2), vo.dot(e2, e2)
    det = torch.clamp(g11 * g22 - g12 * g12, min=1e-20)
    a = (g22 * vo.dot(dp, e1) - g12 * vo.dot(dp, e2)) / det
    b = (g11 * vo.dot(dp, e2) - g12 * vo.dot(dp, e1)) / det
    # sample_emitter_position: q = v0 + e1 * ly + e2 * (1 - lx - ly) with
    # (lx, ly) = uniform_triangle_uv(u2): ly = a, lx = 1 - a - b
    lam = torch.stack([1.0 - a - b, a], dim=-1)
    ok = found & (a > -1e-4) & (b > -1e-4) & (a + b < 1.0 + 1e-4)
    u_pos = warps.invert_uniform_triangle_uv(torch.clamp(lam, 0.0, 1.0))
    u_li = (li.to(torch.float32) + mu) / float(scene.meta.n_lights)
    if scene.meta.has_analytic:
        # an analytic emitter's position does not invert: rejected, the
        # reference's invertPosition() == false path
        ok = ok & (lights.ana_prim[li] < 0)
    return u_li, u_tri, torch.clamp(u_pos, 0.0, 1.0), ok


def _scatter_uniforms(ctx, zi, zp, zn, mu3):
    """bsdf_invert at z_i for the path z_p -> z_i -> z_n: (u2, u1, ok)."""
    from ..models.bsdfs.invert import bsdf_invert

    t_ax, b_ax, nf = _local_frame(zi["nf"], zi["flip"])
    wi_l = vo.to_local(t_ax, b_ax, nf, vo.normalize(zp["p"] - zi["p"], eps=1e-12))
    wo_l = vo.to_local(t_ax, b_ax, nf, vo.normalize(zn["p"] - zi["p"], eps=1e-12))
    u2, u1, ok = bsdf_invert(ctx, zi["mat"], zi["uv"], wi_l, wo_l, mu=mu3)
    return u2, u1, ok & (zi["kind"] == V_SURFACE)


def _put(tbl, slot, need, u2=None, u1=None, comp=0):
    """tbl[:, slot] = u2 (both components) or tbl[:, slot, comp] = u1 where
    need."""
    if u2 is not None:
        tbl[:, slot, :] = torch.where(need[..., None], u2, tbl[:, slot, :])
    else:
        tbl[:, slot, comp] = torch.where(need, u1, tbl[:, slot, comp])


def invert_path_to_table(scene: FlatScene, out, table, s_old, s_new, v, k_max, skip_dims, mu3):
    """Rewrite `table` so that the chain realized under (s_old, t_old)
    replays as technique (s_new, t_new = v - s_new) (rjmlt.py:170-337).
    Returns (table', ok)."""
    meta = scene.meta
    ctx = (scene.materials, scene.textures)
    cv, lv = out["cv"], out["lv"]
    n = table.shape[0]
    t_old = v - s_old
    t_new = v - s_new
    # the chain must have been realized
    ok = (out["n_cv"] >= t_old) & (out["n_lv"] >= torch.clamp(s_old, min=1))
    if meta.has_media:  # medium vertices and distance dims do not invert
        ok = torch.zeros((n,), dtype=torch.bool, device=table.device)

    # the technique selector (slot 1): s_sel = min(u * ntech, v - 1)
    tbl = table.clone()
    tbl[:, 1, 0] = (s_new.to(torch.float32) + mu3[1]) / _ntech_lanes(v).to(torch.float32)

    # The slots (no-media replay; the Sampler's half-draw pairing): u_cam at
    # skip, u_lens at skip + 1; camera scatter group g: 3 skipped, u2 at
    # skip + 2 + 5g + 3, u1 at (skip + 2 + 5g + 4).u0, its .u1 the pending
    # half. The light root draws u_li from that PENDING half (the last
    # camera group's u1 slot, component 1), u_tri = L0.u0, u_pos = L0 + 1,
    # u_dir = L0 + 2, L0 = skip + 2 + 5 (k_max - 1); light scatter group g:
    # u2 at L0 + 3 + 5g + 3, u1 at (L0 + 3 + 5g + 4).u0.
    base_cam = skip_dims
    base_l = skip_dims + 2 + 5 * (k_max - 1)
    chain = [_chain_at(cv, lv, t_old, v, i) for i in range(k_max + 1)]

    # ---- the camera scatter groups ----
    for i in range(1, k_max):
        need = (i >= t_old - 1) & (i <= t_new - 2)
        u2, u1, iok = _scatter_uniforms(ctx, chain[i], chain[i - 1], chain[i + 1], mu3)
        ok = ok & torch.where(need, iok, True)
        g = base_cam + 2 + 5 * (i - 1)
        _put(tbl, g + 3, need, u2=u2)
        _put(tbl, g + 4, need, u1=u1)

    # ---- the camera pixel (t_old == 1 -> t_new >= 2) ----
    need_pix = (t_old == 1) & (t_new >= 2)
    d_cam = vo.normalize(chain[1]["p"] - scene.camera.pos.expand(n, 3), eps=1e-12)
    u_pix, u_cam, pok = _invert_camera_pixel(scene, meta, d_cam, mu3)
    ok = ok & torch.where(need_pix, pok, True)
    _put(tbl, 0, need_pix, u2=u_pix)
    _put(tbl, base_cam, need_pix, u2=u_cam)

    # ---- the light root (s_old == 0 -> s_new >= 1): the new root is the
    # chain's last vertex, on the camera side at slot v - 1 ----
    need_root = (s_old == 0) & (s_new >= 1)
    zl = _take_slot(cv, v - 1)
    u_li, u_tri, u_pos, rok = _invert_emitter_root(scene, zl, mu3[0])
    ok = ok & torch.where(need_root, rok & (zl["light"] >= 0), True)
    _put(tbl, base_l - 1, need_root, u1=u_li, comp=1)  # the pending half
    _put(tbl, base_l, need_root, u1=u_tri)
    _put(tbl, base_l + 1, need_root, u2=u_pos)

    # ---- the light's first direction (s_old <= 1 -> s_new >= 2) ----
    need_dir = (s_old <= 1) & (s_new >= 2)
    zv1 = _chain_dyn(cv, lv, t_old, v, v - 1)
    zv2 = _chain_dyn(cv, lv, t_old, v, v - 2)
    t_e, b_e = vo.tangent_frame(zv1["ng"])
    d_loc = vo.to_local(t_e, b_e, zv1["ng"], vo.normalize(zv2["p"] - zv1["p"], eps=1e-12))
    ok = ok & torch.where(need_dir, d_loc[..., 2] > 0.0, True)
    _put(tbl, base_l + 2, need_dir, u2=warps.invert_cosine_hemisphere(d_loc, mu3[0]))

    # ---- the light scatter groups ----
    for j in range(1, k_max):
        need = (j >= torch.clamp(s_old - 1, min=1)) & (j <= s_new - 2)
        need = need | ((s_old == 0) & (j <= s_new - 2))
        u2, u1, iok = _scatter_uniforms(ctx, _chain_dyn(cv, lv, t_old, v, v - 1 - j),
                                        _chain_dyn(cv, lv, t_old, v, v - j),
                                        _chain_dyn(cv, lv, t_old, v, v - 2 - j), mu3)
        ok = ok & torch.where(need, iok, True)
        g = base_l + 3 + 5 * (j - 1)
        _put(tbl, g + 3, need, u2=u2)
        _put(tbl, g + 4, need, u1=u1)
    return tbl, ok


def _rjmlt_strategy_step_impl(scene: FlatScene, state, lane_ids, seed, step_idx, bw, v_sel, k_max,
                              skip_dims=2):
    """One strategy perturbation of every chain: keep the geometric path,
    propose a uniform s', invert, evaluate, accept by the luminance ratio
    times the inversion's success (ReversibleJumpMltTracer.cpp:154+). The
    uniform proposal of s' is symmetric: no proposal ratio. Returns the
    new state with "accept_frac" and "invert_frac" (tensors)."""
    meta = scene.meta
    table = state["table"]
    n, dev = table.shape[0], table.device
    s0 = int(seed[0]) ^ _STRATEGY_SALT
    row0 = _row0(lane_ids)
    u_s, u_mu0 = _rand((n,), s0, seed[1], int(step_idx) * 4 + 0, dev, row0)
    u_mu1, u_mu2 = _rand((n,), s0, seed[1], int(step_idx) * 4 + 1, dev, row0)
    s_cur = _select_technique(table[:, 1, 0], v_sel)
    s_new = _select_technique(u_s, v_sel)

    # replay the current tables for their realized vertex chains
    px, py = _chain_pixels(meta, table)
    cur = _bdpt_sample(scene, seed, lane_ids, px, py, table=table, skip_dims=skip_dims,
                       sel=(s_cur, v_sel), collect=True, return_verts=True)
    mu3 = (u_mu0, u_mu1, u_mu2)
    proposal, inv_ok = invert_path_to_table(scene, cur, table, s_cur, s_new, v_sel, k_max,
                                            skip_dims, mu3)
    inv_ok = inv_ok & (s_new != s_cur) & (v_sel >= 3)

    px_p, py_p = _chain_pixels(meta, proposal)
    prop = _bdpt_sample(scene, seed, lane_ids, px_p, py_p, table=proposal, skip_dims=skip_dims,
                        sel=(s_new, v_sel), collect=True, return_verts=True)
    # the replay-consistency gate (the reference FAILs on an inconsistent
    # inversion, ReversibleJumpMltTracer.cpp:143-144; here the proposal is
    # rejected): the proposal must realize the same chain under (s', t')
    t_old, t_new = v_sel - s_cur, v_sel - s_new
    match = torch.ones((n,), dtype=torch.bool, device=dev)
    for i in range(k_max):
        zo = _chain_at(cur["cv"], cur["lv"], t_old, v_sel, i)
        zn = _chain_at(prop["cv"], prop["lv"], t_new, v_sel, i)
        dp = torch.abs(zo["p"] - zn["p"]).amax(dim=-1)
        match = match & torch.where(i < v_sel, dp < 1e-3, True)
    inv_ok = inv_ok & match

    t1 = torch.where(prop["t1_ok"][..., None], prop["t1_val"], 0.0) * (1.0 / (meta.res_x
                                                                            * meta.res_y))
    ev_p = _scale_ev(dict(eye=prop["eye"], pix=_pixel_f(px_p, py_p), t1_val=t1,
                          t1_pixf=prop["t1_pixf"],
                          lum=_luminance(prop["eye"]) + _luminance(t1).sum(dim=1)),
                     _ntech_lanes(v_sel))
    a = torch.where(inv_ok, torch.clamp(ev_p["lum"] / torch.clamp(state["lum"], min=1e-20),
                                        0.0, 1.0), 0.0)
    buf = _splat_pair(meta, state, ev_p, a, bw)
    u_acc, _ = _rand((n,), s0, seed[1], int(step_idx) * 4 + 3, dev, row0)
    accept = u_acc < a
    out = _ev_accept(state, ev_p, accept, table, proposal, buf)
    out.update(accept_frac=accept.float().mean(), invert_frac=inv_ok.float().mean())
    return out


def rjmlt_strategy_step(scene: FlatScene, state, lane_ids, seed, step_idx, bw, v_sel, k_max,
                        skip_dims=2):
    """(new state, (accept fraction, invertible fraction)) of one strategy
    step."""
    out = _rjmlt_strategy_step_impl(scene, dict(state), lane_ids, seed, step_idx, bw, v_sel,
                                    k_max, skip_dims)
    stats = (out.pop("accept_frac"), out.pop("invert_frac"))
    return out, stats


def render_rjmlt(scene: FlatScene, spp=None, seed=0xBA5EBA11, n_chains=1 << 13, p_large=0.1,
                 bootstrap_factor=16, verbose=False, mesh=None, resume_file=None,
                 scene_hash_value=""):
    """RJ-MLT render (rjmlt.py:441-511): MMLT's chain populations, every
    STRATEGY_EVERY-th mutation a reversible-jump strategy perturbation. The
    bootstrap, per-length budgets and normalization are MMLT's
    (MultiplexedMltIntegrator.cpp:92-94). The strategy steps' mean accept
    and invertible fractions land in render_rjmlt.last_stats. mesh: as
    multiplexed.render_mmlt's; the fractions are taken over every rank's
    chains."""
    from .multiplexed import _render_chains

    hist = []

    def run(state, lane_ids, seed_arr, bw, v_sel, k_max, it, steps):
        while it < steps:
            k = min(STRATEGY_EVERY - 1, steps - it)
            if k > 0:
                state = mlt_steps_bdpt(scene, state, lane_ids, seed_arr, it, k, p_large, bw,
                                       v_sel=v_sel, skip_dims=2)
                it += k
            if it < steps:
                state, stats = rjmlt_strategy_step(scene, state, lane_ids, seed_arr,
                                                   STRATEGY_STEP0 + it, bw, v_sel, k_max, 2)
                if mesh is not None:  # the block's fractions to every chain's
                    stats = tuple(pm.all_reduce_sum(mesh, f * lane_ids.shape[0]) / n_chains
                                  for f in stats)
                hist.append(stats)
                it += 1
            if verbose:
                print(f"  rjmlt step {it}/{steps}")
        return state, it

    img = _render_chains(scene, spp, seed, 0x71000, n_chains, bootstrap_factor, resume_file,
                         scene_hash_value, verbose, run, mesh)
    acc = float(sum(float(a) for a, _ in hist) / len(hist)) if hist else float("nan")
    inv = float(sum(float(i) for _, i in hist) / len(hist)) if hist else float("nan")
    render_rjmlt.last_stats = (acc, inv, len(hist))
    if verbose and hist:
        print(f"  strategy: accept {acc:.3f}, invertible {inv:.3f}")
    return img


render_rjmlt.last_stats = (float("nan"), float("nan"), 0)
