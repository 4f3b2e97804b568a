"""Kelemen-style primary-sample-space MLT (PSSMLT), torch.

Port of tungsten_tpu/integrators/kelemen.py (MetropolisSampler.hpp:14-160,
KelemenMltIntegrator.cpp's bootstrap :69-124, KelemenMltTracer's chain loop
:103-146 with expected-value splatting :116-138), in both of the reference's
variants: path-traced chains (`render_kelemen`, "bidirectional": false) and
bidirectional ones (`render_kelemen_bdpt`, the default).

Thousands of Markov chains run side by side, one mutation step for all of
them at a time. A chain's state is its primary-sample table (N, D, 2), read
by the table-driven Sampler; the Kelemen large-step and small-step
mutations edit every table at once. A bootstrap of fresh tables seeds the
chains in proportion to their luminance and sets the luminance scale b;
each step splats the current and the proposed state with the expected
weights (1 - a) and a. The render loop's own uniforms (`_rand`) hash the flat
index of their grid with PCG4D, bit for bit as the JAX package does, and the
seed selection runs on the host in numpy, over the float64 luminances, as
there.

The JAX package fuses up to 32 (PT) or 16 (BDPT) steps into one dispatch;
here `mlt_steps` and `mlt_steps_bdpt` are Python loops over the steps, and
every step is one full evaluation of the proposals (a lockstep PT pass or a
BDPT sample), with its walks on K3 and K3-fast.
"""
from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from ..parallel import mesh as pm
from ..sampling.sampler import MASK32, _to_unit_float, pcg4d
from ..scene.flatten import FlatScene
from .light_tracer import splat_filtered
from .path_tracer import DIMS_PER_BOUNCE, trace_pass

S1 = 1.0 / 1024.0  # Kelemen mutation sizes (MetropolisSampler.hpp)
S2 = 1.0 / 64.0
_DECORRELATE = 0xDEADBEEF  # the render loop's draws: seed word 0 xor this
PT_CHUNK = 32  # the JAX package's steps a dispatch (kelemen.py:327, 235)
BDPT_CHUNK = 16


def _table_dims(meta):
    """PT chains: the pixel slot, the camera's 4 dims and 12 bounces at
    most; later bounces hash (kelemen.py:33)."""
    return 5 + DIMS_PER_BOUNCE * min(meta.max_bounces, 12)


def _table_dims_bdpt(meta, k_max, extra=1):
    """Primary-sample slots one `_bdpt_sample` consumes: the render loop's slots,
    the camera root (2), the light root (4) and 5 per subpath step, both
    subpaths."""
    return extra + 2 + 4 + 2 * 5 * (k_max - 1)


def _luminance(rgb):
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def _rand(shape, seed0, seed1, salt, device, row0=0):
    """Two uniform grids of `shape` for the render loop's own decisions: PCG4D
    of (flat index, salt, seed0, seed1), all uint32 (kelemen.py:41-49).
    row0: the global row of the grid's first row, where it is one rank's
    block of a sharded grid (its flat indices start at row0 * row size)."""
    n = int(np.prod(shape))
    row = int(np.prod(shape[1:]))
    i = torch.arange(row0 * row, row0 * row + n, dtype=torch.int64, device=device)

    def word(v):
        return torch.full((n,), int(v) & MASK32, dtype=torch.int64, device=device)

    r0, r1, _, _ = pcg4d(i, word(salt), word(seed0), word(seed1))
    return _to_unit_float(r0).reshape(shape), _to_unit_float(r1).reshape(shape)


def _mutate_small(table, u_dir, u_mag):
    """The Kelemen small step: du = s2 * exp(-log(s2 / s1) * xi), its sign
    from a second uniform, wrapped to [0, 1) (MetropolisSampler::mutate
    :43)."""
    k = -math.log(S2 / S1)
    mag = S2 * torch.exp(k * u_mag)
    out = table + torch.where(u_dir < 0.5, mag, -mag)
    return out - torch.floor(out)


def _chain_pixels(meta, table):
    """The chain pixel of each lane from table slot 0: (px, py)."""
    w, h = meta.res_x, meta.res_y
    px = torch.clamp((table[:, 0, 0] * w).to(torch.int64), max=w - 1)
    py = torch.clamp((table[:, 0, 1] * h).to(torch.int64), max=h - 1)
    return px, py


def _pixel_f(px, py):
    return torch.stack([px + 0.5, py + 0.5], dim=-1).to(torch.float32)


def _eval(scene: FlatScene, table, lane_ids, seed):
    """Trace the paths the tables encode: (radiance (N, 3), the chain
    pixel's centre (N, 2))."""
    px, py = _chain_pixels(scene.meta, table)
    rad = trace_pass(scene, seed, lane_ids, px, py, table)
    if isinstance(rad, tuple):
        rad = rad[0]
    return rad, _pixel_f(px, py)


def _eval_bdpt(scene: FlatScene, table, lane_ids, seed, sel=None, skip_dims=1):
    """A bidirectional chain evaluation (KelemenMltTracer.cpp:26-85: every
    BDPT connection of one primary-sample vector): the chain's splat set,
    the eye value at its pixel and every t = 1 splat (weighed in eye units,
    1 / n_pix), and its total luminance."""
    from .bdpt import _bdpt_sample

    meta = scene.meta
    px, py = _chain_pixels(meta, table)
    out = _bdpt_sample(scene, seed, lane_ids, px, py, table=table, skip_dims=skip_dims,
                       sel=sel, collect=True)
    t1 = torch.where(out["t1_ok"][..., None], out["t1_val"], 0.0) * (1.0 / (meta.res_x
                                                                          * meta.res_y))
    return dict(eye=out["eye"], pix=_pixel_f(px, py), t1_val=t1, t1_pixf=out["t1_pixf"],
                lum=_luminance(out["eye"]) + _luminance(t1).sum(dim=1))


def _splat_chain(buf, ev, weight, res_x, res_y, filter_name="tent"):
    """Splat one chain state's whole splat set (the eye value and the S t = 1
    splats) with the per-chain weight, in place; the taps of the chains of
    weight > 0 only, in one deposit."""
    n, S = ev["t1_val"].shape[:2]
    pix = torch.cat([ev["pix"][:, None], ev["t1_pixf"]], dim=1).reshape(n * (1 + S), 2)
    val = torch.cat([ev["eye"][:, None], ev["t1_val"]], dim=1) * weight[:, None, None]
    valid = (weight > 0)[:, None].expand(n, 1 + S).reshape(-1)
    return splat_filtered(buf, pix, val.reshape(n * (1 + S), 3), valid, res_x, res_y,
                          filter_name=filter_name)


def _row0(lane_ids):
    """The global index of a block's first chain (0 for an empty block)."""
    return int(lane_ids[0]) if lane_ids.shape[0] else 0


def _proposals(table, seed, step_idx, p_large, row0=0):
    """The step's proposals and its uniforms: a large step (fresh
    uniforms) with probability p_large, else the small step; returns
    (proposal, s0) with s0 the render loop's seed word. row0: the global
    index of the first chain (a sharded block's)."""
    n, dims, _ = table.shape
    dev = table.device
    s0 = int(seed[0]) ^ _DECORRELATE
    salt = int(step_idx) * 4
    u_large, _ = _rand((n,), s0, seed[1], salt + 0, dev, row0)
    ud0, ud1 = _rand((n, dims), s0, seed[1], salt + 1, dev, row0)
    um0, um1 = _rand((n, dims), s0, seed[1], salt + 2, dev, row0)
    fresh = torch.stack([ud0, um0], dim=-1)  # reused as the fresh uniforms
    small = _mutate_small(table, fresh, torch.stack([ud1, um1], dim=-1))
    large = u_large < p_large
    return torch.where(large[:, None, None], fresh, small), s0


def _accept(n, s0, seed, step_idx, a, dev, row0=0):
    u_acc, _ = _rand((n,), s0, seed[1], int(step_idx) * 4 + 3, dev, row0)
    return u_acc < a


def _mlt_step_impl(scene: FlatScene, state, lane_ids, seed, step_idx, p_large, b):
    """One Metropolis mutation of every chain with its expected-value splats
    (kelemen.py:63-110); returns the new state, its splat buffer updated in
    place."""
    meta = scene.meta
    table = state["table"]
    row0 = _row0(lane_ids)
    proposal, s0 = _proposals(table, seed, step_idx, p_large, row0)
    rad_p, pix_p = _eval(scene, proposal, lane_ids, seed)
    lum_p = _luminance(rad_p)
    lum = state["lum"]
    a = torch.clamp(lum_p / torch.clamp(lum, min=1e-20), 0.0, 1.0)
    # the expected-value splats (KelemenMltTracer.cpp:116-138)
    w_cur = (1.0 - a) * b / torch.clamp(lum, min=1e-20)
    w_prop = a * b / torch.clamp(lum_p, min=1e-20)
    buf = state["splat"]
    splat_filtered(buf, state["pix"], state["rad"] * w_cur[:, None], lum > 0, meta.res_x,
                   meta.res_y, filter_name=meta.filter)
    splat_filtered(buf, pix_p, rad_p * w_prop[:, None], lum_p > 0, meta.res_x, meta.res_y,
                   filter_name=meta.filter)
    accept = _accept(table.shape[0], s0, seed, step_idx, a, table.device, row0)
    return dict(table=torch.where(accept[:, None, None], proposal, table),
                rad=torch.where(accept[:, None], rad_p, state["rad"]),
                lum=torch.where(accept, lum_p, lum),
                pix=torch.where(accept[:, None], pix_p, state["pix"]), splat=buf)


def mlt_steps(scene: FlatScene, state, lane_ids, seed, step0, k, p_large, b):
    """k mutation steps, step indices step0 .. step0 + k - 1."""
    for i in range(k):
        state = _mlt_step_impl(scene, state, lane_ids, seed, step0 + i, p_large, b)
    return state


def _ntech_lanes(v_sel):
    """Techniques a path of v vertices has, per lane: 1 for v <= 2, else v."""
    return torch.where(v_sel <= 2, 1, v_sel)


def _select_technique(u, v_sel):
    """s = min(u * ntech, v - 1), 0 where v <= 2."""
    s = torch.minimum((u * _ntech_lanes(v_sel).to(torch.float32)).to(torch.int64), v_sel - 1)
    return torch.where(v_sel <= 2, 0, s)


def _scale_ev(ev, ntech):
    """A splat set scaled by the per-length technique count."""
    nt = ntech.to(torch.float32)
    return dict(ev, eye=ev["eye"] * nt[:, None], t1_val=ev["t1_val"] * nt[:, None, None],
                lum=ev["lum"] * nt)


_EV = ("eye", "pix", "t1_val", "t1_pixf")


def _ev_accept(state, ev_p, accept, table, proposal, buf):
    """The chain state after the accept decisions."""
    out = {k: torch.where(accept.reshape((-1,) + (1,) * (ev_p[k].dim() - 1)), ev_p[k], state[k])
           for k in _EV}
    out.update(table=torch.where(accept[:, None, None], proposal, table),
               lum=torch.where(accept, ev_p["lum"], state["lum"]), splat=buf)
    return out


def _splat_pair(meta, state, ev_p, a, bw):
    """The expected-value splats of the current state (1 - a) and the
    proposal (a), normalized by bw."""
    lum = state["lum"]
    w_cur = (1.0 - a) * bw / torch.clamp(lum, min=1e-20)
    w_prop = a * bw / torch.clamp(ev_p["lum"], min=1e-20)
    buf = state["splat"]
    _splat_chain(buf, {k: state[k] for k in _EV}, torch.where(lum > 0, w_cur, 0.0), meta.res_x,
                 meta.res_y, filter_name=meta.filter)
    _splat_chain(buf, ev_p, torch.where(ev_p["lum"] > 0, w_prop, 0.0), meta.res_x, meta.res_y,
                 filter_name=meta.filter)
    return buf


def _mlt_step_bdpt_impl(scene: FlatScene, state, lane_ids, seed, step_idx, p_large, bw,
                        v_sel=None, skip_dims=1):
    """One Metropolis mutation of bidirectional chains with the
    expected-value splats of the whole splat set (kelemen.py:131-205).
    bw: the normalization c = b * n_chains / n_pop (a number for Kelemen,
    per lane for multiplexed MLT). v_sel: per-lane total vertex count
    (MMLT): the technique s is read from table slot 1 and the contribution
    scaled by the length's technique count (MultiplexedMltTracer.cpp:52-54)."""
    table = state["table"]
    row0 = _row0(lane_ids)
    proposal, s0 = _proposals(table, seed, step_idx, p_large, row0)
    sel = None
    if v_sel is not None:
        sel = (_select_technique(proposal[:, 1, 0], v_sel), v_sel)
    ev_p = _eval_bdpt(scene, proposal, lane_ids, seed, sel=sel, skip_dims=skip_dims)
    if v_sel is not None:
        ev_p = _scale_ev(ev_p, _ntech_lanes(v_sel))
    a = torch.clamp(ev_p["lum"] / torch.clamp(state["lum"], min=1e-20), 0.0, 1.0)
    buf = _splat_pair(scene.meta, state, ev_p, a, bw)
    accept = _accept(table.shape[0], s0, seed, step_idx, a, table.device, row0)
    return _ev_accept(state, ev_p, accept, table, proposal, buf)


def mlt_steps_bdpt(scene: FlatScene, state, lane_ids, seed, step0, k, p_large, bw, v_sel=None,
                   skip_dims=1):
    """k bidirectional mutation steps, step indices step0 .. step0 + k - 1."""
    for i in range(k):
        state = _mlt_step_bdpt_impl(scene, state, lane_ids, seed, step0 + i, p_large, bw,
                                    v_sel, skip_dims)
    return state


def _fresh_table(n, dims, seed, salt, dev):
    u0, u1 = _rand((n, dims), int(seed[0]) ^ _DECORRELATE, seed[1], salt, dev)
    return torch.stack([u0, u1], dim=-1)


def _select_seeds(lums, n_chains, seed):
    """Luminance-proportional seed selection on the host (KelemenMltIntegrator
    :102-124): indices into the flat bootstrap pool, drawn by numpy's
    default_rng(seed).choice over the float64 luminances."""
    p = np.asarray(lums, np.float64)
    p = p / p.sum()
    return np.random.default_rng(seed).choice(len(p), size=n_chains, p=p)


def _gather_boot(fields, sel, n_chains):
    """Field f of bootstrap round sel // n at lane sel % n, for every f."""
    dev = fields[0][next(iter(fields[0]))].device
    which = torch.as_tensor(sel // n_chains, device=dev)
    idx = torch.as_tensor(sel % n_chains, device=dev)
    return {k: torch.stack([f[k] for f in fields])[which, idx] for k in fields[0]}


def _result(state, steps, w, h, n_chains=None):
    """The image, as the JAX package divides it: splat / steps * (W * H),
    divided by n_chains after where given (multiplexed.py:190)."""
    img = state["splat"].cpu().numpy().reshape(h, w, 3) / steps
    return img * (w * h) if n_chains is None else img * (w * h) / n_chains


def _run_steps(label, step_fn, state, it, steps, chunk, verbose):
    while it < steps:
        k = min(chunk, steps - it)
        state = step_fn(state, it, k)
        it += k
        if verbose:
            print(f"  {label} step {it}/{steps}")
    return state, it


def _resume(resume_file, scene_hash_value, state, verbose, dev):
    """(state, extras, it) from resume_file where it matches, else (state,
    {}, 0)."""
    if resume_file:
        loaded = load_mlt_state(resume_file, scene_hash_value, dev)
        if loaded is not None:
            if verbose:
                print(f"  resumed at mlt step {loaded[2]}")
            return loaded
    return state, {}, 0


def _finish(mesh, state, n_chains, it, resume_file, scene_hash_value, extras=None):
    """The state after the last step, its splat buffer whole: under a mesh
    the buffer is summed over the ranks (and, to be saved, the chain blocks
    gathered); the state is saved to resume_file (by rank 0 alone)."""
    if resume_file:
        state = pm.gather_chain_state(mesh, state, n_chains)
        if pm.rank(mesh) == 0:
            save_mlt_state(resume_file, scene_hash_value, state, it, extras=extras)
        pm.barrier(mesh)
        return state
    return dict(state, splat=pm.all_reduce_sum(mesh, state["splat"]))


def _bootstrap_kelemen_bdpt(scene: FlatScene, seed, seed_arr, n_chains, dims, bootstrap_factor):
    """The bidirectional bootstrap: (state without its splat, b, the pool's
    luminances) or None for a black scene."""
    dev = scene.shade_pack.device
    lane_ids = torch.arange(n_chains, device=dev)
    boot = []
    for i in range(bootstrap_factor):
        tbl = _fresh_table(n_chains, dims, seed_arr, 0x7E000 + i, dev)
        ev = _eval_bdpt(scene, tbl, lane_ids, seed_arr)
        boot.append(dict(ev, table=tbl))
    lums = torch.cat([ev["lum"] for ev in boot])
    b = float(lums.mean())
    if b <= 0:
        return None
    lums_np = lums.cpu().numpy()
    state = _gather_boot(boot, _select_seeds(lums_np, n_chains, seed), n_chains)
    return state, b, lums_np


def render_kelemen_bdpt(scene: FlatScene, spp=None, seed=0xBA5EBA11, n_chains=1 << 13,
                        p_large=0.1, bootstrap_factor=16, verbose=False, mesh=None,
                        resume_file=None, scene_hash_value=""):
    """Bidirectional PSSMLT (the reference's default "bidirectional": true):
    each primary-sample vector drives one camera and one light subpath and
    their whole (s, t) connection set, accepted on the splat set's total
    luminance (kelemen.py:215-292). Total mutations = spp * W * H. mesh:
    every rank runs the whole bootstrap (so every rank selects the same
    chains), then mutates its block of the chains; the splat buffer is
    summed once, at the end."""
    scene = pm.replicate(mesh, scene)
    meta = scene.meta
    spp = spp if spp is not None else meta.spp
    w, h = meta.res_x, meta.res_y
    dev = scene.shade_pack.device
    k_max = min(meta.max_bounces + 1, meta.bdpt_max_vertices)
    dims = _table_dims_bdpt(meta, k_max)
    lane_ids = torch.arange(n_chains, device=dev)
    seed_arr = (seed & MASK32, 0x60000)
    boot = _bootstrap_kelemen_bdpt(scene, seed, seed_arr, n_chains, dims, bootstrap_factor)
    if boot is None:
        return np.zeros((h, w, 3), np.float32)
    state, b, _ = boot
    state = dict(state, splat=torch.zeros((w * h, 3), device=dev))
    steps = max(1, spp * w * h // n_chains)
    state, _, it = _resume(resume_file, scene_hash_value, state, verbose, dev)
    state = pm.shard_chain_state(mesh, state, n_chains)
    lane_ids = pm.shard_lanes(mesh, lane_ids)
    state, it = _run_steps(
        "mlt-bdpt", lambda st, i, k: mlt_steps_bdpt(scene, st, lane_ids, seed_arr, i, k,
                                                    p_large, b),
        state, it, steps, BDPT_CHUNK, verbose)
    state = _finish(mesh, state, n_chains, it, resume_file, scene_hash_value)
    return _result(state, steps * n_chains, w, h)


def _bootstrap_kelemen(scene: FlatScene, seed, seed_arr, n_chains, dims, bootstrap_factor):
    """The path-traced bootstrap: (state without its splat, b, the pool's
    luminances) or None for a black scene."""
    dev = scene.shade_pack.device
    lane_ids = torch.arange(n_chains, device=dev)
    boot = []
    for i in range(bootstrap_factor):
        tbl = _fresh_table(n_chains, dims, seed_arr, 0x7F000 + i, dev)
        rad, pix = _eval(scene, tbl, lane_ids, seed_arr)
        boot.append(dict(table=tbl, rad=rad, pix=pix, lum=_luminance(rad)))
    lums = torch.cat([ev["lum"] for ev in boot])
    b = float(lums.mean())
    if b <= 0:
        return None
    lums_np = lums.cpu().numpy()
    state = _gather_boot(boot, _select_seeds(lums_np, n_chains, seed), n_chains)
    return state, b, lums_np


def render_kelemen(scene: FlatScene, spp=None, seed=0xBA5EBA11, n_chains=1 << 14, p_large=0.1,
                   bootstrap_factor=16, verbose=False, mesh=None, resume_file=None,
                   scene_hash_value=""):
    """PSSMLT over path-traced chains (kelemen.py:295-379). Total mutations
    = spp * W * H. mesh: as render_kelemen_bdpt's."""
    scene = pm.replicate(mesh, scene)
    meta = scene.meta
    spp = spp if spp is not None else meta.spp
    w, h = meta.res_x, meta.res_y
    dev = scene.shade_pack.device
    lane_ids = torch.arange(n_chains, device=dev)
    seed_arr = (seed & MASK32, 0x50000)
    boot = _bootstrap_kelemen(scene, seed, seed_arr, n_chains, _table_dims(meta),
                              bootstrap_factor)
    if boot is None:
        return np.zeros((h, w, 3), np.float32)
    state, b, _ = boot
    state = dict(state, splat=torch.zeros((w * h, 3), device=dev))
    steps = max(1, spp * w * h // n_chains)
    state, _, it = _resume(resume_file, scene_hash_value, state, verbose, dev)
    state = pm.shard_chain_state(mesh, state, n_chains)
    lane_ids = pm.shard_lanes(mesh, lane_ids)
    state, it = _run_steps(
        "mlt", lambda st, i, k: mlt_steps(scene, st, lane_ids, seed_arr, i, k, p_large, b),
        state, it, steps, PT_CHUNK, verbose)
    state = _finish(mesh, state, n_chains, it, resume_file, scene_hash_value)
    return _result(state, steps * n_chains, w, h)


# ---- the chain state's checkpoint and resume (kelemen.py:382-424) ----------
# The whole chain population (primary-sample tables, cached splat sets,
# luminances, the splat buffer and MMLT's per-length arrays) round-trips
# through one npz in the JAX package's layout: a header (scene hash, step),
# s_<state field> and x_<extra>. Integer arrays are written as int32.

def _np(v):
    a = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return a.astype(np.int32) if a.dtype == np.int64 else a


def save_mlt_state(path, scene_hash, state, it, extras=None):
    header = json.dumps({"scene_hash": scene_hash, "it": int(it)})
    arrs = {f"s_{k}": _np(v) for k, v in state.items()}
    arrs.update({f"x_{k}": _np(v) for k, v in (extras or {}).items()})
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __header__=np.frombuffer(header.encode(), np.uint8), **arrs)
    os.replace(tmp, path)


def load_mlt_state(path, scene_hash, device="cpu"):
    """(state, extras, it) on `device`, or None where the file is absent or
    holds another scene. Integer arrays load as int64."""
    if not os.path.exists(path):
        return None
    def t(a):
        return torch.as_tensor(a.astype(np.int64) if a.dtype.kind in "iu" else a, device=device)

    with np.load(path) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        if header["scene_hash"] != scene_hash:
            return None
        state = {k[2:]: t(z[k]) for k in z.files if k.startswith("s_")}
        extras = {k[2:]: t(z[k]) for k in z.files if k.startswith("x_")}
    return state, extras, int(header["it"])
