"""Multiplexed Metropolis Light Transport (MMLT, Hachisuka et al. 2014), torch.

Port of tungsten_tpu/integrators/multiplexed.py (MultiplexedMltTracer.hpp:
25-40: one Markov chain population per path length, the technique index s
sampled inside the chain from a primary-sample slot;
MultiplexedMltIntegrator.cpp:92-94: per-length luminance budgeting).

Every chain population is a slice of one wavefront: a lane carries its
total vertex count V and reads its technique from table slot 1. The chains
are evaluated by BDPT (`_bdpt_sample`) with per-lane technique masks, so
only the chosen (s, t = V - s) connection's visibility walk has live lanes.
A bootstrap estimates each length's luminance b_V and sets the lane budgets
and the chains' seeds, the reference's two phases.

Techniques per length: V = 2 has the s = 0 emission technique only (the
(1, 1) splat is not in the estimator's set, bdpt.py); V >= 3 has s in
0..V-1.
"""
from __future__ import annotations

import numpy as np
import torch

from ..sampling.sampler import MASK32
from ..scene.flatten import FlatScene
from ..parallel import mesh as pm
from .kelemen import (BDPT_CHUNK, _eval_bdpt, _finish, _fresh_table, _gather_boot, _ntech_lanes,
                      _result, _resume, _run_steps, _scale_ev, _select_technique,
                      _table_dims_bdpt, mlt_steps_bdpt)


def _ntech(v):
    """Techniques a path of v vertices has (multiplexed.py:33)."""
    return 1 if v <= 2 else v


def _bootstrap_mmlt(scene: FlatScene, seed, seed_arr, n_chains, k_max, bootstrap_factor):
    """The MMLT and RJ-MLT bootstrap (multiplexed.py:38-131): per-length
    luminances on lanes assigned the lengths in turn, the chains split
    across the lengths in proportion to b_V (one at least each), and each
    length's chains seeded in proportion to luminance among its own
    bootstrap samples. Returns (state without its splat, bw (N,), v_sel
    (N,)) or None for a black scene."""
    dev = scene.shade_pack.device
    lengths = list(range(2, k_max + 1))
    dims = _table_dims_bdpt(scene.meta, k_max, extra=2)  # slot 0 pixel, slot 1 technique
    lane_ids = torch.arange(n_chains, device=dev)
    v_cycle = np.array(lengths, np.int64)[np.arange(n_chains) % len(lengths)]
    v_boot = torch.as_tensor(v_cycle, device=dev)
    nt_boot = _ntech_lanes(v_boot).to(torch.float32)
    boot, lums = [], []
    for i in range(bootstrap_factor):
        tbl = _fresh_table(n_chains, dims, seed_arr, 0x7D000 + i, dev)
        ev = _eval_bdpt(scene, tbl, lane_ids, seed_arr,
                        sel=(_select_technique(tbl[:, 1, 0], v_boot), v_boot), skip_dims=2)
        boot.append(dict(ev, table=tbl))
        lums.append((ev["lum"] * nt_boot).cpu().numpy())
    lums_np = np.concatenate(lums)
    budget = _budget(lums_np, np.tile(v_cycle, bootstrap_factor), lengths, n_chains, seed)
    if budget is None:
        return None
    _, _, v_lane, bw, pick = budget
    state = _gather_boot(boot, pick, n_chains)
    v_sel = torch.as_tensor(v_lane, device=dev)
    state = _scale_ev(state, _ntech_lanes(v_sel))
    return state, torch.as_tensor(bw, device=dev), v_sel


def _budget(lums_np, v_np, lengths, n_chains, seed):
    """The bootstrap's host side (multiplexed.py:80-120): from the pool's
    luminances and lengths, (b_V, n_V, the lanes' lengths, bw, the pool
    index of each lane's seed), or None for a black scene."""
    b_v = {v: float(lums_np[v_np == v].mean()) for v in lengths}
    b_total = sum(b_v.values())
    if b_total <= 0:
        return None

    # the chains a length gets, in proportion to b_V, one at least
    n_v = {}
    remaining = n_chains
    for v in lengths[:-1]:
        n_v[v] = max(1, int(round(n_chains * b_v[v] / b_total)))
        remaining -= n_v[v]
    n_v[lengths[-1]] = max(1, remaining)
    v_lane = np.concatenate([np.full(n_v[v], v, np.int64) for v in lengths])[:n_chains]
    if len(v_lane) < n_chains:
        v_lane = np.pad(v_lane, (0, n_chains - len(v_lane)), constant_values=lengths[-1])
    # the per-lane normalization c = b_V * n_chains / n_V
    bw = np.array([b_v[int(v)] * n_chains / max(n_v[int(v)], 1) for v in v_lane], np.float32)

    # the seeds: in proportion to luminance within each length
    rng = np.random.default_rng(seed)
    pick = np.zeros(n_chains, np.int64)
    for v in lengths:
        pool = np.where(v_np == v)[0]  # indices into the flat bootstrap pool
        pl_ = lums_np[pool]
        lanes_v = np.where(v_lane == v)[0]
        if pl_.sum() <= 0:
            pick[lanes_v] = rng.choice(pool, size=len(lanes_v))
        else:
            pick[lanes_v] = rng.choice(pool, size=len(lanes_v), p=pl_ / pl_.sum())
    return b_v, n_v, v_lane, bw, pick


def _render_chains(scene: FlatScene, spp, seed, seed1, n_chains, bootstrap_factor,
                   resume_file, scene_hash_value, verbose, run, mesh=None):
    """The MMLT and RJ-MLT render loop (multiplexed.py:147-190, rjmlt.py:441-511):
    the bootstrap, the resume, `run(state, lane_ids, seed_arr, bw, v_sel,
    k_max, it, steps) -> (state, it)`, the save; returns the image. mesh:
    the whole bootstrap on every rank, then the chains, bw and v_sel in
    blocks (kelemen.render_kelemen_bdpt)."""
    scene = pm.replicate(mesh, scene)
    meta = scene.meta
    spp = spp if spp is not None else meta.spp
    w, h = meta.res_x, meta.res_y
    dev = scene.shade_pack.device
    k_max = min(meta.max_bounces + 1, meta.bdpt_max_vertices)
    seed_arr = (seed & MASK32, seed1)
    lane_ids = torch.arange(n_chains, device=dev)
    boot = _bootstrap_mmlt(scene, seed, seed_arr, n_chains, k_max, bootstrap_factor)
    if boot is None:
        return np.zeros((h, w, 3), np.float32)
    state, bw, v_sel = boot
    state = dict(state, splat=torch.zeros((w * h, 3), device=dev))
    steps = max(1, spp * w * h // n_chains)
    state, extras, it = _resume(resume_file, scene_hash_value, state, verbose, dev)
    bw = extras.get("bw", bw)
    v_sel = extras.get("v_sel", v_sel)
    state = pm.shard_chain_state(mesh, state, n_chains)
    lane_ids, bw_l, v_sel_l = pm.shard_lanes(mesh, lane_ids, bw, v_sel)
    state, it = run(state, lane_ids, seed_arr, bw_l, v_sel_l, k_max, it, steps)
    state = _finish(mesh, state, n_chains, it, resume_file, scene_hash_value,
                    extras=dict(bw=bw, v_sel=v_sel))
    return _result(state, steps, w, h, n_chains)


def render_mmlt(scene: FlatScene, spp=None, seed=0xBA5EBA11, n_chains=1 << 13, p_large=0.1,
                bootstrap_factor=16, verbose=False, mesh=None, resume_file=None,
                scene_hash_value=""):
    """MMLT render (multiplexed.py:134-190). Total mutations = spp * W * H,
    split across the path lengths in proportion to their bootstrap
    luminance (MultiplexedMltIntegrator.cpp:92-94). mesh: as
    kelemen.render_kelemen_bdpt's, with bw and v_sel in blocks too."""

    def run(state, lane_ids, seed_arr, bw, v_sel, k_max, it, steps):
        return _run_steps("mmlt", lambda st, i, k: mlt_steps_bdpt(
            scene, st, lane_ids, seed_arr, i, k, p_large, bw, v_sel=v_sel, skip_dims=2),
            state, it, steps, BDPT_CHUNK, verbose)

    return _render_chains(scene, spp, seed, 0x70000, n_chains, bootstrap_factor, resume_file,
                          scene_hash_value, verbose, run, mesh)
