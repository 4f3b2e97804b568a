"""Multiplexed MLT, the port against the JAX package, on the CPU: small-box at
64x48, max_bounces 4 (path lengths 2..5), kelemen's NC chains and BOOT
bootstrap rounds, 1 spp (one mutation step), on the numpy BVH build.

  * `_bootstrap_mmlt`'s host side on the JAX package's own bootstrap
    luminances: b_V, n_V, the lanes' lengths v_sel, bw and the seeds'
    picks exactly the JAX package's (the picked tables bit for bit); on the
    port's luminances the b_V total within 2e-3;
  * one `mlt_steps_bdpt` step with the technique selector (v_sel, skip_dims
    2) from the state the JAX render's step started from, per lane, with
    kelemen's bars;
  * the render: b within 2e-3, the luminance mean within 1e-2 and the
    channel means within 5e-2 of the JAX render's, and within 0.15 of the
    port's path-traced image.
"""
import numpy as np
import pytest
import torch

import jax

from test_torch_kelemen import (BOOT, NC, P_LARGE, check_one_step, check_render, port_pt,
                                recorder)
from test_torch_lockstep_area import check_image, one_torch_thread  # noqa: F401
from test_torch_mlt_sampler import SEED, mlt_scenes, t


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    from tungsten_tpu.integrators import multiplexed as jm
    from tungsten_tpu_torch.integrators import multiplexed as tm

    tmp = tmp_path_factory.mktemp("mmlt")
    ts, js, _ = mlt_scenes(str(tmp), "small-box", "multiplexed_mlt")
    with (recorder(jm, "_eval_bdpt", jit=True) as evs, recorder(jm, "_bootstrap_mmlt") as jboot,
          recorder(jm, "mlt_steps_bdpt") as steps):
        ref = jm.render_mmlt(js, spp=1, seed=SEED, n_chains=NC, bootstrap_factor=BOOT,
                             p_large=P_LARGE)
    with recorder(tm, "_budget") as budget:
        img = tm.render_mmlt(ts, spp=1, seed=SEED, n_chains=NC, bootstrap_factor=BOOT,
                             p_large=P_LARGE)
    return dict(ts=ts, js=js, ref=ref, img=img, pt_img=port_pt(ts), jax_evs=evs[:BOOT],
                jax_boot=jboot[0][2], port_budget=budget[0], jax_step=steps[0])


def _jax_pool(case):
    """The JAX bootstrap's pool: (luminances scaled by the technique count,
    the lengths, the tables (F, N, D, 2))."""
    lums, vs, tables = [], [], []
    for a, k, ev in case["jax_evs"]:
        v = np.asarray(k["sel"][1])
        lums.append(np.asarray(ev["lum"]) * np.where(v <= 2, 1, v).astype(np.float32))
        vs.append(v)
        tables.append(np.asarray(a[1]))
    return np.concatenate(lums), np.concatenate(vs), np.stack(tables)


def _b_totals(case):
    """(the port's b, the JAX package's b): the b_V totals of each
    package's bootstrap luminances."""
    from tungsten_tpu_torch.integrators.multiplexed import _budget

    lums, vs, _ = _jax_pool(case)
    lengths = list(range(2, int(vs.max()) + 1))
    return (sum(case["port_budget"][2][0].values()),
            sum(_budget(lums, vs, lengths, NC, SEED)[0].values()))


def test_bootstrap_host_side_matches_jax_exactly(case):
    from tungsten_tpu_torch.integrators.multiplexed import _budget

    k_max = min(case["ts"].meta.max_bounces + 1, case["ts"].meta.bdpt_max_vertices)
    lengths = list(range(2, k_max + 1))
    lums, vs, tables = _jax_pool(case)
    _, n_v, v_lane, bw, pick = _budget(lums, vs, lengths, NC, SEED)
    jstate, jbw, jv = case["jax_boot"]
    jbw, jv = np.asarray(jbw), np.asarray(jv)
    assert np.array_equal(v_lane, jv) and np.array_equal(bw, jbw)
    assert sorted(n_v) == lengths and all(n_v[v] == (jv == v).sum() for v in lengths)
    assert np.array_equal(tables[pick // NC, pick % NC], np.asarray(jstate["table"]))
    b_port, b_jax = _b_totals(case)
    assert abs(b_port - b_jax) <= 2e-3 * b_jax, (b_port, b_jax)


def test_one_selector_step_matches_jax_per_lane(case):
    """The port's step from the state the JAX render's step started from."""
    from tungsten_tpu_torch.integrators import kelemen as tk

    ts = case["ts"]
    args, kw, jnew = case["jax_step"]
    assert int(args[4]) == 0 and args[5] == 1 and kw["skip_dims"] == 2
    jstate = jax.tree.map(np.asarray, args[1])
    jnew = jax.tree.map(np.asarray, jnew)
    before = {k: t(v) for k, v in jstate.items()}
    tstate = {k: v.clone() for k, v in before.items()}
    bw, v_sel = t(args[7]), t(kw["v_sel"])
    with recorder(tk, "_eval_bdpt") as ev:
        tnew = tk.mlt_steps_bdpt(ts, tstate, torch.arange(NC), (SEED, 0x70000), 0, 1, P_LARGE,
                                 bw, v_sel=v_sel, skip_dims=2)
    lum_p = ev[0][2]["lum"] * tk._ntech_lanes(v_sel).float()
    a = torch.clamp(lum_p / torch.clamp(before["lum"], min=1e-20), 0.0, 1.0).numpy()
    u = tk._rand((NC,), SEED ^ 0xDEADBEEF, 0x70000, 3, "cpu")[0].numpy()
    check_one_step("mmlt", jstate, before, tnew, jnew, u, a, ("lum", "eye", "pix", "t1_val"))
    w, h = ts.meta.res_x, ts.meta.res_y
    step_t = (tnew["splat"] - before["splat"]).numpy().reshape(h, w, 3)
    step_j = (jnew["splat"] - jstate["splat"]).reshape(h, w, 3)
    check_image(np.maximum(step_t, 0.0), np.maximum(step_j, 0.0), "mmlt step splats")


def test_render_matches_jax_and_the_path_tracer(case):
    check_render(case["img"], case["ref"], case["pt_img"], *_b_totals(case), "mmlt")
