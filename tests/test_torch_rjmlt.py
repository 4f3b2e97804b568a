"""Reversible-jump MLT, the port against the JAX package, on the CPU.

  * the mirrors of tests/test_invert.py for the port, both tests: every one
    of the nine inverters' sample -> invert -> sample round trip (>= 95% of
    the valid samples invert, < 1% come back elsewhere), the inverse
    warps' round trips; each inverter also against the JAX package's on the
    same inputs (ok flags equal on >= 99.9% of the lanes, the uniforms at
    rtol 1e-4 where both invert);
  * `invert_path_to_table` per lane on the same realized chains (the port's
    `_bdpt_sample` with return_verts on small-box): the ok flags equal and
    the rewritten tables at rtol 1e-4, on >= 99.9% of the lanes;
  * one strategy step from the state the JAX render's started from, per
    lane, with kelemen's bars, and its accept and invertible fractions;
  * `render_rjmlt` (small-box at 64x48, max_bounces 4, 4 spp: three Kelemen
    steps and one strategy step) with kelemen's render bars, mirroring
    test_rjmlt_matches_path_tracer (tests/test_path_tracer.py:312-331).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_invert import SPECS
from test_torch_kelemen import (BOOT, NC, P_LARGE, check_one_step, check_render, port_pt,
                                recorder)
from test_torch_lockstep_area import check_image, one_torch_thread  # noqa: F401
from test_torch_mlt_sampler import SEED, lanes_close, mlt_scenes, t

SPP = 4  # 4 steps at NC chains: 3 Kelemen, 1 strategy


def _port_ctx(specs):
    from tungsten_tpu_torch.models.bsdfs import dispatch as td
    from tungsten_tpu_torch.models.textures.textures import TextureBuilder, TextureTable

    tb = TextureBuilder()
    packed = td.pack_materials([dict(s) for s in specs], tb)
    rough = tb.kinds_of(tb.rough_ids)
    tex = tb.build_arrays()
    cpu = torch.device("cpu")
    return (td.MaterialTable.from_arrays(td.build_gpack2(packed, tex["tpack"]), rough, cpu),
            TextureTable.from_arrays(tex["tpack"], tex["data"], tex["data4"], cpu))


@pytest.mark.parametrize("mi", range(len(SPECS)))
def test_bsdf_invert_roundtrip(mi):
    """test_invert.py's round trip on the port, and the port's inversion
    against the JAX package's on the same directions."""
    from test_invert import _ctx_for
    from tungsten_tpu.models.bsdfs.invert import bsdf_invert as jinvert
    from tungsten_tpu_torch.models.bsdfs.dispatch import bsdf_sample, gather
    from tungsten_tpu_torch.models.bsdfs.invert import bsdf_invert

    ctx = _port_ctx(SPECS)
    n = 2048
    rng = np.random.default_rng(17 + mi)
    wi = rng.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    wi[..., 2] = np.abs(wi[..., 2]) + 1e-3
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    u2 = rng.random((n, 2), np.float32)
    u1 = rng.random((n,), np.float32)
    mat_id = torch.full((n,), mi, dtype=torch.int64)
    uv = torch.zeros((n, 2))
    wi_t = torch.as_tensor(wi)
    pre = gather(ctx[0], ctx[1], mat_id, uv)
    bs = bsdf_sample(ctx[0], pre, uv, wi_t, torch.as_tensor(u2), torch.as_tensor(u1),
                     textures=ctx[1])
    mu = tuple(float(x) for x in rng.random(3))
    iu2, iu1, ok = bsdf_invert(ctx, mat_id, uv, wi_t, bs.wo, mu=mu)
    valid = bs.valid.numpy()
    ok = ok.numpy() & valid
    assert ok[valid].mean() > 0.95, f"{SPECS[mi]['type']}: {ok[valid].mean():.2f} invertible"
    bs2 = bsdf_sample(ctx[0], pre, uv, wi_t, iu2, iu1, textures=ctx[1])
    dots = (bs2.wo * bs.wo).sum(-1).numpy()
    bad = ok & (dots < 1.0 - 1e-4)
    assert bad.mean() < 0.01, f"{SPECS[mi]['type']}: {bad.mean():.3f} diverge"

    # the JAX package's inversion of the same (wi, wo)
    j2, j1, jok = jinvert(_ctx_for(SPECS), jnp.full((n,), mi, jnp.int32), jnp.zeros((n, 2)),
                          jnp.asarray(wi), jnp.asarray(bs.wo.numpy()), mu=mu)
    tok = bsdf_invert(ctx, mat_id, uv, wi_t, bs.wo, mu=mu)[2].numpy()
    assert (tok == np.asarray(jok)).mean() >= 0.999
    both = tok & np.asarray(jok)
    got = np.concatenate([iu2.numpy(), iu1.numpy()[:, None]], axis=1)[both]
    ref = np.concatenate([np.asarray(j2), np.asarray(j1)[:, None]], axis=1)[both]
    lanes_close(got, ref, f"{SPECS[mi]['type']} uniforms")


def test_invert_warp_roundtrips():
    from tungsten_tpu.sampling import warps as jw
    from tungsten_tpu_torch.sampling import warps

    rng = np.random.default_rng(3)
    u_np = rng.random((4096, 2), np.float32)
    u = torch.as_tensor(u_np)
    for name in ("cosine_hemisphere", "uniform_hemisphere", "uniform_sphere"):
        fwd, inv = getattr(warps, name), getattr(warps, f"invert_{name}")
        w = fwd(u)
        assert float((fwd(inv(w)) - w).abs().max()) < 1e-4, name
        ref = np.asarray(getattr(jw, f"invert_{name}")(jnp.asarray(w.numpy()), 0.3))
        np.testing.assert_allclose(inv(w, 0.3).numpy(), ref, atol=1e-6, err_msg=name)
    bary = warps.uniform_triangle_uv(u)
    b2 = warps.uniform_triangle_uv(warps.invert_uniform_triangle_uv(bary))
    assert float((b2 - bary).abs().max()) < 1e-4
    p = warps.uniform_disk(u)
    np.testing.assert_allclose(warps.invert_uniform_disk(p, 0.3).numpy(),
                               np.asarray(jw.invert_uniform_disk(jnp.asarray(p.numpy()), 0.3)),
                               atol=1e-6)
    w = warps.uniform_sphere(u)
    got, ok = warps.invert_uniform_spherical_cap(w, 0.4, 0.3)
    ref, jok = jw.invert_uniform_spherical_cap(jnp.asarray(w.numpy()), 0.4, 0.3)
    assert np.array_equal(ok.numpy(), np.asarray(jok)) and 0.2 < ok.float().mean() < 0.4
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    from tungsten_tpu.integrators import multiplexed as jm
    from tungsten_tpu.integrators import rjmlt as jr
    from tungsten_tpu_torch.integrators import rjmlt as tr

    tmp = tmp_path_factory.mktemp("rjmlt")
    ts, js, _ = mlt_scenes(str(tmp), "small-box", "reversible_jump_mlt")
    with recorder(jm, "_eval_bdpt", jit=True) as evs, recorder(jr, "rjmlt_strategy_step") as st:
        ref = jr.render_rjmlt(js, spp=SPP, seed=SEED, n_chains=NC, bootstrap_factor=BOOT,
                              p_large=P_LARGE)
    lums = np.concatenate([np.asarray(ev["lum"]) * np.where(
        np.asarray(k["sel"][1]) <= 2, 1, np.asarray(k["sel"][1])) for _, k, ev in evs[:BOOT]])
    vs = np.concatenate([np.asarray(k["sel"][1]) for _, k, _ in evs[:BOOT]])
    from tungsten_tpu_torch.integrators import multiplexed as tm

    with recorder(tm, "_budget") as budget:
        img = tr.render_rjmlt(ts, spp=SPP, seed=SEED, n_chains=NC, bootstrap_factor=BOOT,
                              p_large=P_LARGE)
    b_jax = sum(float(lums[vs == v].mean()) for v in np.unique(vs))
    return dict(ts=ts, js=js, ref=ref, img=img, pt_img=port_pt(ts),
                stats=tr.render_rjmlt.last_stats, b_jax=b_jax,
                b_port=sum(budget[0][2][0].values()), jax_step=st[0])


def test_invert_path_to_table_matches_jax_per_lane(case):
    from tungsten_tpu.integrators.rjmlt import invert_path_to_table as jinvert
    from tungsten_tpu_torch.integrators.bdpt import _bdpt_sample
    from tungsten_tpu_torch.integrators.kelemen import (_chain_pixels, _select_technique,
                                                        _table_dims_bdpt)
    from tungsten_tpu_torch.integrators.rjmlt import invert_path_to_table

    ts, js = case["ts"], case["js"]
    k_max = min(ts.meta.max_bounces + 1, ts.meta.bdpt_max_vertices)
    n = 2048
    rng = np.random.default_rng(23)
    table = torch.as_tensor(rng.random((n, _table_dims_bdpt(ts.meta, k_max, 2), 2), np.float32))
    v = torch.as_tensor(rng.integers(3, k_max + 1, n))
    s_cur = _select_technique(table[:, 1, 0], v)
    s_new = _select_technique(torch.as_tensor(rng.random(n, np.float32)), v)
    mu3 = tuple(torch.as_tensor(rng.random(n, np.float32)) for _ in range(3))
    px, py = _chain_pixels(ts.meta, table)
    cur = _bdpt_sample(ts, (SEED, 0x71000), torch.arange(n), px, py, table=table, skip_dims=2,
                       sel=(s_cur, v), collect=True, return_verts=True)
    got, ok = invert_path_to_table(ts, cur, table, s_cur, s_new, v, k_max, 2, mu3)

    def jx(a):
        a = a.numpy()
        return jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)

    jcur = {k: ({f: jx(x) for f, x in val.items()} if isinstance(val, dict) else jx(val))
            for k, val in cur.items()}
    ref, jok = jinvert(js, jcur, jx(table), jx(s_cur), jx(s_new), jx(v), k_max, 2,
                       tuple(jx(m) for m in mu3))
    ok, jok = ok.numpy(), np.asarray(jok)
    assert 0.2 < jok.mean() < 0.95 and (ok == jok).mean() >= 0.999, (ok.mean(), jok.mean())
    assert not np.array_equal(np.asarray(ref), table.numpy())  # slots were rewritten
    lanes_close(got.numpy()[ok & jok], np.asarray(ref)[ok & jok], "rewritten tables")


def test_one_strategy_step_matches_jax_per_lane(case):
    """The port's strategy step from the state the JAX render's started
    from (after three Kelemen steps)."""
    from tungsten_tpu_torch.integrators import kelemen as tk
    from tungsten_tpu_torch.integrators import rjmlt as tr

    ts = case["ts"]
    args, _, (jnew, jstats) = case["jax_step"]
    idx, k_max = int(args[4]), args[7]
    assert idx == tr.STRATEGY_STEP0 + tr.STRATEGY_EVERY - 1 and args[8] == 2
    jstate = jax.tree.map(np.asarray, args[1])
    jnew = jax.tree.map(np.asarray, jnew)
    before = {k: t(v) for k, v in jstate.items()}
    tstate = {k: v.clone() for k, v in before.items()}
    bw, v_sel = t(args[5]), t(args[6])
    with recorder(tr, "_bdpt_sample") as ev:
        tnew, stats = tr.rjmlt_strategy_step(ts, tstate, torch.arange(NC), (SEED, 0x71000), idx,
                                             bw, v_sel, k_max, 2)
    prop = ev[1][2]
    t1 = torch.where(prop["t1_ok"][..., None], prop["t1_val"], 0.0) / (ts.meta.res_x
                                                                      * ts.meta.res_y)
    lum_p = (tk._luminance(prop["eye"]) + tk._luminance(t1).sum(1)) * tk._ntech_lanes(v_sel)
    # a before the inversion gate: a lane that does not invert is rejected
    # on both sides whatever its a
    a = torch.clamp(lum_p / torch.clamp(before["lum"], min=1e-20), 0.0, 1.0).numpy()
    u = tk._rand((NC,), SEED ^ 0xC0FFEE, 0x71000, idx * 4 + 3, "cpu")[0].numpy()
    acc = check_one_step("rjmlt strategy", jstate, before, tnew, jnew, u, a,
                         ("lum", "eye", "pix", "t1_val"))
    accept, invert = (float(x) for x in stats)
    assert accept == pytest.approx(float(acc.mean()))
    for got, ref in zip((accept, invert), jstats):
        assert abs(got - float(ref)) <= 2e-3, (got, float(ref))
    assert 0.2 < invert < 0.95
    w, h = ts.meta.res_x, ts.meta.res_y
    step_t = (tnew["splat"] - before["splat"]).numpy().reshape(h, w, 3)
    step_j = (jnew["splat"] - jstate["splat"]).reshape(h, w, 3)
    check_image(np.maximum(step_t, 0.0), np.maximum(step_j, 0.0), "rjmlt step splats")


def test_render_matches_jax_and_the_path_tracer(case):
    acc, inv, n = case["stats"]
    assert n == 1 and 0.0 < acc <= inv < 1.0
    check_render(case["img"], case["ref"], case["pt_img"], case["b_port"], case["b_jax"], "rjmlt")
