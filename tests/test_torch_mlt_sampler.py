"""The MLT plumbing of the port against the JAX package, on the CPU: the
primary-sample table in the Sampler, `trace_pass(..., table)` in both of its
branches and `_bdpt_sample`'s MLT arguments. small-box (and small-cutout for
the forward branch) at 64x48, max_bounces MAX_BOUNCES, on the numpy BVH
build, tables drawn from a seeded numpy generator.

  * table draws bit for bit: the plain sampler (pending halves, a skip, the
    hash past the table's end) and the stratified one's windowed and
    gathered draws, which the table overrides (sampler.py:280-286);
  * trace_pass with a table per lane in both branches (the fast branch
    skips slot 0; the forward branch hashes its camera draws): rtol 1e-4 on
    >= 99.9% of lanes;
  * `_bdpt_sample` with table, skip_dims 2, a technique selector, collect
    and return_verts per lane: the eye value, the t = 1 splats, their
    pixels and flags, and the vertex stores, the same bar.

The helpers here serve the other MLT test files.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_lockstep_area import one_torch_thread  # noqa: F401

SEED = 0xBA5EBA11
MAX_BOUNCES = 4  # k_max 5 under BDPT
N = 4096
LANE_RTOL, LANE_ATOL, LANE_BAR = 1e-4, 1e-5, 0.999
PDF_BAR = 0.99  # the vertex stores' area pdfs (measured 0.9951-0.9978)


def mlt_scenes(tmp_dir, size="small-box", variant=None, max_bounces=MAX_BOUNCES):
    """`size` (with `variant`) at max_bounces in both packages on the numpy
    BVH build: (the port's scene on the CPU, the JAX scene, the path)."""
    import tungsten_tpu.accel.bvh as jbvh
    import tungsten_tpu_torch.accel.bvh as tbvh
    from tungsten_tpu.scene.flatten import flatten_scene as jflatten
    from tungsten_tpu.scene.load import load_scene as jload
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    path = synth.write_scene(tmp_dir, size, variant)
    with open(path) as f:
        doc = json.load(f)
    doc["integrator"]["max_bounces"] = max_bounces
    with open(path, "w") as f:
        json.dump(doc, f)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbvh, "_NATIVE", False)
        mp.setattr(tbvh, "_NATIVE", False)
        mp.setattr(jbvh, "_CACHE_DIR", os.path.join(tmp_dir, "bvh_cache"))
        return flatten_scene(load_scene(path), torch.device("cpu")), jflatten(jload(path)), path


def jseed(s1):
    return jnp.array([SEED & 0xFFFFFFFF, s1], jnp.uint32)


def t(a, dtype=None):
    """A JAX or numpy array as a CPU tensor (uint32 and int32 as int64)."""
    a = np.asarray(a)
    if a.dtype in (np.uint32, np.int32):
        a = a.astype(np.int64)
    out = torch.as_tensor(a.copy())
    return out if dtype is None else out.to(dtype)


def lanes_close(port, ref, label, rtol=LANE_RTOL, atol=LANE_ATOL, bar=LANE_BAR):
    """>= bar of the lanes with every component within atol + rtol |ref|."""
    p = np.asarray(port, np.float64).reshape(len(port), -1)
    r = np.asarray(ref, np.float64).reshape(len(ref), -1)
    ok = np.all(np.abs(p - r) <= atol + rtol * np.abs(r), axis=1)
    assert ok.mean() >= bar, f"{label}: {ok.mean():.5f} of lanes within {atol} + {rtol} |ref| " \
                             f"(< {bar}); worst {np.abs(p - r).max():.3e}"
    return ok


def table_of(rng, n, dims):
    return rng.random((n, dims, 2), dtype=np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def test_table_draws_match_jax_bit_for_bit():
    from tungsten_tpu.sampling import sampler as js
    from tungsten_tpu_torch.sampling import sampler as ts

    rng = np.random.default_rng(5)
    n, dims = 512, 9
    lane = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    table = table_of(rng, n, dims)
    jsmp = js.Sampler.create(jnp.asarray(np.array([7, 9], np.uint32)), jnp.asarray(lane),
                             jnp.asarray(table), strat=True)
    tsmp = ts.Sampler.create((7, 9), t(lane), torch.as_tensor(table), strat=True)
    assert not jsmp.strat and not tsmp.strat  # a table turns stratification off
    jsmp, tsmp = jsmp.skip(1), tsmp.skip(1)
    # pairs, halves with their pending partner, and the hash past slot 8
    for op in ("2d", "1d", "1d", "1d", "2d", "skip", "1d", "2d", "2d", "1d", "1d", "2d", "2d"):
        if op == "skip":
            jsmp, tsmp = jsmp.skip(2), tsmp.skip(2)
            continue
        uj, jsmp = getattr(jsmp, f"next_{op}")()
        ut, tsmp = getattr(tsmp, f"next_{op}")()
        assert np.array_equal(_bits(uj), _bits(ut.numpy())), op
    assert int(jsmp.dim) == tsmp.dim > dims

    # the stratified sampler of the forward branch's bounces: a table with
    # a prefetched window (8 pairs) and the pair gather past it
    samp = rng.integers(0, 40, n).astype(np.uint32)
    pix = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    seed = jnp.asarray(np.array([3, 11], np.uint32))
    for d0 in (2, 5):
        jsmp = js.Sampler(seed, jnp.asarray(lane), jnp.int32(d0), jnp.asarray(table),
                          jnp.asarray(samp), jnp.asarray(pix), True).prefetch(8)
        tsmp = ts.Sampler((3, 11), t(lane), d0, t(samp), t(pix), True,
                          table=torch.as_tensor(table)).prefetch(8)
        for k in range(12):
            uj, jsmp = jsmp.next_2d()
            ut, tsmp = tsmp.next_2d()
            assert np.array_equal(_bits(uj), _bits(ut.numpy())), (d0, k)


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    ts, js, _ = mlt_scenes(str(tmp_path_factory.mktemp("small-box")))
    return ts, js


def _pt_lanes(meta, table):
    w, h = meta.res_x, meta.res_y
    px = np.minimum((table[:, 0, 0] * w).astype(np.int32), w - 1)
    py = np.minimum((table[:, 0, 1] * h).astype(np.int32), h - 1)
    return px, py


def _trace_pass_both(ts, js, dims, n=N):
    from tungsten_tpu.integrators.path_tracer import trace_pass as jtrace_pass
    from tungsten_tpu_torch.integrators.path_tracer import trace_pass

    table = table_of(np.random.default_rng(11), n, dims)
    px, py = _pt_lanes(ts.meta, table)
    lanes = np.arange(n, dtype=np.uint32)
    ref = jtrace_pass(js, jseed(0x50000), jnp.asarray(lanes), jnp.asarray(px),
                      jnp.asarray(py), jnp.asarray(table))
    got = trace_pass(ts, (SEED, 0x50000), t(lanes), t(px), t(py), torch.as_tensor(table))
    return np.asarray(ref), got.numpy()


def test_trace_pass_with_a_table_matches_jax_per_lane(box):
    """The fast branch (no forward lobe): slot 0 skipped, no (0,2)-sequence
    AA, every bounce's draws from the table (12 bounces' worth, 4 here)."""
    from tungsten_tpu_torch.integrators.kelemen import _table_dims

    ts, js = box
    assert not ts.meta.has_forward
    ref, got = _trace_pass_both(ts, js, _table_dims(ts.meta))
    assert (got.sum(-1) > 0).mean() > 0.5
    lanes_close(got, ref, "small-box trace_pass(table)")


def test_trace_pass_forward_branch_with_a_table_matches_jax_per_lane(tmp_path_factory):
    """The forward branch: the camera draws hash as without a table (its
    sampler has none), the bounces read the table from dim 2 on (ROADMAP
    §3). 3,072 lanes: from 4,096 on the JAX branch compacts its lanes
    without carrying their table rows and Sobol' keys along (ROADMAP §3),
    and no longer traces the lane's own path."""
    ts, js, _ = mlt_scenes(str(tmp_path_factory.mktemp("small-cutout")), "small-cutout")
    assert ts.meta.has_forward
    ref, got = _trace_pass_both(ts, js, 5 + 24 * MAX_BOUNCES, n=3072)
    assert (got.sum(-1) > 0).mean() > 0.3
    lanes_close(got, ref, "small-cutout trace_pass(table)")


def test_bdpt_sample_with_table_selector_collect_and_verts_matches_jax_per_lane(box):
    from tungsten_tpu.integrators.bdpt import _bdpt_sample as jbdpt
    from tungsten_tpu_torch.integrators.bdpt import _FIELDS, _bdpt_sample
    from tungsten_tpu_torch.integrators.kelemen import _select_technique, _table_dims_bdpt

    ts, js = box
    k_max = min(ts.meta.max_bounces + 1, ts.meta.bdpt_max_vertices)
    table = table_of(np.random.default_rng(13), N, _table_dims_bdpt(ts.meta, k_max, extra=2))
    px, py = _pt_lanes(ts.meta, table)
    v_sel = np.arange(N) % (k_max - 1) + 2
    s_sel = _select_technique(torch.as_tensor(table[:, 1, 0]), t(v_sel)).numpy()
    lanes = np.arange(N, dtype=np.uint32)

    @jax.jit
    def ref_fn(scene, tbl, ss, vs):
        return jbdpt(scene, jseed(0x70000), jnp.asarray(lanes), jnp.asarray(px),
                     jnp.asarray(py), table=tbl, skip_dims=2, sel=(ss, vs), collect=True,
                     return_verts=True)

    ref = jax.tree.map(np.asarray, ref_fn(js, jnp.asarray(table), jnp.asarray(s_sel, jnp.int32),
                                          jnp.asarray(v_sel, jnp.int32)))
    got = _bdpt_sample(ts, (SEED, 0x70000), t(lanes), t(px), t(py),
                       table=torch.as_tensor(table), skip_dims=2,
                       sel=(torch.as_tensor(s_sel), t(v_sel)), collect=True, return_verts=True)
    S = k_max - 2
    assert got["t1_val"].shape == (N, S, 3) and ref["t1_val"].shape == (N, S, 3)
    assert (got["eye"].sum(-1) > 0).float().mean() > 0.05 and got["t1_ok"].any()
    lanes_close(got["eye"].numpy(), ref["eye"], "eye")
    lanes_close(got["t1_val"].numpy(), ref["t1_val"], "t1_val")
    # the pixel of a splat that does not land is never read (its value is
    # masked): compared where the JAX splat lands
    live = ref["t1_ok"][..., None]
    lanes_close(np.where(live, got["t1_pixf"].numpy(), 0.0), np.where(live, ref["t1_pixf"], 0.0),
                "t1_pixf")
    assert (got["t1_ok"].numpy() == ref["t1_ok"]).all(-1).mean() >= LANE_BAR
    for key in ("n_cv", "n_lv"):
        assert (got[key].numpy() == ref[key]).mean() >= LANE_BAR, key
    assert set(got["cv"]) == set(_FIELDS) == set(ref["cv"])
    for side in ("cv", "lv"):
        # positions to 1e-4 of the box's half extent (~10): a coordinate
        # near 0 has no relative bar
        lanes_close(got[side]["p"].numpy(), ref[side]["p"], f"{side}.p", atol=1e-3)
        # uv to 1e-4 of its [0, 1] range, likewise
        lanes_close(got[side]["uv"].numpy(), ref[side]["uv"], f"{side}.uv", atol=1e-4)
        for name in ("ng", "nf", "throughput"):
            lanes_close(got[side][name].numpy(), ref[side][name], f"{side}.{name}")
        # the area pdfs go as 1 / d^2 and the cosines at both ends: a hit
        # point's rounding moves them beyond rtol 1e-4 on 0.2-0.5% of the
        # lanes (the eye and t = 1 values above, which they weight, hold
        # the 99.9% bar)
        for name in ("pdf_fwd", "pdf_rev"):
            lanes_close(got[side][name].numpy(), ref[side][name], f"{side}.{name}",
                        bar=PDF_BAR)
        for name in ("kind", "mat", "light", "tri", "dirac", "flip"):
            same = (got[side][name].numpy() == ref[side][name]).all(-1).mean()
            assert same >= LANE_BAR, f"{side}.{name}: {same}"
