"""Kelemen PSSMLT in both of its variants, the port against the JAX package,
on the CPU: small-box at 64x48, max_bounces 4, NC chains, BOOT bootstrap
rounds, 1 spp (one mutation step: the JAX package compiles its step loop
once per step count), on the numpy BVH build.

  * `_rand` bit for bit, `_mutate_small` within 1e-6;
  * one `mlt_steps` and one `mlt_steps_bdpt` step from the same state (the
    state the JAX render's step started from), per lane: the accept decisions equal
    wherever |u - a| > 1e-4, the new states' luminances and values at rtol
    1e-4 on >= 99.9% of the lanes, the step's splats by the render tests'
    bars;
  * the seed selection: on the JAX package's own bootstrap luminances the
    picks equal the JAX package's, on the port's >= 99% of them agree;
  * both renders: b within 2e-3 relative, the luminance mean within 1e-2
    and the per-channel means within 5e-2 of the JAX render's at equal
    seed, and each within 0.15 of the port's path-traced image on the
    pixels it shows above 0.01 (tests/test_path_tracer.py:290-309, there on
    the Cornell box);
  * a resumed render equals a straight one bit for bit, and a state file the
    JAX package wrote resumes in the port (one more step, against the JAX
    package resuming the same file).

The render bars and the recorders serve test_torch_mmlt.py and
test_torch_rjmlt.py.
"""
import contextlib
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_lockstep_area import check_image, one_torch_thread  # noqa: F401
from test_torch_mlt_sampler import SEED, lanes_close, mlt_scenes, t

NC = 3072  # chains: 1 spp at 64x48 is one step
BOOT = 4
P_LARGE = 0.1
B_RTOL, LUM_RTOL, MEAN_RTOL, PT_ATOL = 2e-3, 1e-2, 5e-2, 0.15
PT_SPP = 8


@contextlib.contextmanager
def recorder(module, name, jit=False):
    """Records (args, kwargs, result) of every call of module.name while
    open; the calls go through, with `jit` through jax.jit of the function
    (the JAX bootstraps call `_eval_bdpt` op by op, ~7 s a call on the CPU
    here; compiled once, a call takes a fraction of a second)."""
    calls, saved = [], getattr(module, name)
    fn = jax.jit(saved, static_argnames=("skip_dims",)) if jit else saved

    def rec(*a, **k):
        out = fn(*a, **k)
        calls.append((a, k, out))
        return out

    setattr(module, name, rec)
    try:
        yield calls
    finally:
        setattr(module, name, saved)


def luminance(img):
    return img[..., 0] * 0.2126 + img[..., 1] * 0.7152 + img[..., 2] * 0.0722


def check_render(img, ref, pt, b, b_ref, label):
    """The render bars against the JAX render (b, luminance mean, channel
    means) and against the port's PT image (masked channel means)."""
    assert img.shape == ref.shape and np.isfinite(img).all() and (img >= 0).all()
    assert abs(b - b_ref) <= B_RTOL * abs(b_ref), f"{label}: b {b} vs JAX {b_ref}"
    lum, lum_ref = luminance(img).mean(), luminance(ref).mean()
    assert abs(lum - lum_ref) <= LUM_RTOL * lum_ref, f"{label}: luminance {lum} vs {lum_ref}"
    np.testing.assert_allclose(img.reshape(-1, 3).mean(0), ref.reshape(-1, 3).mean(0),
                               rtol=MEAN_RTOL, err_msg=label)
    mask = pt.max(-1) > 0.01
    ratio = img[mask].mean(0) / pt[mask].mean(0)
    np.testing.assert_allclose(ratio, 1.0, atol=PT_ATOL, err_msg=f"{label} vs PT")


def port_pt(ts):
    from tungsten_tpu_torch.renderer.render import render_flat

    return render_flat(ts, spp=PT_SPP, seed=SEED + 1)


def accepted(new_table, old_table):
    """The lanes whose table changed (a proposal differs in every slot)."""
    return np.asarray(new_table != old_table).reshape(len(old_table), -1).any(-1)


def check_one_step(label, jstate, tstate, tnew, jnew, u, a, fields):
    """Per lane: the accept decisions equal where |u - a| > 1e-4, the new
    state's `fields` where they agree."""
    old = jstate["table"]
    acc_j = accepted(np.asarray(jnew["table"]), np.asarray(old))
    acc_t = accepted(tnew["table"].numpy(), tstate["table"].numpy())
    clear = np.abs(u - a) > 1e-4
    assert clear.mean() > 0.9 and 0.05 < acc_t.mean() < 1.0, (clear.mean(), acc_t.mean())
    assert (acc_j == acc_t)[clear].all(), f"{label}: {(acc_j != acc_t)[clear].sum()} decisions"
    same = acc_j == acc_t
    for f in fields:
        lanes_close(tnew[f].numpy()[same], np.asarray(jnew[f])[same], f"{label} {f}")
    return acc_t


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """small-box in both packages, the JAX renders of both variants (with
    their bootstrap luminances and saved states) and the port's."""
    from tungsten_tpu.integrators import kelemen as jk
    from tungsten_tpu_torch.integrators import kelemen as tk

    tmp = tmp_path_factory.mktemp("kelemen")
    ts, js, _ = mlt_scenes(str(tmp), "small-box", "kelemen_mlt")
    out = dict(ts=ts, js=js, tmp=tmp, pt_img=port_pt(ts))
    for name, jfn, jev, jstep, tfn, tboot in (
            ("pt", jk.render_kelemen, "_eval", "mlt_steps", tk.render_kelemen,
             "_bootstrap_kelemen"),
            ("bdpt", jk.render_kelemen_bdpt, "_eval_bdpt", "mlt_steps_bdpt",
             tk.render_kelemen_bdpt, "_bootstrap_kelemen_bdpt")):
        state_file = str(tmp / f"jax_{name}.npz")
        # the bootstrap, then the step loop's trace
        with recorder(jk, jev, jit=name == "bdpt") as calls, recorder(jk, jstep) as steps:
            ref = jfn(js, spp=1, seed=SEED, n_chains=NC, bootstrap_factor=BOOT,
                      p_large=P_LARGE, resume_file=state_file)
        if name == "pt":
            lums = np.concatenate([np.asarray(jk._luminance(c[2][0])) for c in calls[:BOOT]])
        else:
            lums = np.concatenate([np.asarray(c[2]["lum"]) for c in calls[:BOOT]])
        with recorder(tk, tboot) as boot:
            img = tfn(ts, spp=1, seed=SEED, n_chains=NC, bootstrap_factor=BOOT, p_large=P_LARGE)
        out[name] = dict(ref=ref, img=img, jax_lums=lums, jax_b=float(jnp.mean(jnp.asarray(lums))),
                         port_b=boot[0][2][1], port_lums=boot[0][2][2], state_file=state_file,
                         jax_step=steps[0])
    return out


def test_rand_matches_jax_bit_for_bit():
    from tungsten_tpu.integrators.kelemen import _rand as jrand
    from tungsten_tpu_torch.integrators.kelemen import _rand

    s0 = (SEED ^ 0xDEADBEEF) & 0xFFFFFFFF
    for shape, salt in (((1000,), 0), ((257, 31), 7), ((64, 157), 0x7E003), ((5,), 0x4001 * 4)):
        j0, j1 = jrand(shape, jnp.uint32(s0), jnp.uint32(0x60000), jnp.uint32(salt))
        t0, t1 = _rand(shape, s0, 0x60000, salt, "cpu")
        assert np.array_equal(np.asarray(j0).view(np.uint32), t0.numpy().view(np.uint32))
        assert np.array_equal(np.asarray(j1).view(np.uint32), t1.numpy().view(np.uint32))


def test_mutate_small_matches_jax():
    from tungsten_tpu.integrators.kelemen import _mutate_small as jmut
    from tungsten_tpu_torch.integrators.kelemen import _mutate_small

    rng = np.random.default_rng(3)
    table, u_dir, u_mag = (rng.random((2048, 37, 2), dtype=np.float32) for _ in range(3))
    ref = np.asarray(jmut(jnp.asarray(table), jnp.asarray(u_dir), jnp.asarray(u_mag)))
    got = _mutate_small(*(torch.as_tensor(a) for a in (table, u_dir, u_mag))).numpy()
    assert ((got >= 0) & (got < 1)).all()
    # a wrap across 0 or 1 differs by 1 where the two round on either side
    d = np.abs(got - ref)
    np.testing.assert_allclose(np.minimum(d, 1.0 - d), 0.0, atol=1e-6)


def _one_step(case, name):
    """One step of the port from the state the JAX render's step started
    from (its bootstrap's); returns (JAX state, port state before, port
    state after, JAX after, u, a)."""
    from tungsten_tpu_torch.integrators import kelemen as tk

    ts = case["ts"]
    args, _, jout = case[name]["jax_step"]
    assert int(args[4]) == 0 and args[5] == 1
    jstate = jax.tree.map(np.asarray, args[1])
    b = float(args[7])
    seed1 = 0x50000 if name == "pt" else 0x60000
    before = {k: t(v) for k, v in jstate.items()}
    tstate = {k: v.clone() for k, v in before.items()}
    lanes = torch.arange(NC)
    step = tk.mlt_steps if name == "pt" else tk.mlt_steps_bdpt
    with recorder(tk, "_eval" if name == "pt" else "_eval_bdpt") as ev:
        tnew = step(ts, tstate, lanes, (SEED, seed1), 0, 1, P_LARGE, b)
    # the port's own acceptance inputs for the step
    out = ev[0][2]
    lum_p = tk._luminance(out[0]) if name == "pt" else out["lum"]
    a = torch.clamp(lum_p / torch.clamp(before["lum"], min=1e-20), 0.0, 1.0).numpy()
    u = tk._rand((NC,), SEED ^ 0xDEADBEEF, seed1, 3, "cpu")[0].numpy()
    return jstate, before, tnew, jax.tree.map(np.asarray, jout), u, a


@pytest.mark.parametrize("name", ["pt", "bdpt"])
def test_one_step_matches_jax_per_lane(case, name):
    jstate, before, tnew, jnew, u, a = _one_step(case, name)
    fields = ("lum", "rad", "pix") if name == "pt" else ("lum", "eye", "pix", "t1_val")
    check_one_step(name, jstate, before, tnew, jnew, u, a, fields)
    w, h = case["ts"].meta.res_x, case["ts"].meta.res_y
    step_t = (tnew["splat"] - before["splat"]).numpy().reshape(h, w, 3)
    step_j = (jnew["splat"] - np.asarray(jstate["splat"])).reshape(h, w, 3)
    check_image(np.maximum(step_t, 0.0), np.maximum(step_j, 0.0), f"{name} step splats")


@pytest.mark.parametrize("name", ["pt", "bdpt"])
def test_seed_selection_matches_jax(case, name):
    from tungsten_tpu_torch.integrators.kelemen import _select_seeds

    c = case[name]
    p = np.asarray(c["jax_lums"], np.float64)
    want = np.random.default_rng(SEED).choice(len(p), size=NC, p=p / p.sum())  # kelemen.py:386-391
    assert np.array_equal(_select_seeds(c["jax_lums"], NC, SEED), want)
    agree = (_select_seeds(c["port_lums"], NC, SEED) == want).mean()
    assert agree >= 0.99, f"{name}: {agree:.4f} of the picks on the port's luminances"


@pytest.mark.parametrize("name", ["pt", "bdpt"])
def test_render_matches_jax_and_the_path_tracer(case, name):
    c = case[name]
    check_render(c["img"], c["ref"], case["pt_img"], c["port_b"], c["jax_b"], f"kelemen {name}")


def test_resumed_render_equals_a_straight_one(case, tmp_path):
    from tungsten_tpu_torch.integrators.kelemen import render_kelemen

    ts = case["ts"]
    kw = dict(seed=SEED, n_chains=NC, bootstrap_factor=1, p_large=P_LARGE)
    straight = render_kelemen(ts, spp=2, **kw)
    state = str(tmp_path / "state.npz")
    render_kelemen(ts, spp=1, resume_file=state, **kw)
    resumed = render_kelemen(ts, spp=2, resume_file=state, **kw)
    assert np.array_equal(resumed, straight)


def test_a_jax_state_file_resumes_in_the_port(case, tmp_path):
    from tungsten_tpu.integrators.kelemen import render_kelemen as jrender
    from tungsten_tpu_torch.integrators.kelemen import load_mlt_state, render_kelemen

    kw = dict(seed=SEED, n_chains=NC, bootstrap_factor=BOOT, p_large=P_LARGE)
    paths = [str(tmp_path / f"{side}.npz") for side in ("port", "jax")]
    for p in paths:
        shutil.copy(case["pt"]["state_file"], p)
    got = render_kelemen(case["ts"], spp=2, resume_file=paths[0], **kw)
    ref = jrender(case["js"], spp=2, resume_file=paths[1], **kw)
    state, _, it = load_mlt_state(paths[0], "")
    assert it == 2 and set(state) == {"table", "rad", "lum", "pix", "splat"}
    check_image(got, ref, "kelemen pt resumed from the JAX state")


def test_reference_file_holds_the_four_variants():
    """tests/data/torch_port_mlt_ref.json (written by write_reference):
    small-box's four MLT variants at the CLI's seed and the scene's spp."""
    import json
    import os

    from tungsten_tpu_torch import synth

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", REF_FILE)) as f:
        ref = json.load(f)
    assert ref["scene"] == "small-box" and ref["seed"] == SEED
    assert ref["spp"] == synth.SIZES["small-box"][5]
    assert sorted(ref["channel_means"]) == sorted(REF_VARIANTS)
    means = np.array(list(ref["channel_means"].values()))
    assert means.shape == (4, 3) and (means > 0.1).all()
    # four estimators of one image
    assert (np.abs(means / means.mean(0) - 1.0) < 0.05).all()


REF_FILE = "torch_port_mlt_ref.json"
REF_VARIANTS = ("kelemen_mlt", "kelemen_mlt+pt", "multiplexed_mlt", "reversible_jump_mlt")


def write_reference(out_dir):
    """tests/data/torch_port_mlt_ref.json: the JAX package's small-box
    renders of the four MLT variants as its CLI renders them (the scene's 4
    spp and max_bounces 6, the render functions' default chains and
    bootstrap rounds, the CLI's default seed: one mutation step each, so
    no RJ-MLT strategy step), their channel means, on the numpy BVH build.
    The bootstraps' `_eval_bdpt` runs through jax.jit (the same function,
    compiled once). `PYTHONPATH=.:tests python tests/test_torch_kelemen.py`
    rewrites it (~6 min)."""
    import json
    import os

    import tungsten_tpu.accel.bvh as jbvh
    from tungsten_tpu.integrators import kelemen as jk, multiplexed as jm, rjmlt as jr
    from tungsten_tpu.scene.flatten import flatten_scene as jflatten
    from tungsten_tpu.scene.load import load_scene as jload
    from tungsten_tpu_torch import synth

    jbvh._NATIVE = False
    jbvh._CACHE_DIR = os.path.join(out_dir, "bvh_cache")
    fast = jax.jit(jk._eval_bdpt, static_argnames=("skip_dims",))
    jk._eval_bdpt = jm._eval_bdpt = fast
    out = {"scene": "small-box", "seed": SEED, "spp": synth.SIZES["small-box"][5],
           "channel_means": {}}
    for variant in REF_VARIANTS:
        path = synth.write_scene(os.path.join(out_dir, variant.replace("+", "-")), "small-box",
                                 variant)
        js = jflatten(jload(path))
        integ = variant.split("+")[0]
        fn = {"kelemen_mlt": jk.render_kelemen if "+pt" in variant else jk.render_kelemen_bdpt,
              "multiplexed_mlt": jm.render_mmlt, "reversible_jump_mlt": jr.render_rjmlt}[integ]
        img = np.asarray(fn(js, seed=SEED, verbose=True), np.float64)
        out["channel_means"][variant] = img.reshape(-1, 3).mean(0).tolist()
        print(variant, out["channel_means"][variant], flush=True)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", REF_FILE)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(path)


if __name__ == "__main__":
    import tempfile

    write_reference(tempfile.mkdtemp())
