"""The light tracer and its pieces in both packages, on the CPU, and the
helpers of test_torch_bdpt.py and test_torch_bdpt_media.py.

Each package flattens the same scene on the numpy BVH build; the JAX side
runs as its own tests run it on the CPU, the port its twins (the BVH8 walks'
closest hit through the fast walk with its exact repair).

  * per call, on the same inputs made from a numpy seed: the camera
    connection (`camera_eval_direction`, `camera_sample_direct`) on points
    and directions in front of the camera, behind it and off the film:
    validity equal, floats within rtol 1e-5 (pixel coordinates with an
    absolute 1e-4 pixels: see PIXEL_ATOL); `sample_emitter_position` on
    small-area (triangle lights beside the sky, whose env row is invalid)
    and small-lights (analytic emitters, envs, caps and a point light; only
    the area and analytic rows valid); `splat_filtered` for tent, box, dirac
    and the four tabulated filters on points over the film and past its
    border;
  * a splat far from the border deposits its value (tests/test_filters.py:
    51-62);
  * small-box end to end: one `trace_light_pass` splat buffer (divided by
    the number of paths) and `render_light_traced` against the JAX
    package's at equal seed, with the render tests' bars (check_image of
    test_torch_lockstep_area.py: >= 98% of pixels within 1e-3 + 1e-3 |ref|,
    channel means within 2e-3 relative), the pass walking K3-fast's and
    K3's twins;
  * tests/data/torch_port_bdpt_ref.json holds the JAX renders' channel
    means for the check on the card; `python tests/test_torch_light_tracer.py`
    writes it anew (the JAX BDPT compiles take 30-70 s each here).
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_host import jax_arrays
from test_torch_lockstep_area import DATA, check_image, one_torch_thread  # noqa: F401

REF = os.path.join(DATA, "torch_port_bdpt_ref.json")
SEED = 0xBA5EBA11  # render.py DEFAULT_SEED
PYRAMID_SPP = 2
RTOL, ATOL = 1e-5, 1e-6
# a pixel coordinate is (x + 1) / (2 / W): near the film's left and top
# edges x + 1 cancels, so its rounding is absolute, ~1e-6 of the film width
PIXEL_ATOL = 1e-4
N = 4096
FILTERS = ("tent", "box", "dirac", "gaussian", "mitchell_netravali", "catmull_rom", "lanczos")


def both_scenes(size, variant, tmp_dir):
    """`size` (with `variant`) flattened by both packages on the numpy BVH
    build: (the port's scene on the CPU, the JAX scene)."""
    import tungsten_tpu.accel.bvh as jbvh
    import tungsten_tpu_torch.accel.bvh as tbvh
    from tungsten_tpu.scene.flatten import flatten_scene as jflatten
    from tungsten_tpu.scene.load import load_scene as jload
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbvh, "_NATIVE", False)
        mp.setattr(tbvh, "_NATIVE", False)
        mp.setattr(jbvh, "_CACHE_DIR", os.path.join(tmp_dir, "bvh_cache"))
        path = synth.write_scene(tmp_dir, size, variant)
        return flatten_scene(load_scene(path), torch.device("cpu")), jflatten(jload(path))


def jax_seed(s1):
    return jnp.array([SEED & 0xFFFFFFFF, s1], jnp.uint32)


def jax_lt_results(js, pass_too=True):
    """The JAX light tracer on js: the render at the scene's spp, and one
    pass's splat buffer (pass 0)."""
    from tungsten_tpu.integrators.light_tracer import trace_light_pass
    from tungsten_tpu.renderer.render import render_light_traced

    out = {"lt": np.asarray(render_light_traced(js, seed=SEED))}
    if pass_too:
        lanes = jnp.arange(js.meta.res_x * js.meta.res_y, dtype=jnp.uint32)
        out["lt_pass"] = np.asarray(trace_light_pass(js, jax_seed(0x10000), lanes))
    return out


def jax_bdpt_results(js, pass_too=True, pyramid=True):
    """The JAX BDPT on js: one pass (eye, splat) under pass 0's seed, the
    render at the scene's spp and the pyramid render at PYRAMID_SPP."""
    from tungsten_tpu.integrators.bdpt import trace_bdpt_pass
    from tungsten_tpu.renderer.render import render_bdpt, render_bdpt_pyramid

    out = {"bdpt": np.asarray(render_bdpt(js, seed=SEED))}
    if pass_too:
        w, h = js.meta.res_x, js.meta.res_y
        px = jnp.tile(jnp.arange(w, dtype=jnp.int32), h)
        py = jnp.repeat(jnp.arange(h, dtype=jnp.int32), w)
        eye, splat = trace_bdpt_pass(js, jax_seed(0x20000), jnp.arange(w * h, dtype=jnp.uint32),
                                     px, py)
        out["bdpt_pass"] = (np.asarray(eye), np.asarray(splat))
    if pyramid:
        img, stack = render_bdpt_pyramid(js, spp=PYRAMID_SPP, seed=SEED)
        out["bdpt_pyramid"] = (np.asarray(img), {k: np.asarray(v) for k, v in stack.items()})
    return out


def check_means_file(results, key, names):
    """The file's channel means under `key` equal the JAX renders' `names`
    (rtol 1e-4: another CPU's float rounding in XLA)."""
    with open(REF) as f:
        data = json.load(f)
    assert data["seed"] == SEED and data["pyramid_spp"] == PYRAMID_SPP
    assert data["spp"] == 4 and data["resolution"] == [64, 48]
    for name in names:
        img = results[name][0] if name == "bdpt_pyramid" else results[name]
        np.testing.assert_allclose(data["channel_means"][key][name],
                                   img.reshape(-1, 3).mean(0), rtol=1e-4, err_msg=name)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    return {size: both_scenes(size, None, str(tmp_path_factory.mktemp(size)))
            for size in ("small-area", "small-lights", "small-box")}


@pytest.fixture(scope="module")
def box(scenes):
    return jax_lt_results(scenes["small-box"][1])


def test_camera_connection_matches_jax(scenes):
    """camera_sample_direct on points all around the small-box camera (in
    front, behind, off the film) and camera_eval_direction on directions
    over the whole sphere: validity equal, the weights, pixels, directions
    and distances within rtol 1e-5."""
    from tungsten_tpu.models.cameras import connect as jconnect
    from tungsten_tpu_torch.models.cameras import connect

    ts, js = scenes["small-box"]
    gen = np.random.default_rng(14)
    p = gen.uniform([-4.0, 0.0, -2.5], [4.0, 4.0, 7.5], (N, 3)).astype(np.float32)
    got = connect.camera_sample_direct(ts.camera, ts.meta, torch.as_tensor(p))
    want = jconnect.camera_sample_direct(js.camera, js.meta, jnp.asarray(p))
    valid = want[4]
    assert 0.1 < np.asarray(valid).mean() < 0.9  # both sides of the window are tested
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(valid))
    for a, b, atol in zip(got[:4], want[:4], (ATOL, ATOL, ATOL, PIXEL_ATOL)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=atol)
    d = gen.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got = connect.camera_eval_direction(ts.camera, ts.meta, torch.as_tensor(d))
    want = jconnect.camera_eval_direction(js.camera, js.meta, jnp.asarray(d))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert np.asarray(want[2]).any() and not np.asarray(want[2]).all()
    ok = np.asarray(want[2])
    for a, b, atol in zip(got[:2], want[:2], (ATOL, PIXEL_ATOL)):  # behind: any pixel
        np.testing.assert_allclose(a.numpy()[ok], np.asarray(b)[ok], rtol=RTOL, atol=atol)


@pytest.mark.parametrize("size", ["small-area", "small-lights"])
def test_sample_emitter_position_matches_jax(scenes, size):
    """Every light row drawn uniformly: p, ng, uv, weight, radiance, tri and
    valid against the JAX package's. Env, cap and point rows are invalid;
    the area and analytic ones valid."""
    from tungsten_tpu.models.primitives import lights as jlights
    from tungsten_tpu_torch.models.primitives import lights as tlights
    from tungsten_tpu_torch.scene.flatten import from_arrays

    ts, js = scenes[size]
    cs = from_arrays(jax_arrays(js), js.meta, torch.device("cpu"))
    gen = np.random.default_rng(15)
    n_l = js.meta.n_lights
    li = gen.integers(0, n_l, N)
    u_tri = gen.random(N).astype(np.float32)
    u2 = gen.random((N, 2)).astype(np.float32)
    want = jlights.sample_emitter_position(js, jnp.asarray(li, jnp.int32), jnp.asarray(u_tri),
                                           jnp.asarray(u2))
    for scene in (ts, cs):
        got = tlights.sample_emitter_position(scene, torch.as_tensor(li), torch.as_tensor(u_tri),
                                              torch.as_tensor(u2))
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
        for f in ("p", "ng", "uv", "weight", "radiance"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                       rtol=RTOL, atol=ATOL, err_msg=f)
    kinds = tlights.light_kinds(ts)
    valid_kind = np.array([k not in ("env", "cap", "point") for k in kinds])
    np.testing.assert_array_equal(np.asarray(want.valid), valid_kind[li])
    if size == "small-lights":
        assert {"sphere", "disk", "cylinder", "env"} <= set(kinds)


@pytest.mark.parametrize("name", FILTERS)
def test_splat_filtered_matches_jax(name):
    """Splats over a 24x16 film and past its border (a fifth of them
    invalid) into a buffer holding values already: per pixel within rtol
    1e-5 of the JAX package's."""
    from tungsten_tpu.integrators.light_tracer import splat_filtered as jsplat
    from tungsten_tpu_torch.integrators.light_tracer import splat_filtered

    gen = np.random.default_rng(16)
    w, h, n = 24, 16, 2048
    pix = gen.uniform([-2.0, -2.0], [w + 2.0, h + 2.0], (n, 2)).astype(np.float32)
    val = gen.uniform(0.0, 2.0, (n, 3)).astype(np.float32)
    valid = gen.random(n) < 0.8
    buf0 = gen.random((w * h, 3)).astype(np.float32)
    got = splat_filtered(torch.as_tensor(buf0.copy()), torch.as_tensor(pix),
                         torch.as_tensor(val), torch.as_tensor(valid), w, h, name).numpy()
    want = np.asarray(jsplat(jnp.asarray(buf0), jnp.asarray(pix), jnp.asarray(val),
                             jnp.asarray(valid), w, h, filter_name=name))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if name == "dirac":
        np.testing.assert_array_equal(got, buf0)
    else:
        assert np.abs(got - buf0).sum() > 1.0


@pytest.mark.parametrize("name", ["tent", "mitchell_netravali", "box"])
def test_splat_energy_conservation(name):
    """A splat far from the border deposits about its full value: the
    signed kernel sums to ~1 over its 4x4 support."""
    from tungsten_tpu_torch.integrators.light_tracer import splat_filtered

    res = 16
    out = splat_filtered(torch.zeros((res * res, 3)), torch.tensor([[7.3, 8.6]]),
                         torch.tensor([[1.0, 2.0, 3.0]]), torch.tensor([True]), res, res, name)
    np.testing.assert_allclose(out.numpy().sum(axis=0), [1.0, 2.0, 3.0], rtol=0.04)


def test_light_pass_matches_jax(scenes, box):
    """One trace_light_pass of small-box (pass 0's seed) against the JAX
    package's splat buffer, per pixel, in units of the image (divided by the
    number of paths); the pass walks K3-fast's and exact K3's twins."""
    from tungsten_tpu_torch.integrators.light_tracer import LT_PASS_SEED, trace_light_pass
    from tungsten_tpu_torch.ops import bvh8

    ts = scenes["small-box"][0]
    n = ts.meta.res_x * ts.meta.res_y
    fast, exact = bvh8.walk_fast_twin.launches, bvh8.walk_twin.launches
    buf = trace_light_pass(ts, (SEED, LT_PASS_SEED), torch.arange(n)).numpy()
    assert bvh8.walk_fast_twin.launches > fast and bvh8.walk_twin.launches > exact
    assert buf.shape == (n, 3) and (buf.sum(-1) > 0).mean() > 0.5
    check_image(buf / n, box["lt_pass"] / n, "small-box light pass")


def test_render_light_traced_matches_jax(scenes, box):
    from tungsten_tpu_torch.renderer.render import render_light_traced

    img = render_light_traced(scenes["small-box"][0], seed=SEED)
    assert img.shape == (48, 64, 3)
    check_image(img, box["lt"], "small-box render_light_traced")


def test_reference_means_file_matches(box):
    check_means_file(box, "small-box", ("lt",))


if __name__ == "__main__":  # write tests/data/torch_port_bdpt_ref.json anew
    import tempfile

    jax.config.update("jax_platforms", "cpu")
    means = {}
    with tempfile.TemporaryDirectory() as tmp:
        for key, size, variant in (("small-box", "small-box", None),
                                   ("small-media-fog", "small-media", "fog")):
            js = both_scenes(size, variant, os.path.join(tmp, key))[1]
            res = jax_lt_results(js, pass_too=False)
            res.update(jax_bdpt_results(js, pass_too=False, pyramid=size == "small-box"))
            means[key] = {k: (v[0] if k == "bdpt_pyramid" else v).reshape(-1, 3).mean(0).tolist()
                          for k, v in res.items()}
    with open(REF, "w") as f:
        json.dump({"seed": SEED, "spp": 4, "pyramid_spp": PYRAMID_SPP, "resolution": [64, 48],
                   "channel_means": means}, f, indent=1)
    print(json.dumps(means))
