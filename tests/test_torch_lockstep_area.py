"""The lockstep path tracer and the area lights, end to end, in both packages:
the `small-area` renders, and the helpers of the other three files.

The cases are split over two files, one per scene, so that pytest-xdist's
--dist loadfile runs them on two workers: this file and
test_torch_lockstep_box.py, which takes its checks from here.

`small-area` (area lights beside the sky) and `small-box` (a closed box lit
by one emissive quad, no env) are flattened by both packages on the numpy BVH
build. The JAX side runs as its own tests run it on the CPU (the binary BVH
walk `intersect_bvh`, exact f32); the port runs its twins: closest hit
through the fast BVH8 walk with its exact repair, shadow rays through the
exact walk's latch.

  * one lockstep pass (`trace_batch` with one pass, which is `trace_pass` ->
    `_trace_pass_fast` under the pass seed) lane by lane: >= 98% of lanes
    within 1e-3 + 1e-3 |ref|, per-channel means within 2e-3 relative. A
    single 4 spp render's mean is dominated by a handful of bright lanes,
    so a path whose hit flips between the two walks may move it; the bar is
    the render tests' own;
  * render_flat(wavefront="lockstep") and render_flat(wavefront="regen")
    against the JAX render_flat with the same argument, same bars per pixel;
  * the lockstep render on the other intersector routes (no pbvh8 and no
    gbvh: K4's any-hit walk for the shadow rays, K5 for the closest hits;
    no BVH pack: K2 for both) against the same JAX render;
  * the port's lockstep and regen renders are two streams of one estimator:
    at 16 spp (49,152 paths a render; the twins' cost on the CPU grows with
    the number of passes, so not 64) their per-channel means agree within 5%;
  * tests/data/torch_port_area_ref.json and torch_port_box_ref.json hold the
    JAX package's per-channel means, for the check on a machine without JAX.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tungsten_tpu_torch.ops import bvh8

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
REFS = {"small-area": "torch_port_area_ref.json", "small-box": "torch_port_box_ref.json",
        "small-interior": "torch_port_interior_ref.json",
        "small-coat": "torch_port_coat_ref.json", "small-cutout": "torch_port_cutout_ref.json",
        "small-lights": "torch_port_lights_ref.json"}
SIZES = ["small-area"]  # this file's scene


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while the module runs. The port's CPU twins issue
    many small torch operations; when pytest-xdist runs several such files
    at once, each worker's intra-op threads share the cores with the other
    workers' and wait on one another far longer than they compute (these
    lockstep tests, split over four files, took over 20 minutes on 4 workers
    with torch's default threads and 2.5 minutes with one thread each, on an
    8-core machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_case(size, tmp_path_factory, wavefronts=("lockstep", "regen")):
    """`size` in both packages on the numpy BVH build: {"scene" (the port's,
    on the CPU), "seed", and the JAX package's results: "one_pass" (one
    lockstep pass, trace_batch), and render_flat with each of `wavefronts`
    under its name}."""
    import tungsten_tpu.accel.bvh as jbvh
    import tungsten_tpu_torch.accel.bvh as tbvh
    from tungsten_tpu.integrators.path_tracer import trace_batch as jtrace_batch
    from tungsten_tpu.renderer.render import DEFAULT_SEED, _lane_arrays as jlanes
    from tungsten_tpu.renderer.render import render_flat as jrender
    from tungsten_tpu.scene.flatten import flatten_scene as jflatten
    from tungsten_tpu.scene.load import load_scene as jload
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    mp = pytest.MonkeyPatch()
    mp.setattr(jbvh, "_NATIVE", False)
    mp.setattr(tbvh, "_NATIVE", False)
    mp.setattr(jbvh, "_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    path = synth.write_scene(str(tmp_path_factory.mktemp(size)), size)
    js = jflatten(jload(path))
    px, py, lane, _ = jlanes(js.meta, 1)
    seed = jnp.array([DEFAULT_SEED & 0xFFFFFFFF, 0], jnp.uint32)
    out = dict(
        scene=flatten_scene(load_scene(path), torch.device("cpu")), seed=DEFAULT_SEED,
        one_pass=np.asarray(jtrace_batch(js, seed, jnp.asarray(lane), jnp.asarray(px),
                                         jnp.asarray(py), jnp.uint32(2), n_passes=1)),
        # passes_per_batch=1: the lockstep render reuses the one-pass compile
        **{w: np.asarray(jrender(js, seed=DEFAULT_SEED, wavefront=w, passes_per_batch=1)
                         if w == "lockstep" else jrender(js, seed=DEFAULT_SEED, wavefront=w))
           for w in wavefronts})
    mp.undo()
    return out


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """{size: the scene in both packages and the JAX package's results}."""
    return {size: jax_case(size, tmp_path_factory) for size in SIZES}


def check_image(img, ref, label):
    assert img.shape == ref.shape
    assert np.isfinite(img).all() and (img >= 0).all()
    close = np.all(np.abs(img - ref) <= 1e-3 + 1e-3 * np.abs(ref), axis=-1)
    assert close.mean() >= 0.98, f"{label}: {close.mean():.4f} of lanes within the bar"
    np.testing.assert_allclose(img.reshape(-1, 3).mean(0), ref.reshape(-1, 3).mean(0),
                               rtol=2e-3, err_msg=label)


def check_lane_by_lane(c, size, lit_share=0.5):
    """One lockstep pass of the port (trace_batch with one pass) against the
    JAX package's, lane by lane; the launch counts of the walks; more than
    `lit_share` of the lanes carry light; and trace_batch's pass is
    _trace_pass_fast under the pass seed."""
    from tungsten_tpu_torch.integrators.path_tracer import _trace_pass_fast, trace_batch
    from tungsten_tpu_torch.renderer.render import _lane_arrays

    px, py, _ = (torch.as_tensor(a) for a in _lane_arrays(c["scene"].meta))
    lane = torch.arange(px.shape[0])
    seed = (c["seed"] & 0xFFFFFFFF, 0)
    fast0, exact0 = bvh8.walk_fast_twin.launches, bvh8.walk_twin.launches
    rad = trace_batch(c["scene"], seed, lane, px, py, 2, n_passes=1).numpy()
    n_fast = bvh8.walk_fast_twin.launches - fast0
    n_exact = bvh8.walk_twin.launches - exact0
    # the camera walk plus one 2N walk per bounce run go through the fast
    # walk; each is followed by its repair launch, each bounce by a shadow walk
    bounces = n_fast - 1
    assert 1 <= bounces <= c["scene"].meta.max_bounces
    assert n_exact == n_fast + bounces
    check_image(rad, c["one_pass"], f"{size} one pass")
    assert (rad.sum(-1) > 0).mean() > lit_share
    # trace_batch's pass seed is (s0, s1 + pass_start + i)
    direct = _trace_pass_fast(c["scene"], (seed[0], 2), lane, px, py).numpy()
    np.testing.assert_array_equal(direct, rad)


@pytest.mark.parametrize("size", SIZES)
def test_lockstep_pass_matches_jax_lane_by_lane(cases, size):
    check_lane_by_lane(cases[size], size)


def check_render(c, size, wavefront):
    """render_flat with `wavefront` against the JAX package's render."""
    from tungsten_tpu_torch.renderer.render import render_flat

    img = render_flat(c["scene"], seed=c["seed"], wavefront=wavefront)
    assert img.shape == (48, 64, 3)
    check_image(img, c[wavefront], f"{size} {wavefront}")


def check_wavefronts_agree(c):
    """Two streams of one estimator: the means agree within Monte-Carlo
    noise (a loose 5%)."""
    from tungsten_tpu_torch.renderer.render import render_flat

    means = [render_flat(c["scene"], spp=16, seed=7, wavefront=w).reshape(-1, 3).mean(0)
             for w in ("lockstep", "regen")]
    np.testing.assert_allclose(means[0], means[1], rtol=5e-2)


@pytest.mark.parametrize("wavefront", ["lockstep", "regen"])
@pytest.mark.parametrize("size", SIZES)
def test_render_matches_jax(cases, size, wavefront):
    check_render(cases[size], size, wavefront)


@pytest.mark.parametrize("route", ["K5", "K2"])
def test_lockstep_on_the_other_routes(cases, route):
    """Without pbvh8 and gbvh (K1, which tests/test_torch_gather_bvh.py
    drives) the shadow rays take K4's any-hit walk and the closest hits K5;
    without any BVH pack both take K2 (closest hit's prim >= 0). Each still
    matches the JAX lockstep render."""
    import dataclasses

    from tungsten_tpu_torch.ops import bvh, bvh2, intersect_stream
    from tungsten_tpu_torch.renderer.render import render_flat

    c = cases["small-area"]
    dropped = {"K5": ("pbvh8", "gbvh"), "K2": ("pbvh8", "gbvh", "pbvh3", "pbvh")}[route]
    scene = dataclasses.replace(c["scene"], **dict.fromkeys(dropped))

    def counts():
        return (bvh8.walk_twin.launches + bvh8.walk_fast_twin.launches,
                bvh2.walk3_twin.launches["any"], bvh.walk_packet_twin.launches["v2"],
                intersect_stream.stream_twin.launches)

    before = counts()
    img = render_flat(scene, seed=c["seed"], wavefront="lockstep")
    k3, k4_any, k5, k2 = (a - b for a, b in zip(counts(), before))
    assert k3 == 0
    if route == "K5":
        assert k4_any > 0 and k5 > 0 and k2 == 0
    else:
        assert k4_any == 0 and k5 == 0 and k2 > 0
    check_image(img, c["lockstep"], f"small-area lockstep on {route}")


@pytest.mark.parametrize("size", SIZES)
def test_lockstep_and_regen_agree(cases, size):
    check_wavefronts_agree(cases[size])


def check_means_file(c, size, wavefronts=("lockstep", "regen")):
    """The JSON file carries the JAX renders' means for the check on the
    card; rtol 1e-4 leaves room for another CPU's float rounding in XLA, far
    below the 5e-3 that check applies."""
    with open(os.path.join(DATA, REFS[size])) as f:
        data = json.load(f)
    assert data["scene"] == size and data["seed"] == c["seed"]
    assert data["spp"] == 4 and data["resolution"] == [64, 48]
    assert sorted(data["channel_means"]) == sorted(wavefronts)
    for w in wavefronts:
        np.testing.assert_allclose(data["channel_means"][w], c[w].reshape(-1, 3).mean(0),
                                   rtol=1e-4, err_msg=w)


@pytest.mark.parametrize("size", SIZES)
def test_reference_means_files_match(cases, size):
    check_means_file(cases[size], size)


def test_wavefront_argument():
    """auto is regen (the port has no device mesh) unless a material has a
    forward lobe, and then lockstep (render.py:149); an unknown name
    raises; trace_pass dispatches a scene with media as any other: the
    fast branch without forward lobes, the crossing-walk branch with them."""
    from tungsten_tpu_torch.integrators import path_tracer as pt
    from tungsten_tpu_torch.renderer import render

    class Meta:
        res_x, res_y, spp = 4, 4, 1
        has_forward = has_media = False
        aovs = ()

    class Scene:
        meta = Meta()
        shade_pack = torch.zeros(1)

    fwd = Scene()
    fwd.meta = type("M", (Meta,), {"has_forward": True})()
    calls = []
    mp = pytest.MonkeyPatch()
    mp.setattr(render, "trace_regen_batch",
               lambda scene, seed, px, py, pix, done, n_passes: calls.append("regen")
               or torch.zeros((16, 3)))
    mp.setattr(render, "trace_batch",
               lambda scene, seed, lane, px, py, done, n_passes: calls.append("lockstep")
               or torch.zeros((16, 3)))
    for w in ("auto", "regen", "lockstep"):
        render.render_flat(Scene(), wavefront=w)
    render.render_flat(fwd, wavefront="auto")
    mp.undo()
    assert calls == ["regen", "regen", "lockstep", "lockstep"]
    with pytest.raises(ValueError):
        render.render_flat(Scene(), wavefront="tiles")
    foggy = Scene()
    foggy.meta = type("M", (Meta,), {"has_media": True})()
    foggy_fwd = Scene()
    foggy_fwd.meta = type("M", (Meta,), {"has_media": True, "has_forward": True})()
    branches = []
    mp = pytest.MonkeyPatch()
    mp.setattr(pt, "_trace_pass_fast", lambda *a: branches.append("fast"))
    mp.setattr(pt, "_trace_pass_forward", lambda *a: branches.append("forward"))
    pt.trace_pass(foggy, (0, 0), None, None, None)
    pt.trace_pass(foggy_fwd, (0, 0), None, None, None)
    mp.undo()
    assert branches == ["fast", "forward"]
