"""The bidirectional path tracer in both packages on small-box (a closed box
lit by one emissive quad: neither integrator takes an env light), on the
numpy BVH build, on the CPU.

  * one `trace_bdpt_pass` (pass 0's seed) against the JAX package's: the
    eye radiance lane by lane and the splat buffer per pixel (divided by the
    number of paths), with the render tests' bars (check_image of
    test_torch_lockstep_area.py: >= 98% within 1e-3 + 1e-3 |ref|, channel
    means within 2e-3 relative); the pass walks K3-fast's and K3's twins;
  * `render_bdpt` at the scene's 4 spp against the JAX render, same bars;
  * `render_bdpt_pyramid` at 2 spp: the same (s, t) keys as the JAX
    package's (26 at K = 7), each image and the render within the bars, the
    stack's sum equal to the render within 1e-5, and the render equal to
    render_bdpt's of the same passes (tests/test_path_tracer.py:411-430);
  * a deep scene (max_bounces 64 under BDPT) gets the JAX package's
    truncation warning and the cap of 16 vertices; an explicit
    bdpt_max_vertices or another integrator gets no warning;
  * tests/data/torch_port_bdpt_ref.json holds these renders' JAX means.
"""
import warnings

import numpy as np
import pytest
import torch

from test_torch_light_tracer import (PYRAMID_SPP, SEED, both_scenes, check_means_file,
                                     jax_bdpt_results)
from test_torch_lockstep_area import check_image, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    ts, js = both_scenes("small-box", None, str(tmp_path_factory.mktemp("small-box")))
    return dict(scene=ts, **jax_bdpt_results(js))


def test_bdpt_pass_matches_jax_lane_by_lane(box):
    from tungsten_tpu_torch.integrators.bdpt import BDPT_PASS_SEED, trace_bdpt_pass
    from tungsten_tpu_torch.ops import bvh8
    from tungsten_tpu_torch.renderer.render import _bdpt_lanes

    ts = box["scene"]
    n = ts.meta.res_x * ts.meta.res_y
    fast, exact = bvh8.walk_fast_twin.launches, bvh8.walk_twin.launches
    eye, splat = trace_bdpt_pass(ts, (SEED, BDPT_PASS_SEED), *_bdpt_lanes(ts.meta, "cpu"))
    assert bvh8.walk_fast_twin.launches > fast and bvh8.walk_twin.launches > exact
    assert (eye.sum(-1) > 0).float().mean() > 0.5 and (splat.sum(-1) > 0).float().mean() > 0.5
    check_image(eye.numpy(), box["bdpt_pass"][0], "small-box BDPT pass, eye")
    check_image(splat.numpy() / n, box["bdpt_pass"][1] / n, "small-box BDPT pass, splat")


def test_render_bdpt_matches_jax(box):
    from tungsten_tpu_torch.renderer.render import render_bdpt

    img = render_bdpt(box["scene"], seed=SEED)
    assert img.shape == (48, 64, 3)
    check_image(img, box["bdpt"], "small-box render_bdpt")


def test_render_bdpt_pyramid_matches_jax_and_sums_to_the_render(box):
    from tungsten_tpu_torch.renderer.render import render_bdpt, render_bdpt_pyramid

    ts = box["scene"]
    img, stack = render_bdpt_pyramid(ts, spp=PYRAMID_SPP, seed=SEED)
    jimg, jstack = box["bdpt_pyramid"]
    assert sorted(stack) == sorted(jstack) and len(stack) == 26
    assert (0, 2) in stack and (2, 1) in stack  # unidirectional and splat families
    for key, im in stack.items():
        check_image(im, jstack[key], f"small-box pyramid {key}")
    check_image(img, jimg, "small-box pyramid render")
    np.testing.assert_allclose(sum(stack.values()), img, atol=1e-5)
    ref = render_bdpt(ts, spp=PYRAMID_SPP, seed=SEED, passes_per_batch=1)
    np.testing.assert_allclose(img, ref, atol=1e-5)


def test_deep_scene_gets_the_truncation_warning(tmp_path):
    """max_bounces 64 under bidirectional_path_tracer: the JAX package's
    warning and a cap of 16; an explicit bdpt_max_vertices, or the path
    tracer, gets none."""
    import json

    from tungsten_tpu.scene.flatten import _bdpt_cap as jcap
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.scene import flatten as tflatten
    from tungsten_tpu_torch.scene.load import load_scene

    path = synth.write_scene(str(tmp_path), "small-box", "bidirectional_path_tracer")
    with open(path) as f:
        doc = json.load(f)
    doc["integrator"]["max_bounces"] = 64
    with open(path, "w") as f:
        json.dump(doc, f)
    with pytest.warns(UserWarning) as got:
        scene = tflatten.flatten_scene(load_scene(path), torch.device("cpu"))
    assert scene.meta.bdpt_max_vertices == 16
    with pytest.warns(UserWarning) as want:
        assert jcap(doc["integrator"]) == 16
    assert [str(w.message) for w in got] == [str(w.message) for w in want]
    assert "capped at 16" in str(got[0].message)
    for integ in ({**doc["integrator"], "bdpt_max_vertices": 20},
                  {**doc["integrator"], "type": "path_tracer"}, {"max_bounces": 6,
                                                                 "type": "light_tracer"}):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert tflatten._bdpt_cap(integ) == jcap(integ)


def test_reference_means_file_matches(box):
    check_means_file(box, "small-box", ("bdpt", "bdpt_pyramid"))
