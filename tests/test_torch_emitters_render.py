"""The lights end to end, in both packages and both wavefronts.

`small-lights` (tungsten_tpu_torch/synth.py: the `small` scene with an
emissive sphere, disk (30-degree cone) and cylinder, a constant env, a cap
before the sky, the sky, a cap after it and a point light) and `small` with
its sky unsampled (`"sample": false`: escapes add the sky on every lane,
NEE has no light to choose) are flattened by both packages on the numpy BVH
build. The JAX side runs as its own tests run it on the CPU, the port runs
its twins (test_torch_lockstep_area.py says how):

  * render_flat(wavefront="regen") and (wavefront="lockstep") against the
    JAX package's render with the same argument: channel means within 2e-3
    relative, >= 98% of pixels within 1e-3 + 1e-3 |ref|;
  * one lockstep pass of small-lights lane by lane, at the same bars;
  * NEE chooses every light row of small-lights in each render
    (`count_light_choices`): each light kind is sampled;
  * tests/data/torch_port_lights_ref.json holds the JAX renders' means of
    small-lights for the check on the card.
"""
import json

import pytest
import torch

from test_torch_lockstep_area import (check_image, check_lane_by_lane,  # noqa: F401
                                      check_means_file, jax_case, one_torch_thread)

SIZE = "small-lights"
KINDS = {"sphere", "disk", "cylinder", "env", "cap", "point"}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """small-lights in both packages, the JAX package's results, and the
    port's renders in both wavefronts with the light rows NEE chose."""
    from tungsten_tpu_torch.integrators.path_tracer import count_light_choices
    from tungsten_tpu_torch.renderer.render import render_flat

    c = jax_case(SIZE, tmp_path_factory)
    c["port"], c["chosen"] = {}, {}
    for wavefront in ("regen", "lockstep"):
        with count_light_choices(torch.device("cpu")) as chosen:
            c["port"][wavefront] = render_flat(c["scene"], seed=c["seed"], wavefront=wavefront)
        c["chosen"][wavefront] = chosen
    return c


@pytest.mark.parametrize("wavefront", ["regen", "lockstep"])
def test_render_matches_jax(case, wavefront):
    img = case["port"][wavefront]
    assert img.shape == (48, 64, 3)
    check_image(img, case[wavefront], f"{SIZE} {wavefront}")


def test_lockstep_pass_matches_jax_lane_by_lane(case):
    check_lane_by_lane(case, SIZE)


@pytest.mark.parametrize("wavefront", ["regen", "lockstep"])
def test_every_light_kind_is_chosen(case, wavefront):
    from tungsten_tpu_torch.models.primitives.lights import light_kinds

    chosen = case["chosen"][wavefront]
    kinds = light_kinds(case["scene"])
    assert set(chosen) == set(range(len(kinds))), chosen
    assert {kinds[i] for i in chosen} == KINDS
    assert min(chosen.values()) >= 10, chosen


def test_reference_means_file_matches(case):
    check_means_file(case, SIZE)


@pytest.fixture(scope="module")
def unsampled(tmp_path_factory):
    """`small` with an unsampled sky, in both packages."""
    import numpy as np

    import tungsten_tpu.accel.bvh as jbvh
    import tungsten_tpu_torch.accel.bvh as tbvh
    from tungsten_tpu.renderer.render import DEFAULT_SEED, render_flat as jrender
    from tungsten_tpu.scene.flatten import flatten_scene as jflatten
    from tungsten_tpu.scene.load import load_scene as jload
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    mp = pytest.MonkeyPatch()
    mp.setattr(jbvh, "_NATIVE", False)
    mp.setattr(tbvh, "_NATIVE", False)
    mp.setattr(jbvh, "_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    path = synth.write_scene(str(tmp_path_factory.mktemp("unsampled")), "small")
    with open(path) as f:
        doc = json.load(f)
    sky = [p for p in doc["primitives"] if p["type"] == "infinite_sphere"]
    assert len(sky) == 1
    sky[0]["sample"] = False
    with open(path, "w") as f:
        json.dump(doc, f)
    js = jflatten(jload(path))
    out = dict(scene=flatten_scene(load_scene(path), torch.device("cpu")), seed=DEFAULT_SEED,
               **{w: np.asarray(jrender(js, seed=DEFAULT_SEED, wavefront=w))
                  for w in ("regen", "lockstep")})
    mp.undo()
    return out


@pytest.mark.parametrize("wavefront", ["regen", "lockstep"])
def test_unsampled_env_matches_jax(unsampled, wavefront):
    from tungsten_tpu_torch.renderer.render import render_flat

    scene = unsampled["scene"]
    assert scene.meta.n_lights == 0 and scene.meta.env_light_idx == (-1,)
    img = render_flat(scene, seed=unsampled["seed"], wavefront=wavefront)
    check_image(img, unsampled[wavefront], f"small, unsampled sky, {wavefront}")
