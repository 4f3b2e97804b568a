"""The coated, mixed and plain surfaces end to end: `small-coat` in both
packages and both wavefronts.

`small-coat` (tungsten_tpu_torch/synth.py) is the materialtest-like scene
with the ball as a smooth_coat over rough_conductor Cu, an oren_nayar floor
(checker roughness), the cube as a mixed lambert / phong (checker ratio),
three orbs (a rough_coat over lambert with a checker roughness, a phong, a
diffuse_transmission), the sky and one emissive quad. Both packages flatten
it on the numpy BVH build; a mixed material is present, so neither builds
`gpack3` and every nested call gathers its substrate's row by index. The
JAX side runs as its own tests run it on the CPU, the port runs its twins
(test_torch_lockstep_area.py says how).

  * render_flat(wavefront="regen") and (wavefront="lockstep") against the
    JAX package's render with the same argument: channel means within 2e-3
    relative, >= 98% of pixels within 1e-3 + 1e-3 |ref| (the bars of
    test_torch_render.py);
  * one lockstep pass lane by lane, at the same bars;
  * every BSDF type of the scene is hit by camera paths in each render
    (`count_bsdf_hits`, which counts a wrapper's vertex under the wrapper);
  * tests/data/torch_port_coat_ref.json holds the JAX renders' means for
    the check on the card.
"""
import pytest
import torch

from test_torch_lockstep_area import (check_image, check_lane_by_lane,  # noqa: F401
                                      check_means_file, jax_case, one_torch_thread)

SIZE = "small-coat"
# the scene's shaded BSDF types, with the JAX package's ids (the light quad
# is lambert; the Cu, the lambert and the phong under the wrappers are
# substrates, shaded through them)
TYPES = {"lambert": 0, "smooth_coat": 4, "oren_nayar": 5, "phong": 6, "mixed": 15,
         "diffuse_transmission": 16, "rough_coat": 17}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The scene in both packages, the JAX package's results, and the port's
    renders in both wavefronts with their per-type hit counts."""
    from tungsten_tpu_torch.integrators.path_tracer import count_bsdf_hits
    from tungsten_tpu_torch.renderer.render import render_flat

    c = jax_case(SIZE, tmp_path_factory)
    c["port"], c["hits"] = {}, {}
    for wavefront in ("regen", "lockstep"):
        with count_bsdf_hits(torch.device("cpu")) as hits:
            c["port"][wavefront] = render_flat(c["scene"], seed=c["seed"], wavefront=wavefront)
        c["hits"][wavefront] = hits
    return c


def test_scene_carries_the_new_types(case):
    """No forward lobe, a mixed material and so no gpack3; the substrates'
    types are present in the table for the nested calls."""
    scene = case["scene"]
    assert not scene.meta.has_forward and scene.materials.gpack3 is None
    assert set(scene.materials.present) == set(TYPES.values()) | {3}  # Cu under the coat


@pytest.mark.parametrize("wavefront", ["regen", "lockstep"])
def test_render_matches_jax(case, wavefront):
    img = case["port"][wavefront]
    assert img.shape == (48, 64, 3)
    check_image(img, case[wavefront], f"{SIZE} {wavefront}")


def test_lockstep_pass_matches_jax_lane_by_lane(case):
    check_lane_by_lane(case, SIZE)


@pytest.mark.parametrize("wavefront", ["regen", "lockstep"])
def test_every_bsdf_type_is_hit(case, wavefront):
    """Camera paths reach each BSDF type of the scene; no other type."""
    from tungsten_tpu_torch.models.bsdfs.dispatch import type_name

    hits = case["hits"][wavefront]
    assert set(hits) == set(TYPES.values()), hits
    assert {type_name(t) for t in hits} == set(TYPES)
    assert min(hits.values()) >= 100, hits


def test_reference_means_file_matches(case):
    check_means_file(case, SIZE)
