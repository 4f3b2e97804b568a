"""The interior cell's surfaces end to end: `small-interior` in both
packages and both wavefronts.

`small-interior` (tungsten_tpu_torch/synth.py) is a closed room with one
window: a smooth dielectric ball, a rough_dielectric pane, a plastic and a
rough_plastic sphere (its roughness a checker texture), a conductor sphere,
a mirror quad, a ceiling light whose quad has the null BSDF, lambert walls
and floor, and an .hdr sky (written by the port's RGBE writer, read by the
JAX package through OpenCV) seen through the window. Both packages flatten
it on the numpy BVH build; the JAX side runs as its own tests run it on the
CPU, the port runs its twins (test_torch_lockstep_area.py says how).

  * render_flat(wavefront="regen") and (wavefront="lockstep") against the
    JAX package's render with the same argument: channel means within 2e-3
    relative, >= 98% of pixels within 1e-3 + 1e-3 |ref| (the bars of
    test_torch_render.py);
  * one lockstep pass lane by lane, at the same bars;
  * every BSDF type of the scene is hit by camera paths in each render
    (`count_bsdf_hits`), the seven new ones among them;
  * tests/data/torch_port_interior_ref.json holds the JAX renders' means
    for the check on the card.
"""
import pytest
import torch

from test_torch_lockstep_area import (check_image, check_lane_by_lane,  # noqa: F401
                                      check_means_file, jax_case, one_torch_thread)

SIZE = "small-interior"
# the scene's BSDF types, with the JAX package's ids: lambert 0, null 1,
# mirror 2, dielectric 7, rough_dielectric 8, conductor 9, plastic 10,
# rough_plastic 11
TYPES = {"lambert": 0, "null": 1, "mirror": 2, "dielectric": 7, "rough_dielectric": 8,
         "conductor": 9, "plastic": 10, "rough_plastic": 11}


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


@pytest.mark.parametrize("wavefront", ["regen", "lockstep"])
def test_render_matches_jax(case, wavefront):
    img = case["port"][wavefront]
    assert img.shape == (48, 64, 3)
    check_image(img, case[wavefront], f"{SIZE} {wavefront}")


def test_lockstep_pass_matches_jax_lane_by_lane(case):
    # a room lit through a window and by one small fixture: one sample of a
    # lane finds light less often than in the open scenes
    check_lane_by_lane(case, SIZE, lit_share=0.3)


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
