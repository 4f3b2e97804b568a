"""minecraft_map with a resource pack, an IES-profiled emissive sphere and
a skydome end to end: `small-mc` in both packages and both wavefronts.

`small-mc` (tungsten_tpu_torch/synth.py) is one chunk of terrain (stone,
dirt, grass, two glowstone lamps) written with the port's Anvil writer,
textured by a resource pack written in code (glowstone emits through its
emitters.json), an analytic sphere whose emission is an IES profile and a
skydome. Both packages flatten it on the numpy BVH build; the bars and the
reference file are test_torch_hair_render.py's.
"""
import pytest

from test_torch_hair_render import (WAVEFRONTS, check_hits, check_image, check_lane_by_lane,
                                    check_reference, one_torch_thread,  # noqa: F401
                                    render_case)

SIZE = "small-mc"


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return render_case(SIZE, tmp_path_factory)


@pytest.mark.parametrize("wavefront", WAVEFRONTS)
def test_render_matches_jax(case, wavefront):
    img = case["port"][wavefront]
    assert img.shape == (48, 64, 3)
    check_image(img, case[wavefront], f"{SIZE} {wavefront}")


def test_lockstep_pass_matches_jax_lane_by_lane(case):
    # the skydome is black below the horizon, and the camera sees past the
    # chunk's edge: one sample of a lane carries light less often than in the
    # open scenes (~39%)
    check_lane_by_lane(case, SIZE, lit_share=0.3)


def test_every_bsdf_type_is_hit(case):
    check_hits(case, SIZE, least=1000)


def test_the_lights_are_the_glowstone_groups_the_sphere_and_the_sky(case):
    """Five glowstone groups (one per exposed face direction), the IES
    sphere and the skydome; the sphere's emission is a clamped bitmap."""
    scene = case["scene"]
    assert scene.lights.apx_kind == ("none",) * 5 + ("sphere", "const")
    tex = scene.textures.tpack[scene.lights.tex[5]]
    assert int(tex[-1]) == 2 and float(tex[3]) == 1.0


def test_reference_means_file_matches(case):
    check_reference(case, SIZE)
