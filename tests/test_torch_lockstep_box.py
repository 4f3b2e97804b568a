"""The lockstep path tracer, end to end, in both packages: `small-box` (a
closed box lit by one emissive quad, no env), one pass lane by lane and the
renders, with the checks and bars of test_torch_lockstep_area.py, which
holds the helpers and says why the cases are split over two files.
"""
import pytest

from test_torch_lockstep_area import (check_lane_by_lane, check_means_file,  # noqa: F401
                                      check_render, check_wavefronts_agree, jax_case,
                                      one_torch_thread)

SIZES = ["small-box"]  # this file's scene


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """{size: the scene in both packages and the JAX package's results}."""
    return {size: jax_case(size, tmp_path_factory) for size in SIZES}


@pytest.mark.parametrize("size", SIZES)
def test_lockstep_pass_matches_jax_lane_by_lane(cases, size):
    check_lane_by_lane(cases[size], size)


@pytest.mark.parametrize("wavefront", ["lockstep", "regen"])
@pytest.mark.parametrize("size", SIZES)
def test_render_matches_jax(cases, size, wavefront):
    check_render(cases[size], size, wavefront)


@pytest.mark.parametrize("size", SIZES)
def test_lockstep_and_regen_agree(cases, size):
    check_wavefronts_agree(cases[size])


@pytest.mark.parametrize("size", SIZES)
def test_reference_means_files_match(cases, size):
    check_means_file(cases[size], size)
