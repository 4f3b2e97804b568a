"""SPPM in the fog in both packages, on the CPU: `render_sppm` of small-box
fog (test_torch_sppm_media.py's scene, at FOG_RES with FOG_PHOTONS photons
an iteration) in the four volume photon types against the JAX renders at
equal seed.

  * points, beams, planes and planes_1d (SPP iterations) with the render
    tests' bars (check_image of test_torch_lockstep_area.py), the overflow
    totals within 0.1%;
  * beams', planes' and planes_1d's median ratio to points (the JAX tests'
    measure, tests/test_path_tracer.py:197-288) within 2% of the JAX
    package's on the same scene and seed;
  * tests/data/torch_port_sppm_ref.json's fog means, overflows and ratios
    equal the JAX renders'.
"""
import json

import numpy as np
import pytest

from test_torch_light_tracer import SEED
from test_torch_lockstep_area import check_image, one_torch_thread  # noqa: F401
from test_torch_sppm import (FOG_RES, REF, SPP, fog_median_ratio, jax_render, port_render,
                             sppm_scenes)

VARIANT = "progressive_photon_map+fog"
FOG_KEYS = ("fog-points", "fog-beams", "fog-planes", "fog-planes_1d")


@pytest.fixture(scope="module")
def fog(tmp_path_factory):
    return sppm_scenes(VARIANT, str(tmp_path_factory.mktemp("fog")))


@pytest.fixture(scope="module")
def renders(fog):
    return {key: jax_render(fog[1], key) for key in FOG_KEYS}


@pytest.fixture(scope="module")
def port_renders(fog):
    return {key: port_render(fog[0], key) for key in FOG_KEYS}


@pytest.mark.parametrize("key", FOG_KEYS)
def test_render_sppm_fog_matches_jax(renders, port_renders, key):
    img, ovf = port_renders[key]
    want, want_ovf = renders[key]
    assert img.shape == (FOG_RES[1], FOG_RES[0], 3)
    check_image(img, want, f"small-box {key}")
    assert abs(ovf - want_ovf) <= 1e-3 * want_ovf


def test_fog_modes_ratio_to_points_as_jax(renders, port_renders):
    """Beams, planes and planes_1d against points by the JAX tests' median
    ratio: the port's within 2% of the JAX package's own ratio on the same
    scene and seed (chip_smoke's bar where the JAX package misses 0.2)."""
    for key in FOG_KEYS[1:]:
        got = fog_median_ratio(port_renders[key][0], port_renders["fog-points"][0])
        want = fog_median_ratio(renders[key][0], renders["fog-points"][0])
        np.testing.assert_allclose(got, want, rtol=0.02, err_msg=key)


def test_reference_means_file_matches(renders):
    with open(REF) as f:
        data = json.load(f)
    assert data["seed"] == SEED and data["spp"] == SPP
    for key, (img, ovf) in renders.items():
        np.testing.assert_allclose(data["channel_means"][key], img.reshape(-1, 3).mean(0),
                                   rtol=1e-4, err_msg=key)
        assert data["overflow"][key] == ovf
        if key != "fog-points":
            np.testing.assert_allclose(data["fog_median_ratio"][key], fog_median_ratio(
                img, renders["fog-points"][0]), rtol=1e-4, err_msg=key)
