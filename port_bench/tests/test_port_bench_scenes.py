"""The benchmark's frozen scene writer against the port's synth.py: the
small files byte for byte, the full-size scene documents key for key."""
import filecmp
import json
import os

import pytest

import scenes
from harness import spec
from tungsten_tpu_torch import synth

SMALL_SCENE = {"sphere_segments": [50, 20], "sky": [128, 64], "resolution": [64, 48],
               "spp": 4, "max_bounces": 6}
CASES = [  # (our kind and sizes, our integrator, synth's size, synth's variant)
    ({"kind": "materialtest", **SMALL_SCENE}, "path_tracer", "small", None),
    ({"kind": "box", "caustic": True, "photon_count": 1 << 14, **SMALL_SCENE},
     "path_tracer", "small-box", "path_tracer+caustic"),
    ({"kind": "box", "caustic": True, "photon_count": 1 << 14, **SMALL_SCENE},
     "progressive_photon_map", "small-box", "progressive_photon_map+caustic"),
]


@pytest.mark.parametrize("scene,integ,size,variant", CASES, ids=lambda c: str(c)[:24])
def test_small_files_byte_for_byte(tmp_path, scene, integ, size, variant):
    scene = dict(scene)
    if scene["kind"] == "box":
        del scene["sky"]
    ours = scenes.write_scene(str(tmp_path / "ours"), scene, integ)
    theirs = synth.write_scene(str(tmp_path / "theirs"), size, variant)
    a, b = os.path.dirname(ours), os.path.dirname(theirs)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False), name


@pytest.mark.parametrize("cell,size,variant", [
    ("materialtest-pt", "materialtest-synth", None),
    ("box-caustic-pt", "box-synth", "path_tracer+caustic"),
    ("box-caustic-sppm", "box-synth", "progressive_photon_map+caustic"),
])
def test_full_size_documents(cell, size, variant):
    c = spec.load_cell(cell)
    ours = scenes.scene_dict(c.config, c.traffic["integrator"])
    assert json.dumps(ours, sort_keys=True) == json.dumps(synth.scene_dict(size, variant),
                                                          sort_keys=True)
    nu, nv, sw, sh, res, spp, max_b = synth.SIZES[size]
    sc = c.config
    assert sc["sphere_segments"] == [nu, nv] and sc["resolution"] == list(res)
    assert sc["spp"] == spp and sc["max_bounces"] == max_b
    if sc["kind"] == "materialtest":
        assert sc["sky"] == [sw, sh]
    else:
        assert sc["photon_count"] == synth.PHOTON_COUNT[size]
