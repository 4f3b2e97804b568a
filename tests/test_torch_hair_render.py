"""The curves and the fiber BCSDFs end to end: `small-hair` in both packages
and both wavefronts; and the helpers of test_torch_mc_render.py.

`small-hair` (tungsten_tpu_torch/synth.py) is the small ball and checker
floor with 64 curly strands on the ball, tessellated into tubes, split over
three curves prims (hair, lambertian_fiber, rough_wire), lit by a skydome
alone. Both packages flatten it on the numpy BVH build; the JAX side runs as
its own tests run it on the CPU, the port runs its twins
(test_torch_lockstep_area.py says how).

  * render_flat(wavefront="regen") and (wavefront="lockstep") against the
    JAX package's render with the same argument: channel means within 2e-3
    relative, >= 98% of pixels within 1e-3 + 1e-3 |ref| (check_image);
  * one lockstep pass lane by lane, at the same bars;
  * camera paths hit every BSDF type of the scene, the three fibers among
    them (`count_bsdf_hits`);
  * tests/data/torch_port_fiber_ref.json holds the JAX renders' means of
    small-hair and small-mc for the check on the card;
    `PYTHONPATH=. python tests/test_torch_hair_render.py` writes it anew.
"""
import json
import os

import numpy as np
import pytest
import torch

from test_torch_lockstep_area import (DATA, check_image, check_lane_by_lane,  # noqa: F401
                                      jax_case, one_torch_thread)

SIZE = "small-hair"
WAVEFRONTS = ("regen", "lockstep")
REF = os.path.join(DATA, "torch_port_fiber_ref.json")
# each scene's BSDF types, with the JAX package's ids
TYPES = {"small-hair": {"lambert": 0, "rough_conductor": 3, "hair": 18, "lambertian_fiber": 19,
                        "rough_wire": 20},
         "small-mc": {"lambert": 0}}


def render_case(size, tmp_path_factory):
    """jax_case's scene and JAX results, and the port's renders in both
    wavefronts with their per-type hit counts."""
    from tungsten_tpu_torch.integrators.path_tracer import count_bsdf_hits
    from tungsten_tpu_torch.renderer.render import render_flat

    c = jax_case(size, tmp_path_factory)
    c["port"], c["hits"] = {}, {}
    for wavefront in WAVEFRONTS:
        with count_bsdf_hits(torch.device("cpu")) as hits:
            c["port"][wavefront] = render_flat(c["scene"], seed=c["seed"], wavefront=wavefront)
        c["hits"][wavefront] = hits
    return c


def means_of(c, size):
    return {"scene": size, "seed": c["seed"], "spp": c["scene"].meta.spp,
            "resolution": [c["scene"].meta.res_x, c["scene"].meta.res_y],
            "channel_means": {w: c[w].reshape(-1, 3).astype(np.float64).mean(0).tolist()
                              for w in WAVEFRONTS}}


def check_hits(c, size, least):
    """Camera paths reach each BSDF type of the scene, each at least
    `least` times a render; no other type."""
    from tungsten_tpu_torch.models.bsdfs.dispatch import type_name

    for wavefront, hits in c["hits"].items():
        assert set(hits) == set(TYPES[size].values()), (wavefront, hits)
        assert {type_name(t) for t in hits} == set(TYPES[size])
        assert min(hits.values()) >= least, (wavefront, hits)


def check_reference(c, size):
    """The JSON file's means are the JAX renders' (rtol 1e-4: another CPU's
    float rounding in XLA, far below the card's 5e-3)."""
    with open(REF) as f:
        data = json.load(f)[size]
    want = means_of(c, size)
    assert {k: data[k] for k in ("scene", "seed", "spp", "resolution")} == {
        k: want[k] for k in ("scene", "seed", "spp", "resolution")}
    assert data["spp"] == 4 and data["resolution"] == [64, 48]
    for w in WAVEFRONTS:
        np.testing.assert_allclose(data["channel_means"][w], want["channel_means"][w],
                                   rtol=1e-4, err_msg=w)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return render_case(SIZE, tmp_path_factory)


@pytest.mark.parametrize("wavefront", WAVEFRONTS)
def test_render_matches_jax(case, wavefront):
    img = case["port"][wavefront]
    assert img.shape == (48, 64, 3)
    check_image(img, case[wavefront], f"{SIZE} {wavefront}")


def test_lockstep_pass_matches_jax_lane_by_lane(case):
    check_lane_by_lane(case, SIZE, lit_share=0.5)


def test_every_bsdf_type_is_hit(case):
    check_hits(case, SIZE, least=200)


def test_reference_means_file_matches(case):
    check_reference(case, SIZE)


if __name__ == "__main__":  # write tests/data/torch_port_fiber_ref.json anew
    import pathlib
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")

    class _Dirs:  # tmp_path_factory's mktemp under one temporary directory
        def __init__(self, root):
            self.root, self.n = root, 0

        def mktemp(self, name):
            self.n += 1
            path = os.path.join(self.root, f"{name}{self.n}")
            os.makedirs(path)
            return pathlib.Path(path)

    with tempfile.TemporaryDirectory() as tmp:
        dirs = _Dirs(tmp)
        data = {size: means_of(jax_case(size, dirs), size) for size in ("small-hair", "small-mc")}
    with open(REF, "w") as f:
        json.dump(data, f, indent=1)
    print(REF)
