"""small-media end to end, in both packages, in every wavefront the JAX
package runs it in: fog, cloud and haze here, the forward variant in
test_torch_media_forward.py (which takes its checks from here, so that
pytest-xdist's --dist loadfile runs the two on two workers).

`small-media` (tungsten_tpu_torch/synth.py: `small`'s floor, ball, cube and
sky with a lamp quad, at 64x48, 4 spp, 6 bounces) in four variants: fog (a
homogeneous camera medium, davis transmittance, Henyey-Greenstein), cloud
(a 16^3 voxel medium with an emission grid in an index-matched box), haze
(an exponential camera medium with erlang transmittance, an absorption-only
atmosphere in an analytic sphere given by its pivot) and forward (fog with a
transparency cube and a thinsheet orb: the lockstep forward branch and its
volume NEE). Both packages flatten them on the numpy BVH build; the JAX side
runs as its own tests run it on the CPU, the port its twins (K3's and K6's).

  * fog, haze and forward against the JAX render at equal seed, rendered
    here: channel means within 2e-3 relative, >= 98% of pixels within
    1e-3 + 1e-3 |ref| (check_image of test_torch_lockstep_area.py);
  * cloud against the JAX means in tests/data/torch_port_media_ref.json at
    2e-3. XLA's CPU compile of the JAX cloud render (its exact cell walk
    inlined four times a bounce, the inverse's 24 bisection rounds
    unrolled) ran over 25 minutes and 20 GB without finishing, so
    `python tests/test_torch_media_render.py`, which renders all four
    variants in the JAX package and writes the file, renders the cloud op
    by op (jax.disable_jit), with the walk's backstop cut from 4,096 rounds
    to 64: a ray crosses at most 49 dual cells of the 16^3 grid, and only
    lanes whose grid coordinates are NaN run longer, dead lanes whose NEE
    vertex lies at infinity, whose values the JAX package discards. The
    live variants are held to the file here (rtol 1e-4);
  * the cloud's renders walk its grid through K6's twin (its launch count
    moves); no other variant walks a grid. The longest lane of every walk
    of the cloud's renders takes fewer rounds than the 64 of the reference
    file's backstop (LONGEST_BAR), so that backstop cut no lane whose value
    the render reads: the port walks just those lanes.
"""
import json
import os

import numpy as np
import pytest
import torch

from tungsten_tpu_torch import synth
from test_torch_lockstep_area import DATA, check_image, one_torch_thread  # noqa: F401

SIZE = "small-media"
WAVEFRONTS = {"fog": ("regen", "lockstep"), "cloud": ("regen", "lockstep"),
              "haze": ("regen", "lockstep"), "forward": ("lockstep",)}
LIVE = ("fog", "haze", "forward")  # rendered by the JAX package in the tests
REF = os.path.join(DATA, "torch_port_media_ref.json")
VARIANTS = ("fog", "cloud", "haze")  # this file's
# the rounds of the cloud's longest walk: 49 dual cells across the 16^3
# grid, and a few more rounds of minimum progress near cell corners, well
# under the 64 of the JAX walk that wrote the reference file
LONGEST_BAR = 56


def media_case(variant, tmp_dir, jax_render=True):
    """`variant` of small-media on the numpy BVH build: {"scene" (the
    port's, on the CPU), "seed", and with jax_render the JAX package's
    render_flat under each of its wavefronts (the cloud's op by op, its
    walk's backstop at 64 rounds: the module docstring says why)}."""
    import contextlib

    import jax

    import tungsten_tpu.accel.bvh as jbvh
    import tungsten_tpu.models.grids.grid as jgrid
    import tungsten_tpu_torch.accel.bvh as tbvh
    from tungsten_tpu.renderer.render import DEFAULT_SEED
    from tungsten_tpu.renderer.render import render_flat as jrender
    from tungsten_tpu.scene.flatten import flatten_scene as jflatten
    from tungsten_tpu.scene.load import load_scene as jload
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    mp = pytest.MonkeyPatch()
    mp.setattr(jbvh, "_NATIVE", False)
    mp.setattr(tbvh, "_NATIVE", False)
    mp.setattr(jbvh, "_CACHE_DIR", os.path.join(tmp_dir, "bvh_cache"))
    path = synth.write_scene(tmp_dir, SIZE, variant)
    out = dict(scene=flatten_scene(load_scene(path), torch.device("cpu")), seed=DEFAULT_SEED)
    if jax_render:
        js = jflatten(jload(path))
        eager = contextlib.nullcontext
        if variant == "cloud":
            mp.setattr(jgrid, "_MAX_DDA", 64)
            eager = jax.disable_jit
        for w in WAVEFRONTS[variant]:
            kw = {"passes_per_batch": 1} if w == "lockstep" else {}
            with eager():
                out[w] = np.asarray(jrender(js, seed=DEFAULT_SEED, wavefront=w, **kw))
    mp.undo()
    return out


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    return {v: media_case(v, str(tmp_path_factory.mktemp(v)), jax_render=v in LIVE)
            for v in VARIANTS}


@pytest.fixture(scope="module")
def ref():
    with open(REF) as f:
        data = json.load(f)
    assert data["scene"] == SIZE and data["spp"] == 4 and data["resolution"] == [64, 48]
    assert sorted(data["channel_means"]) == sorted(WAVEFRONTS)
    return data


def check_media_render(cases, ref, variant, wavefront):
    """The port's render of `variant` with `wavefront` against the JAX
    package's: the live render's bars, or the stored means at 2e-3."""
    from tungsten_tpu_torch.ops import grid_walk
    from tungsten_tpu_torch.renderer.render import render_flat

    c = cases[variant]
    k6 = grid_walk.walk_twin.launches
    longest = []
    walk = grid_walk.walk

    def recording(*args, **kwargs):
        out = walk(*args, **kwargs)
        longest.append(grid_walk.walk_twin.work["longest"])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(grid_walk, "walk", recording)
        img = render_flat(c["scene"], seed=c["seed"], wavefront=wavefront)
    assert img.shape == (48, 64, 3) and np.isfinite(img).all() and (img >= 0).all()
    label = f"small-media {variant} {wavefront}"
    if variant in LIVE:
        check_image(img, c[wavefront], label)
    else:
        np.testing.assert_allclose(img.reshape(-1, 3).mean(0),
                                   ref["channel_means"][variant][wavefront], rtol=2e-3,
                                   err_msg=label)
    assert (grid_walk.walk_twin.launches > k6) == (variant == "cloud")
    assert max(longest, default=0) <= LONGEST_BAR, (label, max(longest))


def check_means_file(cases, ref, variants):
    """The file's means of the live `variants` equal the JAX renders'
    (rtol 1e-4: another CPU's rounding in XLA)."""
    for v in variants:
        assert ref["seed"] == cases[v]["seed"]
        assert sorted(ref["channel_means"][v]) == sorted(WAVEFRONTS[v])
        for w in WAVEFRONTS[v]:
            np.testing.assert_allclose(ref["channel_means"][v][w],
                                       cases[v][w].reshape(-1, 3).mean(0), rtol=1e-4,
                                       err_msg=f"{v} {w}")


CASES = [(v, w) for v in VARIANTS for w in WAVEFRONTS[v]]


@pytest.mark.parametrize("variant,wavefront", CASES, ids=[f"{v}-{w}" for v, w in CASES])
def test_media_render_matches_jax(cases, ref, variant, wavefront):
    check_media_render(cases, ref, variant, wavefront)


def test_reference_means_file_matches(cases, ref):
    check_means_file(cases, ref, [v for v in VARIANTS if v in LIVE])


if __name__ == "__main__":  # write tests/data/torch_port_media_ref.json anew
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        cs = {v: media_case(v, os.path.join(tmp, v)) for v in WAVEFRONTS}
    data = {"scene": SIZE, "seed": cs["fog"]["seed"], "spp": 4, "resolution": [64, 48],
            "channel_means": {v: {w: c[w].reshape(-1, 3).astype(np.float64).mean(0).tolist()
                                  for w in WAVEFRONTS[v]} for v, c in cs.items()}}
    with open(REF, "w") as f:
        json.dump(data, f, indent=1)
    print(REF)
