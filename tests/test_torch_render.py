"""End to end: render_flat of the `small` scene in both packages.

The JAX side runs as its own tests run it on the CPU (the binary BVH walk
`intersect_bvh`); the port runs with the BVH8 twin. Both use the numpy BVH
build. Bars: per-channel image means agree to 2e-3 relative, and >= 98%
of pixels lie within 1e-3 + 1e-3 * |ref| (a path whose hit flips between
the two walks shades differently, so a few pixels may differ).

tests/data/torch_port_small_ref.json holds the JAX package's per-channel
means of this render, so a machine without JAX (the GPU's) can check the
port against them; the test checks that the file still matches.
"""
import json
import os

import numpy as np
import pytest
import torch

REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "torch_port_small_ref.json")


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    import tungsten_tpu.accel.bvh as jbvh
    import tungsten_tpu_torch.accel.bvh as tbvh
    from tungsten_tpu.renderer.render import DEFAULT_SEED, render_flat as jrender
    from tungsten_tpu.scene.flatten import flatten_scene as jflatten
    from tungsten_tpu.scene.load import load_scene as jload
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.ops import bvh8
    from tungsten_tpu_torch.renderer.render import render_flat
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    mp = pytest.MonkeyPatch()
    mp.setattr(jbvh, "_NATIVE", False)
    mp.setattr(tbvh, "_NATIVE", False)
    mp.setattr(jbvh, "_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    path = synth.write_scene(str(tmp_path_factory.mktemp("small")), "small")
    ref = jrender(jflatten(jload(path)), seed=DEFAULT_SEED)
    twin0 = bvh8.walk_twin.launches
    img = render_flat(flatten_scene(load_scene(path), torch.device("cpu")), seed=DEFAULT_SEED)
    walks = bvh8.walk_twin.launches - twin0
    mp.undo()
    return np.asarray(ref), img, walks


def test_small_render_matches_jax(renders):
    ref, img, walks = renders
    assert img.shape == ref.shape == (48, 64, 3)
    assert np.isfinite(img).all() and (img >= 0).all()
    assert walks > 0  # the render went through the BVH8 walk
    m_ref = ref.reshape(-1, 3).mean(0)
    m_img = img.reshape(-1, 3).mean(0)
    np.testing.assert_allclose(m_img, m_ref, rtol=2e-3)
    close = np.all(np.abs(img - ref) <= 1e-3 + 1e-3 * np.abs(ref), axis=-1)
    assert close.mean() >= 0.98, f"{close.mean():.4f} of pixels within the bar"


def test_reference_means_file_matches(renders):
    """The JSON carries the JAX render's means for the GPU check; rtol 1e-4
    leaves room for another CPU's float rounding in XLA, far below the
    5e-3 the GPU check applies."""
    ref, _, _ = renders
    with open(REF) as f:
        data = json.load(f)
    from tungsten_tpu.renderer.render import DEFAULT_SEED

    assert data["scene"] == "small" and data["seed"] == DEFAULT_SEED and data["spp"] == 4
    np.testing.assert_allclose(data["channel_means"], ref.reshape(-1, 3).mean(0), rtol=1e-4)


def test_render_scene_tonemaps(tmp_path):
    """render_scene = load + flatten + render + the scene's tonemap."""
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.models.cameras.tonemap import tonemap
    from tungsten_tpu_torch.renderer.render import render_scene

    path = synth.write_scene(str(tmp_path), "small")
    hdr, ldr = render_scene(path, torch.device("cpu"), spp=1)
    assert hdr.shape == ldr.shape == (48, 64, 3)
    assert np.isfinite(hdr).all() and (ldr >= 0).all() and (ldr <= 1).all()
    np.testing.assert_allclose(ldr, np.clip(tonemap("filmic", torch.as_tensor(hdr)).numpy(), 0, 1))
