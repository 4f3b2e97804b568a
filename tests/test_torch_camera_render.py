"""The cameras, filters and AOVs end to end, in both packages and both
wavefronts.

`small-camera` (tungsten_tpu_torch/synth.py: the `small` scene through a
thinlens camera with a 6-blade aperture, cat-eye 0.5 and focus_pivot on the
ball under the mitchell_netravali filter, the same with a bitmap aperture,
an equirectangular camera under lanczos and a 96x16 cubemap under
catmull_rom; the two thinlens variants with depth, normal and albedo output
buffers) is flattened by both packages on the numpy BVH build and rendered
with render_buffers in each wavefront; the JAX side runs as its own tests
run it on the CPU.

  * the image against the JAX package's: channel means within 2e-3
    relative, >= 98% of pixels within 1e-3 + 1e-3 |ref|;
  * each AOV the same way, its means within 2e-3 of its largest channel
    mean (a normal's components cancel towards 0);
  * tests/data/torch_port_camera_ref.json holds the JAX renders' means for
    the check on the card; `python tests/test_torch_camera_render.py`
    writes it anew.
"""
import json
import os

import numpy as np
import pytest
import torch

from tungsten_tpu_torch import synth
from test_torch_lockstep_area import DATA, check_image, one_torch_thread  # noqa: F401

SIZE = "small-camera"
VARIANTS = ("thinlens", "bitmap", "equirectangular", "cubemap")
WAVEFRONTS = ("regen", "lockstep")
REF = os.path.join(DATA, "torch_port_camera_ref.json")


def aov_images(bufs):
    return {k: bufs.aov(k) for k in bufs.aovs}


def check_aovs(mine, theirs, label, rtol=2e-3):
    """AOV images of the port against the JAX package's, the bars of
    check_image; the means relative to the AOV's largest channel mean."""
    assert sorted(mine) == sorted(theirs), label
    for k, ref in theirs.items():
        img = mine[k]
        assert img.shape == ref.shape and np.isfinite(img).all(), (label, k)
        close = np.all(np.abs(img - ref) <= 1e-3 + 1e-3 * np.abs(ref), axis=-1)
        assert close.mean() >= 0.98, f"{label} {k}: {close.mean():.4f} of pixels within the bar"
        a, b = img.reshape(-1, img.shape[-1]).mean(0), ref.reshape(-1, ref.shape[-1]).mean(0)
        assert np.all(np.abs(a - b) <= rtol * np.abs(b).max()), (label, k, a, b)


def camera_case(variant, tmp_dir):
    """`variant` of small-camera in both packages on the numpy BVH build:
    {"scene" (the port's, on the CPU), "path", "doc" (the JAX document),
    "js" (the JAX FlatScene), and per wavefront the JAX render's "color"
    and "aovs"}."""
    import tungsten_tpu.accel.bvh as jbvh
    import tungsten_tpu_torch.accel.bvh as tbvh
    from tungsten_tpu.renderer.render import DEFAULT_SEED, render_buffers as jrender
    from tungsten_tpu.scene.flatten import flatten_scene as jflatten
    from tungsten_tpu.scene.load import load_scene as jload
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    mp = pytest.MonkeyPatch()
    mp.setattr(jbvh, "_NATIVE", False)
    mp.setattr(tbvh, "_NATIVE", False)
    mp.setattr(jbvh, "_CACHE_DIR", os.path.join(tmp_dir, "bvh_cache"))
    path = synth.write_scene(os.path.join(tmp_dir, variant), SIZE, variant)
    doc = jload(path)
    js = jflatten(doc)
    out = dict(scene=flatten_scene(load_scene(path), torch.device("cpu")), path=path, doc=doc,
               js=js, seed=DEFAULT_SEED)
    for w in WAVEFRONTS:
        bufs = jrender(js, seed=DEFAULT_SEED, wavefront=w)
        out[w] = dict(color=bufs.color(), aovs=aov_images(bufs))
    mp.undo()
    return out


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """{variant: camera_case, with the port's render_buffers in each
    wavefront under "port"}."""
    from tungsten_tpu_torch.renderer.render import render_buffers

    out = {}
    for v in VARIANTS:
        c = camera_case(v, str(tmp_path_factory.mktemp(v)))
        c["port"] = {w: render_buffers(c["scene"], seed=c["seed"], wavefront=w)
                     for w in WAVEFRONTS}
        out[v] = c
    return out


@pytest.mark.parametrize("wavefront", WAVEFRONTS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_render_matches_jax(cases, variant, wavefront):
    c = cases[variant]
    bufs, ref = c["port"][wavefront], c[wavefront]
    m = c["scene"].meta
    assert m.camera_type == ("thinlens" if variant == "bitmap" else variant)
    assert m.filter == synth.CAMERA_VARIANTS[variant][1]
    check_image(bufs.color(), ref["color"], f"{SIZE} {variant} {wavefront}")
    check_aovs(aov_images(bufs), ref["aovs"], f"{SIZE} {variant} {wavefront}")
    if variant in ("thinlens", "bitmap"):
        assert sorted(bufs.aovs) == ["albedo", "depth", "normal"]
        assert (bufs.aov_count == 4).all()


def test_aovs_are_plausible(cases):
    """Thinlens, regen: at the ball's pixels the depth lies between 0 and the
    focus distance, and the recorded normals are unit vectors. The cat-eye
    vignettes part of every pixel's samples, and a vignetted sample records
    nothing, so the ball's albedo (1) gives the share of samples recorded
    and each pixel's normal is that share of a unit vector."""
    c = cases["thinlens"]
    bufs = c["port"]["regen"]
    depth, normal, albedo = (bufs.aov(k) for k in ("depth", "normal", "albedo"))
    focus = float(c["scene"].camera.focus_dist)
    h, w = depth.shape[:2]
    centre = (slice(h // 2 - 3, h // 2 + 3), slice(w // 2 - 3, w // 2 + 3))
    assert (depth[centre] > 0.0).all() and (depth[centre] < focus).all()
    assert (albedo[centre] > 0.0).all()
    unit = np.linalg.norm(normal[centre], axis=-1) / albedo[centre].mean(-1)
    np.testing.assert_allclose(unit, 1.0, atol=0.02)
    assert (np.linalg.norm(normal, axis=-1) <= 1.0 + 1e-5).all()


def means_of(c):
    """One variant's JAX means: {"resolution", "channel_means": {wavefront:
    [3]}, "aov_means": {wavefront: {aov: [channels]}}}."""
    m = c["js"].meta
    out = {"resolution": [m.res_x, m.res_y], "channel_means": {}, "aov_means": {}}
    for w in WAVEFRONTS:
        out["channel_means"][w] = c[w]["color"].reshape(-1, 3).astype(np.float64).mean(0).tolist()
        out["aov_means"][w] = {k: v.reshape(-1, v.shape[-1]).astype(np.float64).mean(0).tolist()
                               for k, v in c[w]["aovs"].items()}
    return out


def test_reference_means_file_matches(cases):
    """The JSON file carries the JAX renders' means for the check on the
    card; rtol 1e-4 (2e-4 of the largest channel for the AOVs) leaves room
    for another CPU's float rounding in XLA, far below the 5e-3 that check
    applies."""
    with open(REF) as f:
        data = json.load(f)
    c0 = cases[VARIANTS[0]]
    assert data["scene"] == SIZE and data["seed"] == c0["seed"] and data["spp"] == 4
    assert sorted(data["variants"]) == sorted(VARIANTS)
    for v in VARIANTS:
        want, got = means_of(cases[v]), data["variants"][v]
        assert got["resolution"] == want["resolution"]
        for w in WAVEFRONTS:
            np.testing.assert_allclose(got["channel_means"][w], want["channel_means"][w],
                                       rtol=1e-4, err_msg=f"{v} {w}")
            assert sorted(got["aov_means"][w]) == sorted(want["aov_means"][w])
            for k, ref in want["aov_means"][w].items():
                np.testing.assert_allclose(got["aov_means"][w][k], ref, rtol=0,
                                           atol=2e-4 * np.abs(ref).max(), err_msg=f"{v} {w} {k}")


if __name__ == "__main__":  # write tests/data/torch_port_camera_ref.json anew
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        cs = {v: camera_case(v, os.path.join(tmp, v)) for v in VARIANTS}
    data = {"scene": SIZE, "seed": cs[VARIANTS[0]]["seed"], "spp": 4,
            "variants": {v: means_of(c) for v, c in cs.items()}}
    with open(REF, "w") as f:
        json.dump(data, f, indent=1)
    print(REF)
