"""The render driver of the port against the JAX package
(tests/test_renderer.py's cases but its two denoiser tests, on both
packages): AOVs, samples per pass, adaptive sampling, resume state and
checkpoints.

  * OutputBuffers fed the same batches as the JAX package's (add_batch with
    its lane map and AOVs, add_pixel_sums, add_batch_sparse) hold the same
    arrays bit for bit, and so do color, aov, half_images, pixel_variance,
    sample_variance and nfor_inputs; a state file written by either package
    loads in the other;
  * the AOVs of test_renderer.py's scene are plausible in both wavefronts,
    and the forward branch's (small-cutout, lockstep) match the JAX
    package's at the render bars (test_torch_camera_render.py holds regen
    and lockstep on small-camera);
  * samples_per_pass = 2 renders match the JAX package's in both wavefronts;
  * _tile_error and _sample_pixels_by_tile equal the JAX package's bit for
    bit on the same arrays; the adaptive render of small-camera matches the
    JAX package's means at the render bars, with JAX's invariants (every
    pixel its warm-up, the whole budget spent, more samples where the error
    is), and on __graft_entry__._MINI_CORNELL it agrees with the uniform
    render in the mean;
  * a render resumed from a state file equals one rendered straight through
    bit for bit, in both wavefronts; a state file of the JAX package resumes
    in the port to the JAX package's resumed image; another scene hash
    starts afresh; scene_hash is the JAX package's;
  * checkpoint_cb runs with (bufs, passes done).
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_camera_render import aov_images, camera_case, check_aovs
from test_torch_lockstep_area import check_image, one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
STATE_ARRAYS = ("sum", "count", "sum_a", "sum_b", "count_a", "count_b", "mean", "m2",
                "aov_count")


def simple_doc(aovs=False):
    """tests/test_renderer.py's simple_scene: a lambert floor under an
    emissive quad, 32x24."""
    raw = {
        "bsdfs": [{"name": "m", "albedo": 0.7, "type": "lambert"}],
        "primitives": [
            {"type": "quad", "transform": {"scale": 10.0}, "bsdf": "m"},
            {"type": "quad", "transform": {"position": [0, 2, 0], "scale": 1.0,
                                           "rotation": [0, 0, 180]},
             "emission": [5, 5, 5], "bsdf": {"type": "null", "albedo": 1}},
        ],
        "camera": {"type": "pinhole", "tonemap": "linear", "resolution": [32, 24], "fov": 45,
                   "transform": {"position": [0, 1, 3], "look_at": [0, 0, 0], "up": [0, 1, 0]}},
        "integrator": {"type": "path_tracer", "max_bounces": 4},
        "renderer": {"spp": 8, "scene_bvh": False},
    }
    if aovs:
        raw["renderer"]["output_buffers"] = [{"type": "depth"}, {"type": "normal"},
                                             {"type": "albedo"}]
    return raw


def port_scene(raw):
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import parse_scene

    doc = parse_scene(json.loads(json.dumps(raw)), path="/tmp/simple.json")
    return doc, flatten_scene(doc, CPU)


def assert_same_buffers(a, b, arrays=STATE_ARRAYS):
    """Every array of two OutputBuffers equal bit for bit, and the passes."""
    assert a.passes == b.passes and sorted(a.aovs) == sorted(b.aovs)
    for k in arrays:
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=k)
    for name in ("aovs", "aovs_a", "aovs_b"):
        for k in getattr(a, name):
            np.testing.assert_array_equal(getattr(a, name)[k], getattr(b, name)[k],
                                          err_msg=f"{name} {k}")


@pytest.fixture(scope="module")
def thinlens(tmp_path_factory):
    """small-camera's thinlens variant in both packages (JAX renders of
    4 spp in both wavefronts included)."""
    return camera_case("thinlens", str(tmp_path_factory.mktemp("thinlens")))


def test_output_buffers_match_jax(tmp_path, rng):
    from tungsten_tpu.renderer.framebuffer import OutputBuffers as JBuffers
    from tungsten_tpu_torch.renderer.framebuffer import AOV_NAMES, OutputBuffers

    assert AOV_NAMES == ("depth", "normal", "albedo", "visibility")
    w, h, m = 12, 8, 2
    n = w * h
    aovs = ("depth", "normal", "albedo")
    mine, theirs = OutputBuffers(w, h, aovs=aovs), JBuffers(w, h, aovs=aovs)
    pix_map = rng.permutation(np.tile(np.arange(n), m))

    def aux(k):
        return {"depth": rng.uniform(0, 5, k), "normal": rng.normal(size=(k, 3)),
                "albedo": rng.uniform(size=(k, 3))}

    for step in range(5):
        if step % 2 == 0:
            args = (rng.uniform(0, 3, (m * n, 3)), 3, m, n, aux(m * n))
            mine.add_batch(*args, pix_map=pix_map if step else None)
            theirs.add_batch(*args, pix_map=pix_map if step else None)
        else:
            args = (rng.uniform(0, 3, (n, 3)), 4, aux(n))
            mine.add_pixel_sums(*args)
            theirs.add_pixel_sums(*args)
    sel = rng.integers(0, n, 3 * n)
    rad = rng.uniform(0, 2, (3 * n, 3))
    mine.add_batch_sparse(rad, sel)
    theirs.add_batch_sparse(rad, sel)
    assert_same_buffers(mine, theirs)
    for f in ("color", "half_images", "pixel_variance", "sample_variance"):
        for x, y in zip(np.atleast_1d(getattr(mine, f)()), np.atleast_1d(getattr(theirs, f)())):
            np.testing.assert_array_equal(x, y, err_msg=f)
    for k in aovs:
        np.testing.assert_array_equal(mine.aov(k), theirs.aov(k))
    a, b, var, feats = mine.nfor_inputs()
    ja, jb, jvar, jfeats = theirs.nfor_inputs()
    for x, y in [(a, ja), (b, jb), (var, jvar)] + [(f[k], g[k]) for f, g in zip(feats, jfeats)
                                                    for k in f]:
        np.testing.assert_array_equal(x, y)
    # a state file of either package loads in the other; the port's carries
    # aov_count too, which the JAX package's leaves out (ROADMAP §3)
    for writer, reader_cls in ((mine, OutputBuffers), (mine, JBuffers),
                               (theirs, OutputBuffers)):
        path = str(tmp_path / "state.dat")
        writer.save_state(path, "h", {"next_pass": 7})
        assert not os.path.exists(path + ".tmp")
        back = reader_cls(w, h, aovs=aovs)
        assert back.load_state(path, "h") == {"next_pass": 7}
        both = writer is mine and reader_cls is OutputBuffers
        assert_same_buffers(back, writer, STATE_ARRAYS if both else STATE_ARRAYS[:-1])
        if not both:  # the resumed AOV samples count from 0, as in the JAX package
            assert (back.aov_count == 0).all()
        assert reader_cls(w, h).load_state(path, "another hash") is None


@pytest.mark.parametrize("wavefront", ["regen", "lockstep"])
def test_aov_buffers(wavefront):
    """test_renderer.py's AOV case: floor pixels have depth about their
    distance from the camera, normal +y and albedo 0.7."""
    from tungsten_tpu_torch.renderer.render import render_buffers

    _, scene = port_scene(simple_doc(aovs=True))
    bufs = render_buffers(scene, spp=4, seed=3, wavefront=wavefront)
    depth, normal, albedo = (bufs.aov(k) for k in ("depth", "normal", "albedo"))
    c = depth[16:20, 14:18, 0]
    assert (c > 2.0).all() and (c < 6.0).all()
    np.testing.assert_allclose(normal[16:20, 14:18, 1], 1.0, atol=0.05)
    np.testing.assert_allclose(albedo[16:20, 14:18], 0.7, atol=0.05)
    assert (bufs.aov_count == 4).all()


def test_forward_branch_aovs_match_jax(tmp_path):
    """small-cutout with depth, normal and albedo buffers through the
    lockstep tracer's forward branch (_trace_pass_forward): the image and
    the AOVs match the JAX package's trace_pass slow branch."""
    import tungsten_tpu.accel.bvh as jbvh
    import tungsten_tpu_torch.accel.bvh as tbvh
    from tungsten_tpu.renderer.render import render_buffers as jrender
    from tungsten_tpu.scene.flatten import flatten_scene as jflatten
    from tungsten_tpu.scene.load import load_scene as jload
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.renderer.render import render_buffers
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    mp = pytest.MonkeyPatch()
    mp.setattr(jbvh, "_NATIVE", False)
    mp.setattr(tbvh, "_NATIVE", False)
    mp.setattr(jbvh, "_CACHE_DIR", str(tmp_path / "bvh_cache"))
    path = synth.write_scene(str(tmp_path), "small-cutout")
    with open(path) as f:
        doc = json.load(f)
    doc["renderer"]["output_buffers"] = [{"type": t} for t in ("depth", "normal", "albedo")]
    with open(path, "w") as f:
        json.dump(doc, f)
    js = jflatten(jload(path))
    scene = flatten_scene(load_scene(path), CPU)
    assert scene.meta.has_forward and js.meta.has_forward
    theirs = jrender(js, wavefront="lockstep")
    mp.undo()
    mine = render_buffers(scene, wavefront="lockstep")
    check_image(mine.color(), theirs.color(), "small-cutout lockstep, AOVs on")
    check_aovs(aov_images(mine), aov_images(theirs), "small-cutout lockstep")


@pytest.mark.parametrize("wavefront", ["regen", "lockstep"])
def test_samples_per_pass_matches_jax(thinlens, wavefront):
    """Two samples a pixel a pass (the 16x16-tile lane order twice): 4 spp
    in 2 passes, against the JAX package's render."""
    from tungsten_tpu.renderer.render import render_buffers as jrender
    from tungsten_tpu_torch.renderer.render import render_buffers

    theirs = jrender(thinlens["js"], spp=4, samples_per_pass=2, wavefront=wavefront)
    mine = render_buffers(thinlens["scene"], spp=4, samples_per_pass=2, wavefront=wavefront)
    assert mine.passes == theirs.passes and (mine.count == 4).all()
    label = f"small-camera thinlens, 2 samples a pass, {wavefront}"
    check_image(mine.color(), theirs.color(), label)
    check_aovs(aov_images(mine), aov_images(theirs), label)


def test_adaptive_helpers_bit_for_bit(rng):
    """_tile_error and _sample_pixels_by_tile on the same buffers and the
    same generator state give the JAX package's arrays bit for bit (the
    port keeps them as host numpy)."""
    from tungsten_tpu.renderer import render as jr
    from tungsten_tpu.renderer.framebuffer import OutputBuffers as JBuffers
    from tungsten_tpu_torch.renderer import render as tr
    from tungsten_tpu_torch.renderer.framebuffer import OutputBuffers

    for w, h in ((37, 21), (64, 48), (96, 16)):
        mine, theirs = OutputBuffers(w, h), JBuffers(w, h)
        for _ in range(2):
            rad = rng.gamma(0.5, 1.0, (w * h, 3)) * (rng.uniform(size=(w * h, 1)) < 0.9)
            mine.add_pixel_sums(rad, 8)
            theirs.add_pixel_sums(rad, 8)
        err = tr._tile_error(mine, w, h)
        np.testing.assert_array_equal(err, jr._tile_error(theirs, w, h))
        assert err.shape == ((h + 3) // 4, (w + 3) // 4) and (err > 0).all()
        p = err.ravel() / err.sum()
        a = tr._sample_pixels_by_tile(p, w, h, np.random.default_rng(5), w * h)
        b = jr._sample_pixels_by_tile(p, w, h, np.random.default_rng(5), w * h)
        np.testing.assert_array_equal(a, b)
        assert a.min() >= 0 and a.max() < w * h


def test_adaptive_render_matches_jax(thinlens):
    """16 warm-up passes (one regen batch), then 8 adaptive lockstep passes:
    the means match the JAX package's adaptive render at the render bars,
    and JAX's invariants hold (test_renderer.py)."""
    from tungsten_tpu.renderer.render import render_buffers as jrender
    from tungsten_tpu_torch.renderer.render import render_buffers

    theirs = jrender(thinlens["js"], spp=24, adaptive=True, passes_per_batch=16)
    mine = render_buffers(thinlens["scene"], spp=24, adaptive=True, passes_per_batch=16)
    n_pix = mine.count.size
    assert mine.count.min() >= 16 and mine.count.max() > mine.count.min()
    assert mine.count.sum() == theirs.count.sum() == 24 * n_pix
    assert mine.passes == theirs.passes == 9
    img, ref = mine.color(), theirs.color()
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img.reshape(-1, 3).mean(0), ref.reshape(-1, 3).mean(0),
                               rtol=2e-3)


def test_adaptive_sampling_on_mini_cornell():
    """test_renderer.py's adaptive cases on __graft_entry__._MINI_CORNELL:
    every pixel gets its warm-up, the budget is redistributed, and at the
    same total budget the adaptive render agrees with the uniform one in
    the mean (each adaptive pass takes a pass index of its own)."""
    from __graft_entry__ import _MINI_CORNELL
    from tungsten_tpu_torch.renderer.render import render_buffers

    _, scene = port_scene(_MINI_CORNELL)
    uni = render_buffers(scene, spp=64, seed=23)
    ada = render_buffers(scene, spp=64, seed=23, adaptive=True)
    counts = ada.count.reshape(scene.meta.res_y, scene.meta.res_x)
    assert counts.min() >= 16 and counts.max() > counts.min()
    assert ada.count.sum() == uni.count.sum()
    a, u = ada.color(), uni.color()
    assert np.isfinite(a).all()
    mask = u.max(-1) > 0.01
    np.testing.assert_allclose(a[mask].mean(0) / u[mask].mean(0), 1.0, atol=0.05)


@pytest.mark.parametrize("wavefront,half,ppb", [("regen", 16, 16), ("lockstep", 4, 4)])
def test_resume_is_bit_for_bit(thinlens, tmp_path, wavefront, half, ppb):
    """`half` spp saved, then resumed to 2 * half, equals 2 * half spp in
    batches of `ppb` passes: sums, counts, halves, Welford state and AOVs
    (the counter RNG keys every sample on (seed, lane, pass))."""
    from tungsten_tpu_torch.renderer.render import render_buffers

    scene, f = thinlens["scene"], str(tmp_path / "state.dat")
    first = render_buffers(scene, spp=half, passes_per_batch=ppb, resume_file=f,
                           scene_hash_value="h", wavefront=wavefront)
    assert first.passes == half // ppb
    resumed = render_buffers(scene, spp=2 * half, passes_per_batch=ppb, resume_file=f,
                             scene_hash_value="h", wavefront=wavefront)
    straight = render_buffers(scene, spp=2 * half, passes_per_batch=ppb, wavefront=wavefront)
    assert_same_buffers(resumed, straight)
    assert (resumed.count == 2 * half).all() and (resumed.count_a == half).all()
    assert (resumed.sum_a != resumed.sum_b).any()


def test_jax_state_file_resumes_in_port(thinlens, tmp_path):
    """A state file the JAX package wrote (16 spp, regen) resumes in the
    port to 32 spp; the result matches the JAX package's own resumed
    render at the render bars, and the first batch's arrays are the JAX
    file's."""
    from tungsten_tpu.renderer.framebuffer import scene_hash as jhash
    from tungsten_tpu.renderer.render import render_buffers as jrender
    from tungsten_tpu_torch.renderer.render import render_buffers

    sh = jhash(thinlens["doc"])
    f_jax, f_port = str(tmp_path / "jax.dat"), str(tmp_path / "port.dat")
    jrender(thinlens["js"], spp=16, resume_file=f_jax, scene_hash_value=sh)
    shutil.copy(f_jax, f_port)
    theirs = jrender(thinlens["js"], spp=32, resume_file=f_jax, scene_hash_value=sh)
    mine = render_buffers(thinlens["scene"], spp=32, resume_file=f_port, scene_hash_value=sh)
    assert mine.passes == theirs.passes == 2
    np.testing.assert_array_equal(mine.sum_a, theirs.sum_a)  # the JAX file's first batch
    assert (mine.count == 32).all()
    label = "small-camera thinlens resumed from a JAX state file"
    check_image(mine.color(), theirs.color(), label)
    check_aovs(aov_images(mine), aov_images(theirs), label)


def test_checkpoint_resume_roundtrip(tmp_path):
    """test_renderer.py's case: 8 spp saved, resumed to 16; another scene
    hash starts afresh."""
    from tungsten_tpu_torch.renderer.framebuffer import scene_hash
    from tungsten_tpu_torch.renderer.render import render_buffers

    doc, scene = port_scene(simple_doc())
    sh = scene_hash(doc)
    f = str(tmp_path / "state.dat")
    render_buffers(scene, spp=8, seed=3, resume_file=f, scene_hash_value=sh)
    assert render_buffers(scene, spp=16, seed=3, resume_file=f,
                          scene_hash_value=sh).count.min() >= 16
    fresh = render_buffers(scene, spp=8, seed=3, resume_file=f, scene_hash_value="other")
    assert fresh.count.max() <= 8 and fresh.passes == 1


def test_scene_hash_matches_jax(tmp_path):
    """scene_hash of the same document is the JAX package's (nested BSDFs,
    textures, cameras and output buffers included), and tells scenes apart."""
    from tungsten_tpu.renderer.framebuffer import scene_hash as jhash
    from tungsten_tpu.scene.load import load_scene as jload
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.renderer.framebuffer import scene_hash
    from tungsten_tpu_torch.scene.load import load_scene

    hashes = set()
    for size, variant in (("small-camera", "bitmap"), ("small-camera", "cubemap"),
                          ("small-coat", None), ("small-lights", None)):
        path = synth.write_scene(str(tmp_path / f"{size}-{variant}"), size, variant)
        h = scene_hash(load_scene(path))
        assert h == jhash(jload(path)), (size, variant)
        hashes.add(h)
    assert len(hashes) == 4


def test_checkpoint_cb_fires():
    """checkpoint_cb(bufs, passes done) after each batch once the interval
    has passed; never without an interval."""
    from tungsten_tpu_torch.renderer.render import render_buffers

    _, scene = port_scene(simple_doc())
    calls = []
    bufs = render_buffers(scene, spp=6, seed=3, passes_per_batch=2,
                          checkpoint_cb=lambda b, done: calls.append((b, done)),
                          checkpoint_interval=1e-9)
    assert [d for _, d in calls] == [2, 4, 6] and all(b is bufs for b, _ in calls)
    calls.clear()
    render_buffers(scene, spp=4, seed=3, passes_per_batch=2,
                   checkpoint_cb=lambda b, done: calls.append(done))
    assert calls == []
