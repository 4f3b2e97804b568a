"""The port's command line (tungsten_tpu_torch/tools/tungsten.py) against
the JAX package's (tools/tungsten.py), on the CPU.

  * `--cpu` on small-camera's thinlens variant writes the files the JAX CLI
    writes (the tonemapped LDR image, the HDR image, each AOV's LDR and HDR
    file), its HDR image and AOVs within the render bars of the JAX CLI's;
  * without `--cpu` it raises where there is no card (it never falls back
    to the CPU);
  * light_tracer and bidirectional_path_tracer (plain, and with its
    image_pyramid: one <output>-s=S-t=T.png a technique) render through
    `--cpu` and write the LDR and HDR files, the HDR image the render
    function's of the same scene and seed;
  * photon_map and progressive_photon_map render small-box through `--cpu`
    and write the LDR and HDR files, the HDR image within the render bars of
    the JAX CLI's;
  * kelemen_mlt (bidirectional, and path-traced with "bidirectional":
    false), multiplexed_mlt and reversible_jump_mlt render small-box
    (max_bounces 3, at half resolution) through `--cpu` and write the LDR
    and HDR files the JAX CLI writes, the HDR image within the render bars
    of the JAX CLI's; both CLIs' render functions run with MLT_CHAINS chains
    and MLT_BOOT bootstrap rounds, their defaults' 8,192-16,384 and 16 being
    minutes on the CPU;
  * an integrator type neither CLI names renders as the path tracer, as the
    JAX CLI renders it; in a queue of scenes a scene that fails (a
    primitive type neither package knows) is reported and the rest render,
    and a single failing scene raises;
  * small-hair (curves with the three fiber BSDFs under a skydome) and
    small-mc (a minecraft_map with a resource pack, an IES-profiled sphere
    and a skydome) render through `--cpu` at the default seed, their HDR
    images' channel means within 2e-3 of the JAX package's renders in
    tests/data/torch_port_fiber_ref.json;
  * `enable_resume_render` resumes from the state file (-r starts afresh),
    `checkpoint_interval` writes the checkpoint images, `--scale` scales the
    resolution; parse_duration reads s / m / h.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from test_torch_camera_render import check_aovs
from test_torch_lockstep_area import check_image, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = ["-q", "--seed", "7"]


def port_cli(argv):
    from tungsten_tpu_torch.tools.tungsten import main

    main(argv)


def jax_cli(argv, monkeypatch, home):
    """tools/tungsten.py's main with `argv`; the compilation cache it sets up
    goes under `home`, and JAX's settings are restored after it."""
    import jax

    spec = importlib.util.spec_from_file_location("jax_tungsten_cli",
                                                  os.path.join(REPO, "tools", "tungsten.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setattr("sys.argv", ["tungsten.py"] + argv)
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        cli.main()
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


def _scene(tmp_path, name="scene", variant="thinlens", edit=None):
    from tungsten_tpu_torch import synth

    path = synth.write_scene(str(tmp_path / name), "small-camera", variant)
    if edit:
        with open(path) as f:
            doc = json.load(f)
        edit(doc)
        with open(path, "w") as f:
            json.dump(doc, f)
    return path


@pytest.fixture
def numpy_bvh(monkeypatch, tmp_path):
    import tungsten_tpu.accel.bvh as jbvh
    import tungsten_tpu_torch.accel.bvh as tbvh

    monkeypatch.setattr(jbvh, "_NATIVE", False)
    monkeypatch.setattr(tbvh, "_NATIVE", False)
    monkeypatch.setattr(jbvh, "_CACHE_DIR", str(tmp_path / "bvh_cache"))


def test_cpu_run_writes_what_the_jax_cli_writes(tmp_path, monkeypatch, numpy_bvh):
    from tungsten_tpu_torch.io.imageio import load_image

    path = _scene(tmp_path)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port_cli([path, "--cpu", "-d", str(tmp_path / "port")] + QUIET)
    jax_cli([path, "--cpu", "-d", str(tmp_path / "jax")] + QUIET, monkeypatch, tmp_path)
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(["thinlens.png", "thinlens.pfm"] + [
        f"thinlens_{k}.{e}" for k in ("depth", "normal", "albedo") for e in ("png", "pfm")])

    def read(d, f):
        return load_image(str(tmp_path / d / f))

    check_image(read("port", "thinlens.pfm"), read("jax", "thinlens.pfm"), "CLI HDR output")
    check_aovs({k: read("port", f"thinlens_{k}.pfm") for k in ("depth", "normal", "albedo")},
               {k: read("jax", f"thinlens_{k}.pfm") for k in ("depth", "normal", "albedo")},
               "CLI AOV outputs")
    depth = read("port", "thinlens_depth.pfm")
    assert depth.max() == 1.0 and depth.min() >= 0.0  # normalised by its maximum
    ldr = read("port", "thinlens.png")
    assert ldr.shape == (48, 64, 3) and 0.0 <= ldr.min() and ldr.max() <= 1.0


def test_without_cpu_flag_it_needs_a_card(tmp_path):
    assert not torch.cuda.is_available()
    path = _scene(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cli([path] + QUIET)
    assert not os.path.exists(os.path.join(os.path.dirname(path), "thinlens.pfm"))


def test_unknown_integrator_renders_as_the_jax_cli(tmp_path, monkeypatch, numpy_bvh):
    """The JAX CLI's last branch: a type it does not name is path traced."""
    from tungsten_tpu_torch.io.imageio import load_image

    path = _scene(tmp_path, variant="cubemap",
                  edit=lambda d: d["integrator"].update(type="no_such_tracer"))
    for who, cli in (("port", lambda a: port_cli(a + ["--cpu"])),
                     ("jax", lambda a: jax_cli(a + ["--cpu"], monkeypatch, tmp_path))):
        (tmp_path / who).mkdir()
        cli([path, "-s", "2", "-d", str(tmp_path / who)] + QUIET)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    hdr = load_image(str(tmp_path / "port" / "cubemap.pfm"))
    check_image(hdr, load_image(str(tmp_path / "jax" / "cubemap.pfm")), "CLI unknown integrator")


def test_a_failing_scene_is_reported_and_the_queue_goes_on(tmp_path, capsys):
    def unknown(doc):  # a primitive type neither package knows
        doc["primitives"].append({"type": "bezier_patch", "bsdf": "floor"})

    bad = _scene(tmp_path, "bad", edit=unknown)
    with pytest.raises(NotImplementedError, match="'bezier_patch'"):
        port_cli([bad, "--cpu"] + QUIET)
    # in a queue the failure is reported and the next scene renders
    good = _scene(tmp_path, "good", variant="cubemap",
                  edit=lambda d: d["renderer"].update(spp=1))
    port_cli([bad, good, "--cpu"] + QUIET)
    err = capsys.readouterr().err
    assert "FAILED" in err and "bezier_patch" in err
    assert os.path.exists(os.path.join(os.path.dirname(good), "cubemap.pfm"))
    assert not os.path.exists(os.path.join(os.path.dirname(bad), "thinlens.pfm"))


def test_resume_checkpoint_and_scale(tmp_path):
    from tungsten_tpu_torch.io.imageio import load_image
    from tungsten_tpu_torch.renderer.framebuffer import OutputBuffers
    from tungsten_tpu_torch.tools.tungsten import parse_duration

    def resumable(doc):
        doc["renderer"].update(enable_resume_render=True, resume_render_file="state.dat",
                               checkpoint_interval="0.000001s")

    path = _scene(tmp_path, edit=resumable)
    out = os.path.dirname(path)
    port_cli([path, "--cpu", "-s", "2", "--passes-per-batch", "1"] + QUIET)
    state = os.path.join(out, "state.dat")
    assert os.path.exists(state)
    assert os.path.exists(os.path.join(out, "thinlens_checkpoint.png"))

    def passes():
        return OutputBuffers(64, 48, aovs=("depth",)).load_state(
            state, _hash(path))["next_pass"]

    assert passes() == 2
    port_cli([path, "--cpu", "-s", "3", "--passes-per-batch", "1"] + QUIET)
    assert passes() == 3  # resumed at pass 2, one more pass
    port_cli([path, "--cpu", "-s", "1", "-r", "--scale", "0.5", "-c", "0"] + QUIET)
    assert passes() == 3  # -r: neither read nor written
    assert load_image(os.path.join(out, "thinlens.pfm")).shape == (24, 32, 3)
    assert [parse_duration(v) for v in ("0", "", None, "90", "30s", "5m", "2h")] == [
        0.0, 0.0, 0.0, 90.0, 30.0, 300.0, 7200.0]


def test_adaptive_sampling_from_the_scene(tmp_path):
    """The renderer's adaptive_sampling (Tungsten's default: on) drives the
    CLI: past 16 spp the passes go by tile error; off, every pixel gets the
    same count."""
    from tungsten_tpu_torch.renderer.framebuffer import OutputBuffers

    counts = {}
    for adaptive in (True, False):
        def edit(doc):
            doc["renderer"].update(spp=20, enable_resume_render=True,
                                   resume_render_file="state.dat")
            if not adaptive:
                doc["renderer"]["adaptive_sampling"] = False

        path = _scene(tmp_path, f"adaptive-{adaptive}", edit=edit)
        port_cli([path, "--cpu"] + QUIET)
        bufs = OutputBuffers(64, 48)
        bufs.load_state(os.path.join(os.path.dirname(path), "state.dat"), _hash(path))
        counts[adaptive] = bufs.count
    assert counts[True].min() >= 16 and counts[True].max() > counts[True].min()
    assert counts[True].sum() == counts[False].sum() and (counts[False] == 20).all()


def _hash(path):
    from tungsten_tpu_torch.renderer.framebuffer import scene_hash
    from tungsten_tpu_torch.scene.load import load_scene

    return scene_hash(load_scene(path))


def test_media_scene_renders_as_render_flat(tmp_path, numpy_bvh):
    """The CLI renders a scene with media (small-media's fog: a homogeneous
    camera medium with the davis transmittance): its HDR output equals
    render_flat's image of the same scene and seed."""
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.io.imageio import load_image
    from tungsten_tpu_torch.renderer.render import render_flat
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    path = synth.write_scene(str(tmp_path / "fog"), "small-media", "fog")
    with open(path) as f:
        doc = json.load(f)
    doc["renderer"].update(output_file="fog.png", hdr_output_file="fog.pfm")
    with open(path, "w") as f:
        json.dump(doc, f)
    port_cli([path, "--cpu"] + QUIET)
    hdr = load_image(os.path.join(os.path.dirname(path), "fog.pfm"))
    img = render_flat(flatten_scene(load_scene(path), torch.device("cpu")), seed=7)
    assert hdr.shape == img.shape == (48, 64, 3)
    check_image(hdr, img, "CLI media scene")
    assert (img.reshape(-1, 3).mean(0) > 0.01).all()


@pytest.mark.parametrize("variant", ["light_tracer", "bidirectional_path_tracer",
                                     "bdpt_pyramid"])
def test_light_tracer_and_bdpt_branches_write_their_files(tmp_path, variant):
    """small-box under the light tracer and BDPT (with and without its
    image pyramid) through `--cpu` at half resolution, 1 spp: the LDR and
    HDR files (and the pyramid's 26 technique images), the HDR image equal
    to the render function's of the same scene and seed."""
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.io.imageio import load_image
    from tungsten_tpu_torch.renderer import render
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    path = synth.write_scene(str(tmp_path / variant), "small-box", variant)
    with open(path) as f:
        doc = json.load(f)
    doc["renderer"].update(output_file="box.png", hdr_output_file="box.pfm")
    with open(path, "w") as f:
        json.dump(doc, f)
    port_cli([path, "--cpu", "-s", "1", "--scale", "0.5"] + QUIET)
    out = os.path.dirname(path)
    files = sorted(f for f in os.listdir(out) if f.startswith("box"))
    stack = [f"box-s={s}-t={t}.png" for s in range(7) for t in range(1, 8)
             if (t == 1 and 2 <= s <= 6) or (t >= 2 and s + t <= 7)]
    assert len(stack) == 26
    assert files == sorted(["box.png", "box.pfm"] + (stack if variant == "bdpt_pyramid" else []))
    hdr = load_image(os.path.join(out, "box.pfm"))
    doc = load_scene(path)
    doc.camera["resolution"] = [32, 24]
    scene = flatten_scene(doc, torch.device("cpu"))
    fn = {"light_tracer": render.render_light_traced,
          "bidirectional_path_tracer": render.render_bdpt,
          "bdpt_pyramid": lambda *a, **k: render.render_bdpt_pyramid(*a, **k)[0]}[variant]
    img = fn(scene, spp=1, seed=7)
    assert hdr.shape == img.shape == (24, 32, 3)
    np.testing.assert_allclose(hdr, img, rtol=1e-6, atol=1e-7)
    assert (img.reshape(-1, 3).mean(0) > 0.01).all()


@pytest.mark.parametrize("variant", ["photon_map", "progressive_photon_map"])
def test_photon_map_branches_match_the_jax_cli(tmp_path, monkeypatch, numpy_bvh, variant):
    """small-box under photon_map (the scene's kNN count) and
    progressive_photon_map through `--cpu`, one iteration of the scene's
    photon_count: the port's CLI writes what the JAX CLI writes, its HDR
    image within the render bars of the JAX CLI's."""
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.io.imageio import load_image

    path = synth.write_scene(str(tmp_path / variant), "small-box", variant)
    for who, cli in (("port", lambda a: port_cli(a + ["--cpu"])),
                     ("jax", lambda a: jax_cli(a + ["--cpu"], monkeypatch, tmp_path))):
        (tmp_path / who).mkdir()
        cli([path, "-s", "1", "-o", "box.png", "-e", "box.pfm", "-d", str(tmp_path / who)]
            + QUIET)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        "box.pfm", "box.png"]
    hdr = load_image(str(tmp_path / "port" / "box.pfm"))
    assert hdr.shape == (48, 64, 3) and (hdr.reshape(-1, 3).mean(0) > 0.05).all()
    check_image(hdr, load_image(str(tmp_path / "jax" / "box.pfm")), f"CLI {variant}")



MLT_CHAINS, MLT_BOOT = 768, 2  # 1 spp at 32x24 is one step


@pytest.mark.parametrize("variant", ["kelemen_mlt", "kelemen_mlt+pt", "multiplexed_mlt",
                                     "reversible_jump_mlt"])
def test_mlt_branches_match_the_jax_cli(tmp_path, monkeypatch, numpy_bvh, variant):
    """small-box (max_bounces 3) under the Metropolis integrators through
    `--cpu` at half resolution (reversible_jump_mlt at 4 spp: three Kelemen
    steps and one strategy step), each CLI's render functions given
    MLT_CHAINS chains and MLT_BOOT bootstrap rounds: the same files, the HDR
    images within the render bars."""
    import functools

    from tungsten_tpu.integrators import kelemen as jk, multiplexed as jm, rjmlt as jr
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.integrators import kelemen as tk, multiplexed as tm, rjmlt as tr
    from tungsten_tpu_torch.io.imageio import load_image

    for mod, names in ((jk, ("render_kelemen", "render_kelemen_bdpt")), (jm, ("render_mmlt",)),
                       (jr, ("render_rjmlt",)), (tk, ("render_kelemen", "render_kelemen_bdpt")),
                       (tm, ("render_mmlt",)), (tr, ("render_rjmlt",))):
        for name in names:
            monkeypatch.setattr(mod, name, functools.partial(
                getattr(mod, name), n_chains=MLT_CHAINS, bootstrap_factor=MLT_BOOT))
    path = synth.write_scene(str(tmp_path / "box"), "small-box", variant)
    with open(path) as f:
        doc = json.load(f)
    doc["integrator"].update(max_bounces=3, large_step_probability=0.25)
    with open(path, "w") as f:
        json.dump(doc, f)
    spp = "4" if variant == "reversible_jump_mlt" else "1"
    for who, cli in (("port", lambda a: port_cli(a + ["--cpu"])),
                     ("jax", lambda a: jax_cli(a + ["--cpu"], monkeypatch, tmp_path))):
        (tmp_path / who).mkdir()
        cli([path, "-s", spp, "--scale", "0.5", "-o", "box.png", "-e", "box.pfm", "-d",
             str(tmp_path / who)] + QUIET)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        "box.pfm", "box.png"]
    hdr = load_image(str(tmp_path / "port" / "box.pfm"))
    assert hdr.shape == (24, 32, 3) and (hdr.reshape(-1, 3).mean(0) > 0.05).all()
    check_image(hdr, load_image(str(tmp_path / "jax" / "box.pfm")), f"CLI {variant}")


@pytest.mark.parametrize("size", ["small-hair", "small-mc"])
def test_fiber_and_minecraft_scenes_render(tmp_path, numpy_bvh, size):
    from test_torch_hair_render import REF
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.io.imageio import load_image

    path = synth.write_scene(str(tmp_path / size), size)
    out = os.path.dirname(path)
    port_cli([path, "--cpu", "-q", "-o", "out.png", "-e", "out.pfm"])
    assert os.path.exists(os.path.join(out, "out.png"))
    hdr = load_image(os.path.join(out, "out.pfm"))
    with open(REF) as f:
        want = np.asarray(json.load(f)[size]["channel_means"]["regen"])
    assert hdr.shape == (48, 64, 3) and np.isfinite(hdr).all() and (hdr >= 0).all()
    np.testing.assert_allclose(hdr.reshape(-1, 3).mean(0), want, rtol=2e-3)
