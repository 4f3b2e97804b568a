"""The NFOR denoiser, its regression core, the image metrics and the four
tools of the port (tungsten_tpu_torch/utils, tungsten_tpu_torch/tools)
against the JAX package's, on the CPU.

The utils are float64 on both sides, so they are held at rtol 1e-9 on the
same seeded inputs (48x64): the only difference is the batched solve
(LAPACK's LU through numpy there, through torch here), which moves the
results by ~1e-13 relative. The NFOR stage spy of tests/test_nfor.py is
mirrored on the port, and a port render's nfor_inputs() goes into nfor.
The tools run in process against the JAX tools on the same files: the
denoiser in both modes (its --state mode on a state file the port's
renderer wrote, whose `res` the JAX renderer leaves out; ROADMAP §3),
hdrmanip's --merge, --rmse, --ssim, --mse-map and -t / -e, obj2json, and
the render server on --cpu at an ephemeral port; without --cpu the
denoiser and the server need a card.
"""
import importlib.util
import json
import os
import struct
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from test_nfor import _synthetic_scene
from test_torch_lockstep_area import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-9  # float64 on both sides; the solves differ by ~1e-13 relative
H, W = 48, 64


def jax_tool(name):
    """tools/<name>.py of the JAX package, loaded as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_tool(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name] + list(argv))
    jax_tool(name).main()


def inputs(seed=1, c=3):
    rng = np.random.default_rng(seed)
    return (rng.random((H, W, 3)), rng.random((H, W, 3)), rng.random((H, W, c)) * 0.01,
            rng.random((H, W, 4)))


@pytest.mark.parametrize("F, R, k, vs", [(3, 5, 0.5, 2.0), (1, 9, 1.0, 1.0), (3, 2, 0.5, 1.0)])
def test_nl_means_matches_jax(F, R, k, vs):
    from tungsten_tpu.utils import nfor as jn
    from tungsten_tpu_torch.utils import nfor as tn

    img, guide, var, _ = inputs()
    ref = jn.nl_means(img, guide, var, F, R, k, vs)
    out = tn.nl_means(img, guide, var, F, R, k, vs)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=0)


@pytest.mark.parametrize("k", [0.5, 1.0])
def test_collaborative_regression_matches_jax(k):
    from tungsten_tpu.utils import nfor as jn
    from tungsten_tpu_torch.utils import nfor as tn

    img, guide, var, feats = inputs(2)
    ref = jn.collaborative_regression(img, guide, feats, var, 3, 9, k)
    out = tn.collaborative_regression(img, guide, feats, var, 3, 9, k)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=0)


@pytest.fixture(scope="module")
def nfor_run():
    """One nfor of the synthetic scene of tests/test_nfor.py at 48x64 in
    each package, the port's with its stages spied on."""
    from tungsten_tpu.utils.nfor import nfor as jnfor
    from tungsten_tpu_torch.utils import nfor as tn

    gt, a, b, var, feats = _synthetic_scene(h=H, w=W)
    reg_calls, nlm_calls = [], []
    real_reg, real_nlm = tn.collaborative_regression, tn.nl_means

    def spy_reg(*args, **kw):
        reg_calls.append(args[-1])  # k
        return real_reg(*args, **kw)

    def spy_nlm(*args, **kw):
        nlm_calls.append((args[3], args[4]))  # (F, R)
        return real_nlm(*args, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(tn, "collaborative_regression", spy_reg)
    mp.setattr(tn, "nl_means", spy_nlm)
    try:
        out = tn.nfor(a, b, var, feats).numpy()
    finally:
        mp.undo()
    return dict(gt=gt, a=a, b=b, out=out, ref=jnfor(a, b, var, feats), reg=reg_calls,
                nlm=nlm_calls)


def test_nfor_matches_jax(nfor_run):
    np.testing.assert_allclose(nfor_run["out"], nfor_run["ref"], rtol=RTOL, atol=0)


def test_nfor_fires_every_stage(nfor_run):
    """tests/test_nfor.py's stage spy on the port: 5.2's two bandwidths a
    half buffer and 5.4's final pass; 5.1's prefilter (F=3, R=5) for 3
    features x 2 buffers, 5.3's filters (F=1, R=9) 3 times, 5.4's feature
    filter (F=3, R=2) a feature."""
    assert sorted(nfor_run["reg"]) == [0.5, 0.5, 1.0, 1.0, 1.0]
    assert nfor_run["nlm"].count((3, 5)) == 6
    assert nfor_run["nlm"].count((1, 9)) == 3
    assert nfor_run["nlm"].count((3, 2)) == 3


def test_nfor_denoises_and_keeps_the_edge(nfor_run):
    gt, out = nfor_run["gt"], nfor_run["out"]
    assert np.isfinite(out).all()
    mse_in = float(np.mean((0.5 * (nfor_run["a"] + nfor_run["b"]) - gt) ** 2))
    mse_out = float(np.mean((out - gt) ** 2))
    assert mse_out < mse_in / 6.0, (mse_in, mse_out)
    step_gt = gt[:, W // 2 - 2, 0] - gt[:, W // 2 + 1, 0]
    step_out = out[:, W // 2 - 2, 0] - out[:, W // 2 + 1, 0]
    assert np.mean(step_out) > 0.7 * np.mean(step_gt)


def test_nfor_selection_and_a_clean_input():
    """tests/test_nfor.py's selection test on the port: heavy noise on a
    flat signal is filtered hard; a clean input stays pinned to itself up to
    the ridge's bias."""
    from tungsten_tpu_torch.utils.nfor import nfor

    gt = np.full((H, W, 3), 0.5)
    feats = [{"buffer_a": np.full((H, W, 1), 1.0), "buffer_b": np.full((H, W, 1), 1.0),
              "variance": np.zeros((H, W, 1))}]
    rng = np.random.default_rng(7)
    a = gt + rng.normal(0.0, 0.5, gt.shape)
    b = gt + rng.normal(0.0, 0.5, gt.shape)
    out = nfor(a, b, np.full(gt.shape, 0.125), feats).numpy()
    assert float(np.mean((out - gt) ** 2)) < 0.125 / 8.0
    assert np.allclose(nfor(gt, gt, np.zeros_like(gt), feats).numpy(), gt, atol=5e-3)


@pytest.mark.parametrize("features", ["none", "albedo_normal_depth", "with_variance"])
def test_denoise_matches_jax(features):
    from tungsten_tpu.utils.denoise import denoise as jdenoise
    from tungsten_tpu_torch.utils.denoise import denoise

    color, albedo, var, f = inputs(3)
    kw = {}
    if features != "none":
        kw = dict(albedo=albedo, normal=f[..., :3], depth=f[..., 3:] + 0.5)
    if features == "with_variance":
        kw["variance"] = var
    ref = jdenoise(color, **kw)
    out = denoise(color, **kw)
    assert out.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["mse", "rmse", "ssim", "ssim_gray"])
def test_metrics_match_jax(name):
    from tungsten_tpu.utils import compare as jc
    from tungsten_tpu_torch.utils import compare as tc

    a, b, _, _ = inputs(4)
    if name == "ssim_gray":
        a, b, name = a[..., 0], b[..., 0], "ssim"
    ref = getattr(jc, name)(a, b)
    out = getattr(tc, name)(a, b)
    assert isinstance(out, float)
    np.testing.assert_allclose(out, ref, rtol=RTOL)


def small_scene(out_dir, res=(32, 24), spp=4):
    """small at res and spp, with the depth / normal / albedo output
    buffers: the scene.json path."""
    from tungsten_tpu_torch import synth

    path = synth.write_scene(out_dir, "small")
    with open(path) as f:
        doc = json.load(f)
    doc["camera"]["resolution"] = list(res)
    doc["renderer"].update(spp=spp, output_buffers=[{"type": t} for t in
                                                    ("albedo", "normal", "depth")])
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


@pytest.fixture(scope="module")
def state_render(tmp_path_factory):
    """A port render of small with AOVs that wrote its state file: (its
    OutputBuffers, the state's path, the scene path)."""
    import tungsten_tpu_torch.accel.bvh as tbvh
    from tungsten_tpu_torch.renderer.render import render_buffers
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    out = str(tmp_path_factory.mktemp("state"))
    path = small_scene(out)
    mp = pytest.MonkeyPatch()
    mp.setattr(tbvh, "_NATIVE", False)
    try:
        scene = flatten_scene(load_scene(path), torch.device("cpu"))
    finally:
        mp.undo()
    state = os.path.join(out, "render.state")
    bufs = render_buffers(scene, passes_per_batch=1, resume_file=state)  # 2 passes a half
    return bufs, state, path


def test_nfor_inputs_of_a_port_render(state_render):
    """OutputBuffers.nfor_inputs() of a port render (albedo, normal, depth
    AOVs, two-buffer halves) -> the port's nfor, against the JAX nfor on
    the same inputs."""
    from tungsten_tpu.utils.nfor import nfor as jnfor
    from tungsten_tpu_torch.utils.nfor import nfor

    bufs = state_render[0]
    a, b, var, feats = bufs.nfor_inputs()
    assert a.shape == (24, 32, 3) and len(feats) == 3
    assert bufs.count_a.sum() == bufs.count_b.sum() == 2 * 32 * 24  # 4 passes, 2 a half
    out = nfor(a, b, var, feats).numpy()
    assert np.isfinite(out).all() and out.max() > 0.0
    np.testing.assert_allclose(out, jnfor(a, b, var, feats), rtol=RTOL, atol=0)


def test_denoiser_state_mode_matches_jax(state_render, tmp_path, monkeypatch):
    """--state on the state file the port's renderer wrote (its extra
    carries res, the departure): the port's tool against the JAX tool on the
    same file."""
    from tungsten_tpu_torch.io.imageio import load_image
    from tungsten_tpu_torch.tools import denoiser

    _, state, _ = state_render
    with np.load(state) as z:
        header = json.loads(bytes(z["__header__"]).decode())
    assert header["extra"] == {"next_pass": 4, "res": [32, 24]}
    denoiser.main(["--state", state, "-o", str(tmp_path / "port.pfm"), "--cpu"])
    run_jax_tool("denoiser", ["--state", state, "-o", str(tmp_path / "jax.pfm")], monkeypatch)
    out, ref = (load_image(str(tmp_path / f"{k}.pfm")) for k in ("port", "jax"))
    assert out.shape == (24, 32, 3) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)


def test_denoiser_refuses_a_state_without_res(tmp_path, monkeypatch):
    """A state whose extra lacks res (the JAX renderer's) is refused with
    the JAX tool's message."""
    from tungsten_tpu_torch.renderer.framebuffer import OutputBuffers
    from tungsten_tpu_torch.tools import denoiser

    state = str(tmp_path / "old.state")
    bufs = OutputBuffers(8, 6, aovs=("albedo",))
    bufs.add_pixel_sums(np.ones((48, 3)), 1, {"albedo": np.ones((48, 3))})
    bufs.save_state(state, "", {"next_pass": 1})
    msgs = []
    for run in (lambda: denoiser.main(["--state", state, "-o", str(tmp_path / "o.pfm"),
                                       "--cpu"]),
                lambda: run_jax_tool("denoiser", ["--state", state, "-o",
                                                  str(tmp_path / "j.pfm")], monkeypatch)):
        with pytest.raises(SystemExit) as e:
            run()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "lacks 'res'" in msgs[0]


def write_pfms(out_dir, seed=5, names=("color", "albedo", "normal", "depth", "ref")):
    from tungsten_tpu_torch.io.imageio import save_image

    rng = np.random.default_rng(seed)
    paths = {}
    for k in names:
        paths[k] = os.path.join(out_dir, f"{k}.pfm")
        save_image(paths[k], rng.random((H, W, 3)).astype(np.float32) + 0.05)
    return paths


def test_denoiser_image_mode_matches_jax(tmp_path, monkeypatch):
    from tungsten_tpu_torch.io.imageio import load_image
    from tungsten_tpu_torch.tools import denoiser

    p = write_pfms(str(tmp_path))
    args = [p["color"], "--albedo", p["albedo"], "--normal", p["normal"], "--radius", "4"]
    denoiser.main(args + ["-o", str(tmp_path / "port.pfm"), "--cpu"])
    run_jax_tool("denoiser", args + ["-o", str(tmp_path / "jax.pfm")], monkeypatch)
    out, ref = (load_image(str(tmp_path / f"{k}.pfm")) for k in ("port", "jax"))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)


def test_denoiser_refuses_a_three_channel_depth_image_as_jax(tmp_path, monkeypatch):
    """--depth: an image file loads with three channels and denoise()
    reshapes depth to one, so both tools raise (the port mirrors the JAX
    tool), and neither writes its output."""
    from tungsten_tpu_torch.tools import denoiser

    p = write_pfms(str(tmp_path))
    args = [p["color"], "--albedo", p["albedo"], "--depth", p["depth"]]
    with pytest.raises(RuntimeError, match="invalid for input of size"):
        denoiser.main(args + ["-o", str(tmp_path / "port.pfm"), "--cpu"])
    with pytest.raises(ValueError, match="reshape"):
        run_jax_tool("denoiser", args + ["-o", str(tmp_path / "jax.pfm")], monkeypatch)
    assert not os.path.exists(tmp_path / "port.pfm") and not os.path.exists(tmp_path / "jax.pfm")


def test_denoiser_without_cpu_needs_a_card(tmp_path):
    from tungsten_tpu_torch.tools import denoiser

    assert not torch.cuda.is_available()
    p = write_pfms(str(tmp_path), names=("color",))
    with pytest.raises(RuntimeError, match="CUDA"):
        denoiser.main([p["color"], "-o", str(tmp_path / "o.pfm")])
    assert not os.path.exists(tmp_path / "o.pfm")


@pytest.mark.parametrize("flag", ["--merge", "-t", "--mse-map", "--rmse-map"])
def test_hdrmanip_images_match_jax(flag, tmp_path, monkeypatch):
    """The merged, tonemapped and heat-map images of both tools, equal."""
    from tungsten_tpu_torch.io.imageio import load_image
    from tungsten_tpu_torch.tools import hdrmanip

    p = write_pfms(str(tmp_path), names=("a", "b", "ref"))
    ext = ".pfm" if flag == "--merge" else ".png"
    args = {"--merge": ["--merge", p["a"], p["b"]],
            "-t": ["-t", "filmic", "-e", "1.5", p["a"]],
            "--mse-map": ["--mse-map", p["ref"], p["a"]],
            "--rmse-map": ["--rmse-map", p["ref"], p["a"]]}[flag]
    hdrmanip.main(args + ["-o", str(tmp_path / f"port{ext}")])
    run_jax_tool("hdrmanip", args + ["-o", str(tmp_path / f"jax{ext}")], monkeypatch)
    out, ref = (load_image(str(tmp_path / f"{k}{ext}"), gamma_correct=False)
                for k in ("port", "jax"))
    assert out.shape == (H, W, 3)
    if ext == ".png":  # 8-bit: a value on a quantization step may round apart
        assert np.abs(out - ref).max() <= 1.0 / 255.0 + 1e-6
        assert (out == ref).mean() >= 0.999
    else:
        assert np.array_equal(out, ref)


@pytest.mark.parametrize("flag", ["--mse", "--rmse", "--ssim"])
def test_hdrmanip_metrics_match_jax(flag, tmp_path, monkeypatch, capsys):
    from tungsten_tpu_torch.tools import hdrmanip

    p = write_pfms(str(tmp_path), names=("a", "b", "ref"))
    args = [flag, p["ref"], p["a"], p["b"]]
    hdrmanip.main(args)
    port = capsys.readouterr().out
    run_jax_tool("hdrmanip", args, monkeypatch)
    jax_out = capsys.readouterr().out
    assert port == jax_out and port.count(flag[2:].upper()) == 2


def test_obj2json_matches_jax(tmp_path, monkeypatch):
    from tungsten_tpu_torch.tools import obj2json

    obj = tmp_path / "tri.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nvn 0 0 1\nvt 0 0\nvt 1 0\nvt 0 1\n"
                   "vt 1 1\nf 1/1/1 2/2/1 3/3/1\nf 2/2/1 4/4/1 3/3/1\n")
    for side in ("port", "jax"):
        (tmp_path / side).mkdir()
        argv = [str(obj), str(tmp_path / side / "scene.json")]
        if side == "port":
            obj2json.main(argv)
        else:
            run_jax_tool("obj2json", argv, monkeypatch)
    for name in ("scene.json", "tri.wo3"):
        port, jax_bytes = ((tmp_path / s / name).read_bytes() for s in ("port", "jax"))
        assert port == jax_bytes and len(port) > 0


def png_size(data: bytes):
    """(width, height) from a PNG's IHDR chunk."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR"
    return struct.unpack(">II", data[16:24])


def get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, r.headers["Content-Type"], r.read()


def test_server_on_the_cpu_answers_and_stops(tmp_path):
    """The server on --cpu at an ephemeral port renders small at 4 spp:
    /status reaches totalSpp, /render is a 32x24 PNG, /log says finished;
    then it shuts down."""
    from tungsten_tpu_torch.tools import tungsten_server as ts

    path = small_scene(str(tmp_path))
    args = ts._args([path, "--cpu", "--port", "0", "--spp", "4"])
    srv = ts.RenderServer(args.scenes, torch.device("cpu"), spp=args.spp, seed=args.seed,
                          host="127.0.0.1", port=args.port, checkpoint_interval=0.01).start()
    try:
        assert srv.port > 0
        deadline = time.time() + 120
        while True:
            code, ctype, body = get(srv.port, "/status")
            st = json.loads(body)
            if st["state"] == "idle" and st["currentSpp"] == st["totalSpp"] == 4:
                break
            assert time.time() < deadline, st
            time.sleep(0.1)
        assert code == 200 and ctype == "application/json" and st["queue"] == [path]
        code, ctype, png = get(srv.port, "/render")
        assert code == 200 and ctype == "image/png" and png_size(png) == (32, 24)
        code, _, log = get(srv.port, "/log")
        assert code == 200 and f"finished {path}".encode() in log
    finally:
        srv.shutdown()
    with pytest.raises(OSError):
        get(srv.port, "/status")


def test_server_without_cpu_needs_a_card(tmp_path):
    from tungsten_tpu_torch.tools import tungsten_server as ts

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.main([small_scene(str(tmp_path)), "--port", "0"])
