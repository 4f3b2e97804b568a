"""One run of one cell: set-up, the measured window of whole frames, the check
against the plain reference, the metrics.

Set-up (`setup_s`, from the process's first line to the first timed frame):
the torch import, the native BVH builder and the CUDA libraries where the
checkout has not built them yet, the scene written into TMPDIR, the
program's load and flatten, and a warm-up that runs every path the frames
take (one regen pass; for the adaptive traffic one lockstep pass too; for
SPPM one iteration). The window then renders whole frames back to back,
frame k seeded from --seed and k, until --seconds have passed, and finishes
the frame in progress. With --trace 1 the window runs under the spans and
counters of trace.Tracer and its first frame under the profiler.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import check, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "tungsten_tpu")
M64 = (1 << 64) - 1


def frame_seed(seed: int, k: int) -> int:
    """A 32-bit seed for frame k of the run seeded `seed` (splitmix64)."""
    x = (int(seed) + (k + 1) * 0x9E3779B97F4A7C15) & M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
    return (x ^ (x >> 31)) & 0xFFFFFFFF


REF_SEED = 1 << 20  # the k of the reference's seed
WARM_SEED = 1 << 21


def log(t_start: float, msg: str):
    print(f"[port_bench {time.perf_counter() - t_start:8.2f} s] {msg}", file=sys.stderr,
          flush=True)


def build_native(root: str):
    """The program's host BVH builder, built once per checkout with portable
    flags (the flatten builds in numpy without it, ~10 s a full scene)."""
    lib = os.path.join(root, "native", "libtungsten_native.so")
    if os.path.exists(lib):
        return
    proc = subprocess.run(["make", "-C", os.path.join(root, "native"),
                           "CXXFLAGS=-O3 -fPIC -std=c++17"], capture_output=True, text=True)
    if proc.returncode:
        print(f"[setup] native BVH builder: make exited {proc.returncode}; the flatten builds "
              f"in numpy\n{proc.stdout[-400:]}{proc.stderr[-400:]}", file=sys.stderr)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


class Frames:
    """The program's entry the window drives, as its CLI calls it."""

    def __init__(self, cell: spec.Cell, scene, dev):
        from tungsten_tpu_torch.renderer import render
        self.render = render
        self.tr = cell.traffic
        self.scene = scene
        self.spp = int(self.tr["frame_spp"])
        self.photons = cell.config.get("photon_count", 1 << 18)
        self.dev = dev

    def frame(self, seed: int, spp=None, wavefront="auto"):
        """-> (the frame (H, W, 3), the camera paths it traced: the
        framebuffer's per-pixel sample counts summed; for SPPM the camera
        lanes of its gather passes, one pass an iteration)."""
        tr, spp = self.tr, spp or self.spp
        if tr["integrator"] == "progressive_photon_map":
            from tungsten_tpu_torch.integrators import photon_map
            inner, lanes = photon_map.gather_pass, []

            def counted(scene, seed, lane_ids, *a, **kw):
                lanes.append(int(lane_ids.shape[0]))
                return inner(scene, seed, lane_ids, *a, **kw)
            photon_map.gather_pass = counted
            try:
                img = self.render.render_sppm(
                    self.scene, spp=spp, seed=seed, photons_per_iter=int(self.photons),
                    alpha=float(tr["alpha"]), volume_photon_type="points", gather_count=None)
            finally:
                photon_map.gather_pass = inner
            return img, sum(lanes)
        bufs = self.render.render_buffers(
            self.scene, spp=spp, seed=seed, samples_per_pass=int(tr["samples_per_pass"]),
            passes_per_batch=int(tr["passes_per_batch"]),
            adaptive=bool(tr["adaptive"]) and wavefront == "auto", wavefront=wavefront)
        return bufs.color(), int(bufs.count.sum())

    def warm_up(self, seed: int):
        self.frame(seed, spp=1)
        if self.tr.get("adaptive"):  # the adaptive passes run the lockstep tracer
            self.frame(seed, spp=1, wavefront="lockstep")

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, dev, t_start: float,
             native=True) -> tuple:
    """-> (result dict, the check's lines for stderr)."""
    cuda = dev.type == "cuda"
    if native:
        build_native(spec.ROOT)
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    sys.path.insert(0, spec.BENCH_DIR)
    import scenes

    work = tempfile.mkdtemp(prefix="port_bench_")
    scene_path = scenes.write_scene(work, cell.config, cell.traffic["integrator"])
    t0 = time.perf_counter()
    scene = flatten_scene(load_scene(scene_path), dev)
    flatten_s = time.perf_counter() - t0
    log(t_start, f"scene written and flattened ({flatten_s:.2f} s of it the flatten)")
    fr = Frames(cell, scene, dev)
    fr.warm_up(frame_seed(seed, WARM_SEED))
    fr.sync()
    setup_s = time.perf_counter() - t_start
    log(t_start, "warmed up: the window opens")

    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    tracer = trace.Tracer(sync=cuda) if traced else None
    images, paths, times, prof, marks = [], [], [], None, None
    with tracer or contextlib.nullcontext():
        w0 = time.perf_counter()
        k = 0
        while True:
            f0 = time.perf_counter()
            if traced and k == 0 and cuda:
                m0 = tracer.mark()
                with trace.profiled() as prof:
                    img, n = fr.frame(frame_seed(seed, k))
                marks = (m0, tracer.mark())
            else:
                img, n = fr.frame(frame_seed(seed, k))
            fr.sync()
            f1 = time.perf_counter()
            images.append(np.asarray(img, np.float32))
            paths.append(n)
            times.append((f0 - w0, f1 - w0))
            log(t_start, f"frame {k}: {f1 - f0:.3f} s")
            k += 1
            if f1 - w0 >= seconds:
                break
    window_s = times[-1][1]
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    peak = max(setup_peak, window_peak)
    # the noise number pairs each frame with another: where the window held
    # one frame, one more is rendered for the check alone, after the window
    extra = [np.asarray(fr.frame(frame_seed(seed, k))[0], np.float32)] if k < 2 else []
    del fr, scene
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the check: every frame against the plain reference
    c = cell.cell
    ref_kw = dict(cell.traffic["reference"])
    mode = ref_kw.pop("mode")
    t0 = time.perf_counter()
    ref_mean, ref_var, n_tris = check.reference_image(scene_path, mode, int(c["ref_spp"]),
                                              frame_seed(seed, REF_SEED), dev, **ref_kw)
    ref_s = time.perf_counter() - t0
    log(t_start, f"reference rendered in {ref_s:.1f} s")
    limits = c["limits"]
    per_frame = check.judge(images, extra, ref_mean, ref_var, int(c["ref_spp"]), fr_spp(cell))
    failed = sum(1 for r in per_frame if not all(r[k] <= lim for k, lim in limits.items()))
    worst = {k: max(r[k] for r in per_frame) for k in limits}
    shutil.rmtree(work, ignore_errors=True)

    rec = SimpleNamespace(
        setup_s=setup_s, flatten_s=flatten_s, window_s=window_s,
        paths=sum(paths), peak_bytes=window_peak,
        tracer=tracer, marks=marks, prof=prof, n_tris=n_tris, n_frames=len(images))
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = spec.reader(m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": int(c.get("chips", 1)), "memory_peak_bytes": int(peak)}
    result = {"correct": failed == 0 and bool(images), "attempted": len(images),
              "failed": failed, "metrics": metrics, "device": device}
    if cuda:
        device["power_limit"] = power_limit()
    if traced and prof is not None:
        busy, by_name, _, union = trace.device_summary(prof["events"])
        wall = prof["host_end_ns"] - prof["host_start_ns"]
        device["busy_s"] = busy / 1e9
        device["window_s"] = wall / 1e9
        offset = prof["trace_start_ns"] - prof["host_start_ns"]
        top = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)[:10]
        gaps = trace.idle_gaps(union, prof["trace_start_ns"], prof["trace_start_ns"] + wall)
        result["breakdown"] = {
            "device_ops": [[name[:160], ns / 1e9] for name, (_, ns) in top],
            "idle_gaps": trace.label_gaps(gaps, tracer.spans, offset)}
    result["check"] = {k: {"value": v, "limit": limits[k]} for k, v in worst.items()}
    lines = [f"check {k} {v!r} limit {limits[k]!r} (the largest over {len(images)} frames "
             f"{[r[k] for r in per_frame]}; against the reference at {c['ref_spp']} spp, "
             f"rendered in {ref_s:.1f} s)" for k, v in worst.items()]
    return result, lines


def fr_spp(cell) -> int:
    return int(cell.traffic["frame_spp"])


def main(argv, t_start: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="one run of one cell of the port's benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    chips = int(cell.cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    # every build and kernel cache of the run at a fixed place in the checkout
    cache = os.path.join(spec.ROOT, "build", "port_bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda"), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"no result: modules {bad} are loaded (the port and the benchmark import no "
              f"JAX package)", file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    return 0
