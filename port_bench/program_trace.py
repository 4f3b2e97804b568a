"""One cell run with the program's own recorder open: the per-layer metrics
that read the program's spans and counters on the device trace's clock.

    python3 port_bench/program_trace.py --workload <cell> --seed <n> --seconds <s>
        [--syncs 1] [--cost <rounds>] [--out <file>]

Set-up as run.py's, with the recorder (tungsten_tpu_torch/utils/trace.py)
open from the scene's load: the scene written, loaded and flattened, the
warm-up. Then the window's frames as run.py renders them, the first under
harness/program.py's profile (CUDA activity with its launch records, the
clock anchor), the walk counters counted over the window. `--syncs 1` then
renders one batch (SPPM: one iteration) under
torch.cuda.set_sync_debug_mode("warn") and counts the syncs it flags, in
and out of the sync.* spans. `--cost R` renders R rounds of frames with the
recording closed, open with its spans alone, and open with the walk
counters too, in turns (cost()).
No check against the reference: run.py's runs check the frames.

Prints one JSON line (and writes it to --out where given): the metrics,
the clock anchor's error, the device time by span against the profile's
per-kernel sum, the device's idle time by span, the longest idle gaps with
their program labels, and the host syncs by site.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import warnings  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from harness import program, readers, run, spec, trace  # noqa: E402
from tungsten_tpu_torch.utils import trace as ptrace  # noqa: E402


def frames_window(fr, seed, seconds, rec):
    """run.py's window: frames back to back until `seconds` have passed, the
    first profiled. Fills rec.prof, rec.window_ns, rec.n_frames."""
    w0 = time.perf_counter_ns()
    k = 0
    while True:
        f0 = time.perf_counter()
        if k == 0:
            with program.profiled() as prof:
                fr.frame(run.frame_seed(seed, k))
            rec.prof = prof
        else:
            fr.frame(run.frame_seed(seed, k))
        fr.sync()
        run.log(T_START, f"frame {k}: {time.perf_counter() - f0:.3f} s")
        k += 1
        if time.perf_counter_ns() - w0 >= seconds * 1e9:
            break
    rec.window_ns = (w0, time.perf_counter_ns())
    rec.n_frames = k


def sync_sites(fr, seed, integrator):
    """One regen batch (SPPM: one iteration) under the sync debug mode: the
    syncs it flags, by whether a sync.* span was the innermost open one, and
    the uncovered ones by site."""
    flagged = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            inner = ptrace.REC.innermost() if ptrace.REC is not None else None
            flagged.append((inner, f"{os.path.relpath(filename, spec.ROOT)}:{lineno}"))

    spp = 1 if integrator == "progressive_photon_map" else int(fr.tr["passes_per_batch"])
    with ptrace.recording(counters=()), warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fr.frame(run.frame_seed(seed, 1 << 22), spp=spp)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    inside = sum(1 for inner, _ in flagged if inner and inner.startswith("sync."))
    out = collections.Counter(site for inner, site in flagged
                              if not (inner and inner.startswith("sync.")))
    covered = collections.Counter(inner for inner, _ in flagged
                                  if inner and inner.startswith("sync."))
    return {"spp": spp, "flagged": len(flagged), "in_sync_spans": inside,
            "covered_pct": 100.0 * inside / len(flagged) if flagged else None,
            "by_span": dict(covered), "uncovered_sites": dict(out.most_common())}


COST_SIDES = {"off": None, "spans": (), "on": ptrace.WALK_COUNTERS}


def cost(fr, seed, rounds):
    """Frame walls (s) with the recording closed ("off"), open with its
    spans alone ("spans") and open with the walk counters too ("on"), in
    turns: off, spans, on, on, spans, off, ..."""
    walls = {side: [] for side in COST_SIDES}
    order = []
    for i in range(rounds):
        order += list(COST_SIDES) if i % 2 == 0 else list(COST_SIDES)[::-1]
    for k, side in enumerate(order):
        counters = COST_SIDES[side]
        f0 = time.perf_counter()
        with (ptrace.recording(counters) if counters is not None
              else contextlib.nullcontext()):
            fr.frame(run.frame_seed(seed, 100 + k))
            fr.sync()
        walls[side].append(time.perf_counter() - f0)
        run.log(T_START, f"cost frame {k} ({side}): {walls[side][-1]:.3f} s")
    return {side: {"walls_s": v, "median_s": statistics.median(v)} for side, v in walls.items()}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description="one cell with the program's recorder open")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--syncs", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cost", type=int, default=0,
                    help="rounds of frames with the recording off, spans only, on")
    ap.add_argument("--out", help="a file to write the JSON line to as well")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no result: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    run.build_native(spec.ROOT)
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    sys.path.insert(0, spec.BENCH_DIR)
    import scenes

    integrator = cell.traffic["integrator"]
    rec = SimpleNamespace(prof=None)
    with tempfile.TemporaryDirectory(prefix="port_bench_") as work:
        with ptrace.recording(counters=()) as prog:
            scene_path = scenes.write_scene(work, cell.config, integrator)
            scene = flatten_scene(load_scene(scene_path), dev)
            fr = run.Frames(cell, scene, dev)
            fr.warm_up(run.frame_seed(args.seed, run.WARM_SEED))
            fr.sync()
            run.log(T_START, "warmed up: the window opens")
            rec.lanes0 = prog.counts.get("walk.lanes", 0)
            with ptrace.recording():  # the walk counters over the window alone
                frames_window(fr, args.seed, args.seconds, rec)
        rec.program = prog
        run.log(T_START, "window closed; reading the profile")
        kind = "sppm" if integrator == "progressive_photon_map" else "pt"
        metrics = {
            f"idle_dispatch_pct.{kind}": program.idle_dispatch_pct(rec, kind),
            f"host_syncs_per_frame.{kind}": program.host_syncs_per_frame(rec),
            "flatten_packs_s": program.flatten_packs_s(rec),
        }
        if kind == "pt":
            metrics["idle_driver_pct.pt"] = program.idle_driver_pct(rec)
            metrics["live_lane_pct.pt"] = program.live_lane_pct(rec)
        else:
            metrics["sppm_compensate_device_ms"] = program.sppm_compensate_device_ms(rec)
        att = program.by_name(rec, program.attributed(rec))
        idle = program.by_name(rec, program.idle_by_span(rec))
        _, by_kernel, kernels, _ = trace.device_summary(rec.prof["events"])
        kernel_ns = sum(ns for _, ns in by_kernel.values())
        wall = rec.prof["host_end_ns"] - rec.prof["host_start_ns"]
        top = sorted(att.items(), key=lambda kv: kv[1], reverse=True)
        result = {
            "workload": args.workload, "seed": args.seed, "frames": rec.n_frames,
            "device": torch.cuda.get_device_name(0), "power_limit": run.power_limit(),
            "metrics": metrics,
            "anchor_err_us": rec.prof["anchor_err_ns"] / 1e3,
            "attributed_over_kernel_sum": sum(att.values()) / kernel_ns if kernel_ns else None,
            "device_idle_pct": readers.device_idle_pct(SimpleNamespace(prof=rec.prof)),
            "profiled_wall_s": wall / 1e9, "kernels": kernels,
            "pt_iter_in_profile": sum(1 for i in program.in_window(rec)
                                      if prog.spans[i][0] == "pt.iter"),
            "device_ms_by_span": {k: v / 1e6 for k, v in top[:16]},
            "idle_ms_by_span": {k: v / 1e6 for k, v in
                                sorted(idle.items(), key=lambda kv: kv[1], reverse=True)[:16]},
            "host_self_ms": {k: v / 1e6 for k, v in sorted(
                prog.self_ns(rec.prof["host_start_ns"], rec.prof["host_end_ns"]).items(),
                key=lambda kv: kv[1], reverse=True)[:20]},
            "idle_gaps": program.gap_labels(rec),
            "counts": prog.counts, "totals": prog.totals,
        }
        if args.syncs:
            result["syncs"] = sync_sites(fr, args.seed, integrator)
        if args.cost:
            result["cost"] = cost(fr, args.seed, args.cost)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
