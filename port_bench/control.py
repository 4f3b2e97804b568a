"""The readings a cell's limits are set from, in one process on the card:

    python port_bench/control.py --workload <name> --seed <n> [--sound 12] [--control 3]
        [--fault <kind>]

For each of `--sound` seeds (seed, seed + 1, ...): two frames of the
program, seeded as a run's first two, against the reference as a run
renders it; their numbers (check.judge, the larger of the two frames') are
sound readings. With `--fault` the program runs with that fault planted
(faults.py) and the readings are the fault's. For each of `--control`
seeds: the reference itself in bfloat16 (the control: the next precision
below the float32 that the configuration states), rendered at the frame's
spp in the program's place, against the float32 reference: the control's
z_max and z2_mean (its noise is not read: two more renders at the frame's
spp). Prints one JSON line a reading and a summary line. The benchmark's
own runs do not run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from harness import check, spec  # noqa: E402
from harness.run import REF_SEED, Frames, build_native, frame_seed  # noqa: E402


def readings(cell, seed: int, n_sound: int, n_control: int, dev, native=True, fault=None):
    """-> {"sound": [readings, ...], "control": [readings, ...]}, each a dict of
    the compared numbers, printing each as it comes."""
    import faults
    import scenes
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    if native:
        build_native(spec.ROOT)
    if fault:
        faults.plant(fault, cell.traffic["integrator"])
    work = tempfile.mkdtemp(prefix="port_bench_control_")
    path = scenes.write_scene(work, cell.config, cell.traffic["integrator"])
    fr = Frames(cell, flatten_scene(load_scene(path), dev), dev)
    ref_kw = dict(cell.traffic["reference"])
    mode = ref_kw.pop("mode")
    ref_spp, frame_spp = int(cell.cell["ref_spp"]), int(cell.traffic["frame_spp"])
    out = {"sound": [], "control": []}
    for i in range(n_sound):
        s = seed + i
        t0 = time.perf_counter()
        imgs = [fr.frame(frame_seed(s, k))[0] for k in (0, 1)]
        fr.sync()
        t1 = time.perf_counter()
        m, v, _ = check.reference_image(path, mode, ref_spp, frame_seed(s, REF_SEED), dev,
                                        **ref_kw)
        per = check.judge(imgs, [], m, v, ref_spp, frame_spp)
        z = {k: max(r[k] for r in per) for k in per[0]}
        out["sound"].append(z)
        print(json.dumps({"kind": f"fault:{fault}" if fault else "sound", "seed": s, **z,
                          "frames_s": t1 - t0, "reference_s": time.perf_counter() - t1}),
              flush=True)
    for i in range(n_control):
        s = seed + 1000 + i
        t0 = time.perf_counter()
        m, v, _ = check.reference_image(path, mode, ref_spp, frame_seed(s, REF_SEED), dev,
                                        **ref_kw)
        t1 = time.perf_counter()
        mb, _, _ = check.reference_image(path, mode, frame_spp, frame_seed(s, 0), dev,
                                         dtype=torch.bfloat16, **ref_kw)
        z = check.compare(mb.cpu().numpy(), m, v, ref_spp, frame_spp)
        out["control"].append(z)
        print(json.dumps({"kind": "control", "seed": s, **z, "reference_s": t1 - t0,
                          "control_s": time.perf_counter() - t1}), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--sound", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--fault", default=None, help="a kind of faults.py, planted in the program")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    out = readings(spec.load_cell(args.workload), args.seed, args.sound, args.control,
                   torch.device("cuda"), fault=args.fault)
    keys = ("z_max", "z2_mean", "noise")
    print(json.dumps({"workload": args.workload, "fault": args.fault,
                      "lower": {k: max((r[k] for r in out["sound"]), default=None) for k in keys},
                      "upper": {k: min((r[k] for r in out["control"] if k in r), default=None)
                                for k in keys}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
