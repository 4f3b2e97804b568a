"""Intersector benchmark of the port: every BVH walk on the same rays.

    python -m tungsten_tpu_torch.tools.bench_isect [--scene PATH] [--n 131072]
        [--kernels bvh8,bvh8any,bvh8fast,bvh8fastq,bvh3,bvh3skip,bvh3any,bvh,bvh1,tri,
                   gather,gatherany (and bvh8v1,bvh8anyv1,bvh8fastv1,bvh3v1,bvh3skipv1,
                   bvh3anyv1,bvhv1,bvh1v1,triv1)]
        [--trials 5]
        [--device cuda|cpu]

The port's counterpart of the JAX package's tools/bench_isect.py and
tools/bench_kernel.py. It flattens a scene at 250x141 (as both tools do) and
times each walk on three ray kinds, n rays each:
  coherent    camera rays through the tiled pixels, jittered by
              Sampler.create((1, 0), arange(n)) (bench_isect.make_rays);
  incoherent  origins uniform in the triangles' v0 box, normalised normal
              directions, numpy seed 0;
  dead        the incoherent rays with tfar = 0 (bench_kernel.py's all-dead
              case): the cost of a launch whose rays all leave at once.
Kernels (each a walk of one pack of the flattened scene):
  bvh8      K3 closest hit (csrc/bvh8_walk.cu)    bvh8any   K3 latched any-hit
  bvh8fast  K3-fast, the raw bf16x3 walk          bvh8fastq the whole fast query: K3-fast,
            (csrc/bvh8_walk_fast.cu)                        exact validation, K3 repair launch
  bvh3      K4 ordered closest hit (bvh2_walk.cu) bvh3skip  K4 skip closest hit
  bvh3any   K4 any-hit                            bvh       K5-v2 closest hit (bvh_walk.cu)
  bvh1      K5-v1 closest hit (bvh_walk.cu, no    tri       K2 streaming brute force
            best-t pruning in the box tests)                (intersect_stream.cu)
  gather    K1 closest hit (gather_walk.cu: the   gatherany K1 any-hit, every lane latched
            8-ary tree of 8-triangle leaves)
Besides, by name only (not in the default list): the first CUDA forms
("v1": one thread per ray; K2's with the TPU kernel's tile vote) of K3,
K3-fast, K4, K5 and K2, kept to be measured beside the redesigned kernels
on one card:
  bvh8v1    K3 closest hit (bvh8_walk_v1.cu)      bvh8anyv1 its latched any-hit
  bvh8fastv1 K3-fast raw (bvh8_walk_fast_v1.cu)
  bvh3v1    K4 ordered (bvh2_walk_v1.cu)          bvh3skipv1 K4 skip (bvh2_walk_v1.cu)
  bvh3anyv1 K4 any-hit (bvh2_walk_v1.cu)
  bvhv1     K5-v2 (bvh_walk_v1.cu)                bvh1v1    K5-v1 (bvh_walk_v1.cu)
  triv1     K2 (intersect_stream_v1.cu)
e.g. --kernels bvh8,bvh8v1,bvh3,bvh3v1,bvh3skip,bvh3skipv1,bvh3any,bvh3anyv1,tri,triv1.
On a CUDA device each walk's kernel and its plain twin are timed with CUDA
events after a warm-up, as the median of --trials runs; on the CPU only the
twins run (the port's CPU path), timed by the host clock. Nothing falls back
from one to the other. The JAX tools chain calls inside one jit to hide the
TPU runtime's dispatch cost; that protocol is not carried over.

Agreement, as both JAX tools check it: each kernel against intersect_brute
on 4,096 incoherent rays (seed 1): hit mask, and t within rtol 1e-3 where
both hit (occlusion only for the any-hit walks; bvh8fast and bvh8fastq both
through the whole fast query, since the raw winner may be a phantom and
answers to nothing before its validation; bvh8fastv1 through the fast
query on the v1 walks); K4 (bvh3) against K5 (bvh)
on the coherent rays: hit mask and t within rtol 1e-4; each any-hit walk
against its closest-hit walk's hit mask. Besides, K2 is the brute-force
reference of every other walk on all n coherent rays (hit mask). The run
fails when an agreement is below 99.9%.

Each time row also keeps the twin's count of box and triangle tests on
those rays ("work"; for K2 also `sub_box_work`'s count of what its sub-box
cull leaves), from which chip_smoke.py computes the kernel's bound.

The default scene is materialtest-synth (tungsten_tpu_torch/synth.py),
written into build/bench_isect/ of the checkout.
"""
from __future__ import annotations

import argparse
import functools
import os
import statistics
import sys
import time

import numpy as np
import torch

from .. import device as get_device
from .. import synth
from ..models.cameras.pinhole import camera_rays_w
from ..ops import bvh, bvh2, bvh8, gather_bvh, intersect_stream as k2
from ..ops.bvh8 import hit_from_slots
from ..ops.intersect import INF, intersect_brute
from ..sampling.sampler import Sampler
from ..scene.flatten import flatten_scene
from ..scene.load import load_scene

KERNELS = ("bvh8", "bvh8any", "bvh8fast", "bvh8fastq", "bvh3", "bvh3skip", "bvh3any", "bvh",
           "bvh1", "tri", "gather", "gatherany")
V1_KERNELS = ("bvh8v1", "bvh8anyv1", "bvh8fastv1", "bvh3v1", "bvh3skipv1", "bvh3anyv1", "bvhv1",
              "bvh1v1", "triv1")  # by name only, for comparison
# any-hit walk -> its closest-hit walk
ANY_OF = {"bvh8any": "bvh8", "bvh3any": "bvh3", "bvh8anyv1": "bvh8v1", "bvh3anyv1": "bvh3v1",
          "gatherany": "gather"}
UNSUPPORTED = {
    "bvhx": "the JAX tool imports tungsten_tpu/ops/pallas_bvhx.py, which the JAX "
            "package does not contain",
}
RAY_KINDS = ("coherent", "incoherent", "dead")
BAR = 0.999
RESOLUTION = (250, 141)
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_kernels(names):
    """Validate kernel names: an unsupported or unknown name raises, naming
    why; none is skipped."""
    names = list(names)
    for k in names:
        if k in UNSUPPORTED:
            raise ValueError(f"kernel {k!r} is not supported: {UNSUPPORTED[k]}")
        if k not in KERNELS + V1_KERNELS:
            raise ValueError(f"unknown kernel {k!r}; one of {', '.join(KERNELS + V1_KERNELS)}")
    return names


def _fast_query(walk_fast_fn, walk_fn, scene, o, d, tnear, tfar):
    h = bvh8.intersect(scene.pbvh8, scene.tris, o, d, tnear, tfar,
                       walks=(walk_fast_fn, walk_fn))
    return h.t, h.prim


def fast_query_cuda(scene, o, d, tnear, tfar):
    """The whole fast query on the kernels: (t, prim)."""
    return _fast_query(bvh8.walk_fast_cuda, bvh8.walk_cuda, scene, o, d, tnear, tfar)


def fast_query_twin(scene, o, d, tnear, tfar):
    """The whole fast query on the twins; `.work` sums the two walks' counts."""
    out = _fast_query(bvh8.walk_fast_twin, bvh8.walk_twin, scene, o, d, tnear, tfar)
    fast_query_twin.work = {k: bvh8.walk_fast_twin.work[k] + bvh8.walk_twin.work[k]
                            for k in ("box", "tri")}
    return out


fast_query_twin.work = {"box": 0, "tri": 0}


def walks(scene, name):
    """(kernel walk, twin walk) of one kernel name; each takes (o, d, tnear, tfar)."""
    p8, p3, pv, pt, pg = scene.pbvh8, scene.pbvh3, scene.pbvh, scene.ptris, scene.gbvh
    P = functools.partial
    return {
        "gather": (P(gather_bvh.walk_cuda, pg), P(gather_bvh.walk_twin, pg)),
        "gatherany": (P(gather_bvh.walk_cuda, pg, latch=True),
                      P(gather_bvh.walk_twin, pg, latch=True)),
        "bvh8": (P(bvh8.walk_cuda, p8), P(bvh8.walk_twin, p8)),
        "bvh8any": (P(bvh8.walk_cuda, p8, latch=True), P(bvh8.walk_twin, p8, latch=True)),
        "bvh8fast": (P(bvh8.walk_fast_cuda, p8), P(bvh8.walk_fast_twin, p8)),
        "bvh8v1": (P(bvh8.walk_cuda_v1, p8), P(bvh8.walk_twin, p8)),
        "bvh8anyv1": (P(bvh8.walk_cuda_v1, p8, latch=True), P(bvh8.walk_twin, p8, latch=True)),
        "bvh8fastv1": (P(bvh8.walk_fast_cuda_v1, p8), P(bvh8.walk_fast_twin, p8)),
        "bvh8fastq": (P(fast_query_cuda, scene), P(fast_query_twin, scene)),
        "bvh3": (P(bvh2.walk3_cuda, p3, mode="ordered"), P(bvh2.walk3_twin, p3, mode="ordered")),
        "bvh3skip": (P(bvh2.walk3_cuda, p3, mode="skip"), P(bvh2.walk3_twin, p3, mode="skip")),
        "bvh3any": (P(bvh2.walk3_cuda, p3, mode="any"), P(bvh2.walk3_twin, p3, mode="any")),
        "bvh3v1": (P(bvh2.walk3_cuda_v1, p3, mode="ordered"),
                   P(bvh2.walk3_twin, p3, mode="ordered")),
        "bvh3skipv1": (P(bvh2.walk3_cuda_v1, p3, mode="skip"),
                       P(bvh2.walk3_twin, p3, mode="skip")),
        "bvh3anyv1": (P(bvh2.walk3_cuda_v1, p3, mode="any"), P(bvh2.walk3_twin, p3, mode="any")),
        "bvh": (P(bvh.walk_packet_cuda, pv), P(bvh.walk_packet_twin, pv)),
        "bvh1": (P(bvh.walk_packet_cuda, pv, prune=False),
                 P(bvh.walk_packet_twin, pv, prune=False)),
        "bvhv1": (P(bvh.walk_packet_cuda_v1, pv), P(bvh.walk_packet_twin, pv)),
        "bvh1v1": (P(bvh.walk_packet_cuda_v1, pv, prune=False),
                   P(bvh.walk_packet_twin, pv, prune=False)),
        "tri": (P(k2.stream_cuda, pt), P(k2.stream_twin, pt)),
        "triv1": (P(k2.stream_cuda_v1, pt), P(k2.stream_twin, pt)),
    }[name]


def query(scene, name, rays):
    """The public query of one kernel name on the rays' device: (hit mask,
    t or None for the any-hit walks)."""
    on_card = rays[0].is_cuda
    if name in ("bvhv1", "bvh1v1"):
        walk = bvh.walk_packet_cuda_v1 if on_card else bvh.walk_packet_twin
        h = bvh.hit_from_local(scene.pbvh, *walk(scene.pbvh, *rays, prune=name == "bvhv1"))
    elif name in ("bvh3v1", "bvh3skipv1"):
        walk = bvh2.walk3_cuda_v1 if on_card else bvh2.walk3_twin
        mode = "ordered" if name == "bvh3v1" else "skip"
        h = hit_from_slots(scene.pbvh3.prim_map, scene.tris, *rays[:2],
                           *walk(scene.pbvh3, *rays, mode=mode))
    elif name == "bvh3anyv1":
        walk = bvh2.walk3_cuda_v1 if on_card else bvh2.walk3_twin
        return walk(scene.pbvh3, *rays, mode="any")[1] >= 0, None
    elif name == "triv1":
        walk = k2.stream_cuda_v1 if on_card else k2.stream_twin
        h = k2.hit_from_stream(scene.ptris, *walk(scene.ptris, *rays))
    elif name in V1_KERNELS:
        exact = bvh8.walk_cuda_v1 if on_card else bvh8.walk_twin
        if name == "bvh8anyv1":
            return exact(scene.pbvh8, *rays, latch=True)[1] >= 0, None
        fast = bvh8.walk_fast_cuda_v1 if on_card else bvh8.walk_fast_twin
        h = bvh8.intersect(scene.pbvh8, scene.tris, *rays, fast=name == "bvh8fastv1",
                           walks=(fast, exact))
    elif name == "bvh8":
        h = bvh8.intersect(scene.pbvh8, scene.tris, *rays, fast=False)
    elif name in ("bvh8fast", "bvh8fastq"):
        h = bvh8.intersect(scene.pbvh8, scene.tris, *rays, fast=True)
    elif name in ("bvh3", "bvh3skip"):
        h = bvh2.intersect_bvh3(scene.pbvh3, scene.tris, *rays, ordered=name == "bvh3")
    elif name in ("bvh", "bvh1"):
        h = bvh.hit_from_local(scene.pbvh, *bvh.walk_packet(scene.pbvh, *rays,
                                                           prune=name == "bvh"))
    elif name == "tri":
        h = k2.intersect_stream(scene.ptris, *rays)
    elif name == "gather":
        h = gather_bvh.intersect_bvh_gather(scene.gbvh, *rays)
    elif name == "gatherany":
        return gather_bvh.occluded_bvh_gather(scene.gbvh, *rays), None
    elif name == "bvh8any":
        return bvh8.occluded(scene.pbvh8, *rays), None
    else:
        return bvh2.occluded_bvh3(scene.pbvh3, *rays), None
    return h.prim >= 0, h.t


def make_rays(scene, n, kind, seed=0):
    """(o, d, tnear, tfar) of one ray kind (bench_isect.make_rays)."""
    dev = scene.tris.v0.device
    meta = scene.meta
    if kind == "coherent":
        reps = int(np.ceil(n / (meta.res_x * meta.res_y)))
        px = np.tile(np.tile(np.arange(meta.res_x), meta.res_y), reps)[:n]
        py = np.tile(np.repeat(np.arange(meta.res_y), meta.res_x), reps)[:n]
        smp = Sampler.create((1, 0), torch.arange(n, device=dev))
        u_cam, smp = smp.next_2d()
        o, d, _ = camera_rays_w(scene.camera, meta, torch.as_tensor(px, device=dev),
                                torch.as_tensor(py, device=dev), u_cam)
    else:
        v0 = scene.tris.v0.cpu().numpy()
        rng = np.random.default_rng(seed)
        o = rng.uniform(v0.min(0), v0.max(0), (n, 3)).astype(np.float32)
        dn = rng.normal(size=(n, 3)).astype(np.float32)
        o = torch.as_tensor(o, device=dev)
        d = torch.as_tensor(dn / np.linalg.norm(dn, axis=1, keepdims=True), device=dev)
    far = 0.0 if kind == "dead" else INF
    return (o.contiguous(), d.contiguous(), torch.full((n,), 1e-4, device=dev),
            torch.full((n,), far, device=dev))


def time_ms(fn, args, trials):
    """Median ms of fn(*args) over `trials` runs after one warm-up: CUDA
    events on a card, the host clock on the CPU."""
    fn(*args)
    times = []
    for _ in range(trials):
        if args[0].is_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _mask_agree(a, b):
    return (a == b).float().mean().item()


def _t_agree(ha, ta, hb, tb, rtol):
    both = ha & hb
    if not bool(both.any()):
        return 1.0
    return torch.isclose(ta[both], tb[both], rtol=rtol, atol=0.0).float().mean().item()


def load(scene_path, dev):
    """The scene at the benchmark's 250x141 (materialtest-synth by default)."""
    if scene_path is None:
        scene_path = synth.write_scene(os.path.join(_REPO, "build", "bench_isect"),
                                       "materialtest-synth")
    doc = load_scene(scene_path)
    doc.camera["resolution"] = list(RESOLUTION)
    return flatten_scene(doc, dev)


def run(scene_path=None, dev=None, n=131072, kernels=KERNELS, trials=5, twin_trials=None):
    """Time and check the walks; returns {"scene", "device", "n", "times":
    {(kind, kernel): {"ms", "twin_ms", "work"}}, "agree": {label: fraction}}.
    "ms" is None on the CPU, where only the twins run; "work" is the twin's
    count of box and triangle tests on the row's rays (for K2 and its first
    form also `sub_box_work`'s). `twin_trials` (default `trials`): the runs
    of each twin's median, which costs 10^2-10^3 times its kernel's."""
    kernels = parse_kernels(kernels)
    dev = dev or get_device("cuda")
    on_card = dev.type == "cuda"
    scene = load(scene_path, dev)
    out = {"scene": scene_path or "materialtest-synth", "n_tris": scene.tris.v0.shape[0],
           "device": torch.cuda.get_device_name(dev) if on_card else "cpu", "n": n,
           "times": {}, "agree": {}}
    coherent = None
    for kind in RAY_KINDS:
        rays = make_rays(scene, n, kind)
        if kind == "coherent":
            coherent = rays
        for name in kernels:
            kernel, twin = walks(scene, name)
            row = out["times"][(kind, name)] = {
                "ms": time_ms(kernel, rays, trials) if on_card else None,
                "twin_ms": time_ms(twin, rays, twin_trials or trials),
                "work": dict(twin.func.work)}
            if name in ("tri", "triv1"):  # what the kernel's sub-box cull leaves
                row["work"].update(k2.sub_box_work(scene.ptris, *rays))

    sub = make_rays(scene, 4096, "incoherent", seed=1)
    hb = intersect_brute(scene.tris, *sub, chunk=2048)
    hit_b = hb.prim >= 0
    for name in kernels:
        hit, t = query(scene, name, sub)
        out["agree"][f"{name} vs brute: hit mask"] = _mask_agree(hit, hit_b)
        if t is not None:
            out["agree"][f"{name} vs brute: t rtol 1e-3"] = _t_agree(hit, t, hit_b, hb.t, 1e-3)
    res = {name: query(scene, name, coherent) for name in kernels}
    if "bvh3" in res and "bvh" in res:
        (h3, t3), (h5, t5) = res["bvh3"], res["bvh"]
        out["agree"]["bvh3 vs bvh: hit mask"] = _mask_agree(h3, h5)
        out["agree"]["bvh3 vs bvh: t rtol 1e-4"] = _t_agree(h3, t3, h5, t5, 1e-4)
    for any_name, closest in ANY_OF.items():
        if any_name in res and closest in res:
            out["agree"][f"{any_name} vs {closest}: hit mask"] = _mask_agree(
                res[any_name][0], res[closest][0])
    hit_k2 = res["tri"][0] if "tri" in res else query(scene, "tri", coherent)[0]
    for name in kernels:
        if name != "tri":
            out["agree"][f"{name} vs tri ({n} coherent): hit mask"] = _mask_agree(
                res[name][0], hit_k2)
    return out


def report(res):
    """Print one line per (ray kind, kernel) and one per agreement."""
    print(f"scene {res['scene']}: {res['n_tris']} triangles, {RESOLUTION[0]}x{RESOLUTION[1]}; "
          f"{res['n']} rays; device {res['device']}")
    for (kind, name), r in res["times"].items():
        kern = (f"kernel {r['ms']:9.3f} ms {res['n'] / r['ms'] / 1e3:9.2f} Mrays/s"
                if r["ms"] is not None else "kernel       not run (CPU)")
        print(f"{kind:10s} {name:9s}: {kern} | twin {r['twin_ms']:10.3f} ms")
    for label, frac in res["agree"].items():
        print(f"agreement {label}: {frac:.6f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", default=None, help="scene.json (default: materialtest-synth)")
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    res = run(args.scene, get_device(args.device), args.n, args.kernels.split(","), args.trials)
    report(res)
    low = {k: v for k, v in res["agree"].items() if v < BAR}
    if low:
        raise SystemExit(f"agreement below {BAR}: {low}")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
