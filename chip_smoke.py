#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (tungsten_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero without
printing a result):
  1. device   - the card's name and power limit;
  2. build    - nvcc builds the three walks (csrc/bvh8_walk.cu, bvh2_walk.cu,
                bvh_walk.cu) into build/, one nvcc per source, all at once;
  3. kernel   - the BVH8 walk (K3) against its plain PyTorch twin at the
                slice's shapes on the materialtest-synth pack (65,536 random
                rays and the 2N = 1,126,000-lane mixed shadow + camera batch)
                and against brute force on 8,192 rays; times both at 2N;
  3b. kernels - K4 (bvh2_walk: ordered, skip, any) and K5 (bvh_walk) on the
                same scene's packs, each against its twin on the 65,536
                random rays and the 563,000 camera rays, and through its
                public query against brute force on the 8,192 rays; each
                kernel's launch count must move there and its twin's not;
  4. small    - the `small` scene through render_scene, its per-channel
                means against the JAX package's (tests/data/...json);
  5. slice    - materialtest-synth at 1000x563 and 32 spp through
                load_scene / flatten_scene / render_flat, with the walk's
                launch counts reset just before and read just after;
  6. isect    - the intersector benchmark (tungsten_tpu_torch.tools.bench_isect)
                at n = 131,072 on both ray kinds and the all-dead case, all six
                walks, with every agreement >= 99.9% and the K4 / K5 launch
                counts reset just before and read just after.
The kernels line gives, per kernel: the launches of its main path (the
render for K3, the benchmark for K4 / K5), the largest |t| difference
against its twin (2N batch for K3, camera rays for K4 / K5), and the kernel's
and twin's ms (2N batch for K3, the benchmark's coherent rays for K4 / K5).
It needs nvcc and one CUDA card, no network and no JAX. The last line is the
JSON result; the line before it the card's name and power limit.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

BAR = 0.999  # prim / occlusion agreement, kernel vs twin and vs brute force
# t where prim agrees: >= 99.9% of hits within rtol 1e-5 plus an absolute
# floor of 1e-6 per unit of scene extent, all within rtol 1e-3. The plane
# form's numerator N.o + nc cancels to the point-plane distance, so its error
# is absolute (~eps * |o|) and grows as 1 / |cos| on grazing hits; the kernel
# fuses multiply-adds where the twin does not.
T_RTOL, T_ATOL_PER_EXTENT, T_RTOL_ALL = 1e-5, 1e-6, 1e-3
MEAN_RTOL = 5e-3  # small render per-channel means vs the JAX package's
# K5's u / v where the slot agrees: >= 99.9% within 1e-5, all within 1e-3.
# Moller-Trumbore's u = (tv . p) / det cancels, so any other rounding shows;
# the kernel rounds each operation as the twin does (bvh_walk.cu header).
UV_ATOL, UV_ATOL_ALL = 1e-5, 1e-3
# the K4 / K5 walks: (json name, benchmark name, source, the TPU kernel it replaces)
NEW_KERNELS = (
    ("bvh2_walk_ordered", "bvh3", "tungsten_tpu_torch/csrc/bvh2_walk.cu",
     "tungsten_tpu/ops/pallas_bvh2.py:204"),
    ("bvh2_walk_skip", "bvh3skip", "tungsten_tpu_torch/csrc/bvh2_walk.cu",
     "tungsten_tpu/ops/pallas_bvh2.py:126"),
    ("bvh2_walk_any", "bvh3any", "tungsten_tpu_torch/csrc/bvh2_walk.cu",
     "tungsten_tpu/ops/pallas_bvh2.py:168"),
    ("bvh_walk", "bvh", "tungsten_tpu_torch/csrc/bvh_walk.cu",
     "tungsten_tpu/ops/pallas_bvh.py:298"),
)


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)
    log(f"  ok: {msg}")


def t_close(a, b, atol):
    """The t bar above, as one boolean."""
    near = torch.isclose(a, b, rtol=T_RTOL, atol=atol).float().mean().item() >= BAR
    return near and bool(torch.isclose(a, b, rtol=T_RTOL_ALL, atol=0.0).all())


def reset_k4_k5_counts():
    """Set the launch counts of the K4 (per mode) and K5 kernels and twins to 0."""
    from tungsten_tpu_torch.ops import bvh, bvh2

    for k in (bvh2.walk3_cuda, bvh2.walk3_twin):
        k.launches = dict.fromkeys(bvh2.MODES, 0)
    bvh.walk_packet_cuda.launches = bvh.walk_packet_twin.launches = 0


def cuda_ms(fn, reps):
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a card")
    from tungsten_tpu_torch import device
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.ops import _build, bvh8
    from tungsten_tpu_torch.ops.intersect import INF, intersect_brute
    from tungsten_tpu_torch.renderer.render import DEFAULT_SEED, render_flat, render_scene
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    dev = device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1 device] {kind}; nvidia-smi: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.time()
    sources = ("bvh8_walk", "bvh2_walk", "bvh_walk")
    _build.build(*sources)
    for name in sources:
        _build.load_library(name)
    log(f"[2 build] {', '.join(sources)} built in {time.time() - t0:.2f} s (nvcc, sm_90a, "
        f"in parallel)")

    work = os.path.join(REPO, "build", "chip_smoke")  # scenes are written here
    big_path = synth.write_scene(os.path.join(work, "mt"), "materialtest-synth")
    t0 = time.time()
    scene = flatten_scene(load_scene(big_path), dev)
    n_tris = scene.tris.v0.shape[0]
    log(f"[3 kernel] materialtest-synth flattened in {time.time() - t0:.1f} s: "
        f"{n_tris} triangles, {scene.pbvh8.kid_t.shape[0]} BVH8 nodes, "
        f"{scene.pbvh8.tri_planes.shape[0]} leaves")
    pack = scene.pbvh8
    gen = np.random.default_rng(0)
    lo = scene.tris.v0.min(0).values.cpu().numpy() - 0.5
    hi = scene.tris.v0.max(0).values.cpu().numpy() + 0.5
    T_ATOL = T_ATOL_PER_EXTENT * float(np.abs(np.concatenate([lo, hi])).max())

    def rand_rays(n):
        o = torch.tensor(gen.uniform(lo, hi, (n, 3)), dtype=torch.float32, device=dev)
        d = torch.tensor(gen.normal(size=(n, 3)), dtype=torch.float32, device=dev)
        return (o, d / d.norm(dim=1, keepdim=True), torch.full((n,), 1e-4, device=dev),
                torch.full((n,), INF, device=dev))

    def agree(a, b):
        return (a == b).float().mean().item()

    # 65,536 random incoherent rays: closest hit and occlusion
    rays = rand_rays(65536)
    tk, lk = bvh8.walk_cuda(pack, *rays)
    torch.cuda.synchronize()
    tt, lt = bvh8.walk_twin(pack, *rays)
    check(agree(lk, lt) >= BAR, f"random 65536: kernel vs twin prim agree {agree(lk, lt):.6f}")
    same = (lk == lt) & (lk >= 0)
    check(t_close(tk[same], tt[same], T_ATOL),
          f"random 65536: t within rtol {T_RTOL} atol {T_ATOL:.2g} (>= {BAR}), rtol {T_RTOL_ALL} (all)")
    ok_k = bvh8.occluded(pack, *rays)
    ok_t = bvh8.walk_twin(pack, *rays, latch=True)[1] >= 0
    check(agree(ok_k, ok_t) >= BAR, f"random 65536: occlusion agree {agree(ok_k, ok_t):.6f}")

    # brute force on 8,192 rays
    sub = [x[:8192] for x in rays]
    hb = intersect_brute(scene.tris, *sub, chunk=2048)
    hk = bvh8.intersect(pack, scene.tris, *sub)
    check(agree(hk.prim, hb.prim) >= BAR, f"8192 rays: kernel vs brute force prim agree "
          f"{agree(hk.prim, hb.prim):.6f}")

    # the slice's 2N mixed batch: 563,000 camera rays (closest) + 563,000
    # latched shadow-like rays from their hit points toward random upper
    # directions (dead where the camera ray missed)
    from tungsten_tpu_torch.models.cameras.pinhole import camera_rays_w

    meta = scene.meta
    n_pix = meta.res_x * meta.res_y
    pix = torch.arange(n_pix, device=dev)
    u = torch.tensor(gen.random((n_pix, 2)), dtype=torch.float32, device=dev)
    oc, dc, _ = camera_rays_w(scene.camera, meta, pix % meta.res_x, pix // meta.res_x, u, u)
    oc = oc.contiguous()
    near = torch.full((n_pix,), 1e-4, device=dev)
    hc = bvh8.intersect(pack, scene.tris, oc, dc, near, torch.full((n_pix,), INF, device=dev))
    ps = oc + dc * torch.where(hc.prim >= 0, hc.t, 0.0)[:, None]
    ds = torch.tensor(gen.normal(size=(n_pix, 3)), dtype=torch.float32, device=dev)
    ds[:, 1] = ds[:, 1].abs()
    ds = ds / ds.norm(dim=1, keepdim=True)
    o2 = torch.cat([ps, oc]).contiguous()
    d2 = torch.cat([ds, dc]).contiguous()
    n2 = torch.cat([torch.full((n_pix,), 5e-4, device=dev), near])
    f2 = torch.cat([torch.where(hc.prim >= 0, INF, 0.0), torch.full((n_pix,), INF, device=dev)])
    latch = torch.cat([torch.ones(n_pix, dtype=torch.bool, device=dev),
                       torch.zeros(n_pix, dtype=torch.bool, device=dev)])
    tk, lk = bvh8.walk_cuda(pack, o2, d2, n2, f2, latch)
    torch.cuda.synchronize()
    tt, lt = bvh8.walk_twin(pack, o2, d2, n2, f2, latch)
    blocked_agree = agree(lk[:n_pix] >= 0, lt[:n_pix] >= 0)
    prim_agree = agree(lk[n_pix:], lt[n_pix:])
    check(blocked_agree >= BAR, f"2N={2 * n_pix}: shadow occlusion agree {blocked_agree:.6f}")
    check(prim_agree >= BAR, f"2N={2 * n_pix}: camera prim agree {prim_agree:.6f}")
    same = (lk[n_pix:] == lt[n_pix:]) & (lk[n_pix:] >= 0)
    t_err = (tk[n_pix:][same] - tt[n_pix:][same]).abs()
    check(t_close(tk[n_pix:][same], tt[n_pix:][same], T_ATOL),
          f"2N: camera t within rtol {T_RTOL} atol {T_ATOL:.2g} (>= {BAR}), rtol {T_RTOL_ALL} "
          f"(all); max abs err {t_err.max().item():.3e}")
    max_abs_err = t_err.max().item()
    ms = cuda_ms(lambda: bvh8.walk_cuda(pack, o2, d2, n2, f2, latch), reps=10)
    plain_ms = cuda_ms(lambda: bvh8.walk_twin(pack, o2, d2, n2, f2, latch), reps=1)
    log(f"[3 kernel] 2N={2 * n_pix} mixed walk on {card}: CUDA kernel {ms:.3f} ms, "
        f"plain PyTorch twin {plain_ms:.3f} ms")

    # K4 and K5 on the same scene: kernel vs twin, public query vs brute force
    from tungsten_tpu_torch.ops import bvh, bvh2
    from tungsten_tpu_torch.tools import bench_isect

    log(f"[3b kernels] K4 and K5 on materialtest-synth: {scene.pbvh3.n_nodes} binary nodes, "
        f"{scene.pbvh.tri_t.shape[0]} leaves")
    cam = (oc, dc, near, torch.full((n_pix,), INF, device=dev))
    new_err = {}
    for name, bname, _, _ in NEW_KERNELS:
        kernel, twin = bench_isect.walks(scene, bname)
        for label, rr in (("random 65536", rays), (f"camera {n_pix}", cam)):
            out_k = kernel(*rr)
            torch.cuda.synchronize()
            out_t = twin(*rr)
            (tk, lk), (tt, lt) = out_k[:2], out_t[:2]
            check(agree(lk, lt) >= BAR, f"{name} {label}: kernel vs twin slot agree "
                  f"{agree(lk, lt):.6f}")
            same = (lk == lt) & (lk >= 0)
            t_err = (tk[same] - tt[same]).abs().max().item()
            check(t_close(tk[same], tt[same], T_ATOL), f"{name} {label}: t within rtol {T_RTOL} "
                  f"atol {T_ATOL:.2g} (>= {BAR}), rtol {T_RTOL_ALL} (all); max abs err {t_err:.3e}")
            for uv, a, b in zip("uv", out_k[2:], out_t[2:]):
                err = (a[same] - b[same]).abs()
                check((err <= UV_ATOL).float().mean().item() >= BAR
                      and err.max().item() <= UV_ATOL_ALL,
                      f"{name} {label}: {uv} within {UV_ATOL} (>= {BAR}), {UV_ATOL_ALL} (all); "
                      f"max abs err {err.max().item():.3e}")
        new_err[name] = t_err  # camera rays
    reset_k4_k5_counts()
    for label, prim in (("K4 ordered", bvh2.intersect_bvh3(scene.pbvh3, scene.tris, *sub).prim),
                        ("K4 skip", bvh2.intersect_bvh3(scene.pbvh3, scene.tris, *sub,
                                                        ordered=False).prim),
                        ("K5", bvh.intersect_bvh(scene.pbvh, *sub).prim)):
        check(agree(prim, hb.prim) >= BAR, f"8192 rays: {label} vs brute force prim agree "
              f"{agree(prim, hb.prim):.6f}")
    occ = bvh2.occluded_bvh3(scene.pbvh3, *sub)
    check(agree(occ, hb.prim >= 0) >= BAR, f"8192 rays: K4 any vs brute force occlusion agree "
          f"{agree(occ, hb.prim >= 0):.6f}")
    counts = (bvh2.walk3_cuda.launches, bvh2.walk3_twin.launches,
              bvh.walk_packet_cuda.launches, bvh.walk_packet_twin.launches)
    check(all(v == 1 for v in counts[0].values()) and not any(counts[1].values())
          and counts[2] == 1 and counts[3] == 0,
          f"8192 rays: the queries launched the kernels {counts[0]}, {counts[2]}, "
          f"the twins {counts[1]}, {counts[3]}")

    # small render against the JAX package's means
    with open(os.path.join(REPO, "tests", "data", "torch_port_small_ref.json")) as f:
        ref = json.load(f)
    small_path = synth.write_scene(os.path.join(work, "small"), "small")
    log("[4 small] render_scene of the small scene")
    bvh8.walk_cuda.launches = bvh8.walk_twin.launches = 0
    hdr, _ = render_scene(small_path, dev, seed=ref["seed"])
    k_small, t_small = bvh8.walk_cuda.launches, bvh8.walk_twin.launches
    check(k_small > 0 and t_small == 0, f"small: kernel launches {k_small}, twin {t_small}")
    check(np.isfinite(hdr).all() and (hdr >= 0).all(), "small: image finite and non-negative")
    means = hdr.reshape(-1, 3).astype(np.float64).mean(0)
    rel = np.abs(means - ref["channel_means"]) / np.abs(ref["channel_means"])
    check((rel <= MEAN_RTOL).all(), f"small: channel means {means.round(6).tolist()} vs JAX "
          f"{np.round(ref['channel_means'], 6).tolist()} (rel {rel.max():.2e} <= {MEAN_RTOL})")

    # the full slice: materialtest-synth, 1000x563, 32 spp
    log("[5 slice] load_scene + flatten_scene + render_flat of materialtest-synth")
    scene = flatten_scene(load_scene(big_path), dev)
    spp = scene.meta.spp
    torch.cuda.synchronize()
    bvh8.walk_cuda.launches = bvh8.walk_twin.launches = 0
    t0 = time.time()
    img = render_flat(scene, spp=spp, seed=DEFAULT_SEED)
    dt = time.time() - t0
    launches, twin = bvh8.walk_cuda.launches, bvh8.walk_twin.launches
    check(launches > 0 and twin == 0, f"slice: kernel launches {launches}, twin {twin}")
    check(img.shape == (meta.res_y, meta.res_x, 3) and np.isfinite(img).all()
          and (img >= 0).all(), f"slice: {img.shape} image finite and non-negative")
    check(0.0 < float(img.mean()) < 1e3, f"slice: image mean {img.mean():.6f}")
    rate = n_pix * spp / dt / 1e6
    log(f"[5 slice] materialtest-synth {meta.res_x}x{meta.res_y} {spp} spp in {dt:.2f} s: "
        f"{rate:.4f} Mpaths/s on {card}")

    # the intersector benchmark: every walk on the same rays
    log("[6 isect] tungsten_tpu_torch.tools.bench_isect on materialtest-synth, n = 131072")
    reset_k4_k5_counts()
    t0 = time.time()
    res = bench_isect.run(big_path, dev, n=131072, kernels=bench_isect.KERNELS, trials=5)
    new_launches = dict(bvh2.walk3_cuda.launches, packet=bvh.walk_packet_cuda.launches)
    bench_isect.report(res)
    check(len(res["times"]) == 18 and all(
        r["ms"] > 0.0 and r["twin_ms"] > 0.0 for r in res["times"].values()),
        f"isect: kernel and twin times for 3 ray kinds x 6 walks in {time.time() - t0:.1f} s")
    check(min(res["agree"].values()) >= BAR, f"isect: all {len(res['agree'])} agreements >= "
          f"{BAR} (lowest {min(res['agree'].values()):.6f})")
    check(all(v > 0 for v in new_launches.values()), f"isect: K4 / K5 launches {new_launches}")

    entries = [{
        "name": "bvh8_walk", "route": "cuda",
        "source": "tungsten_tpu_torch/csrc/bvh8_walk.cu",
        "replaces": "tungsten_tpu/ops/pallas_bvh8.py:130",
        "launches": launches, "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
    }]
    for (name, bname, source, replaces), n_launch in zip(NEW_KERNELS, new_launches.values()):
        r = res["times"][("coherent", bname)]
        entries.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": n_launch, "max_abs_err": new_err[name], "ms": r["ms"],
                        "plain_ms": r["twin_ms"]})
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
