"""Render driver: spp-batched accumulation, adaptive sampling, AOVs,
checkpoint / resume.

Port of tungsten_tpu/renderer/render.py (render_buffers:102-215,
_tile_error, _sample_pixels_by_tile, render_flat, render_scene) with its
`wavefront` argument: "regen" is the regenerating wavefront
(trace_regen_batch, per-pixel sums from the device), "lockstep" the
lockstep one (trace_batch, per-lane sums accumulated through the lane ->
pixel map), "auto" the JAX package's rule: regen on one device unless a
material has a forward lobe, lockstep then (the port has no device mesh).
Batches are capped by a static `passes_per_batch`, which is what the JAX
package does off the TPU (its DispatchGovernor probes a TPU watchdog and is
not ported). A pass traces `samples_per_pass` samples a pixel; the pass
index keys every sample's RNG stream, so a render resumed from a state file
equals one rendered straight through.

Adaptive sampling mirrors PathTraceIntegrator.cpp:44-134: once every pixel
has ADAPTIVE_THRESHOLD_SPP samples, each pass spends its budget of n_pix *
samples_per_pass lockstep lanes on pixels drawn by a per-4x4-tile relative
error (two-buffer variance) with a 95th-percentile clamp and neighbour
dilation.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..integrators.path_tracer import trace_batch, trace_regen_batch
from ..models.cameras.tonemap import tonemap
from ..scene.flatten import FlatScene, flatten_scene
from ..scene.load import load_scene
from .framebuffer import OutputBuffers

DEFAULT_SEED = 0xBA5EBA11
ADAPTIVE_THRESHOLD_SPP = 16  # PathTraceIntegrator.hpp:27-29
TILE = 16  # lanes are ordered in 16x16 image tiles (render.py _lane_arrays)


def _lane_arrays(meta, m: int = 1):
    """Lane -> pixel maps in the JAX package's 16x16-tile order, the tile
    order repeated m times (m samples a pixel a pass): (px, py, pixel
    index). The order decides which path id, and so which RNG stream, each
    pixel's samples receive; it is kept for per-pixel parity."""
    w, h = meta.res_x, meta.res_y
    xs, ys = np.meshgrid(np.arange(w, dtype=np.int64), np.arange(h, dtype=np.int64))
    tile_id = (ys // TILE) * ((w + TILE - 1) // TILE) + (xs // TILE)
    order = np.argsort(tile_id.ravel(), kind="stable")
    px = np.tile(xs.ravel()[order], m)
    py = np.tile(ys.ravel()[order], m)
    return px, py, py * w + px


def _numpy(aux):
    """The tracers' AOV sums on the host (None without AOVs)."""
    return None if aux is None else {k: v.cpu().numpy() for k, v in aux.items()}


def render_buffers(scene: FlatScene, spp: int | None = None, seed: int = DEFAULT_SEED,
                   verbose: bool = False, samples_per_pass: int = 1, passes_per_batch: int = 32,
                   adaptive: bool = False, resume_file: str | None = None,
                   scene_hash_value: str = "", checkpoint_cb=None,
                   checkpoint_interval: float = 0.0, wavefront: str = "auto") -> OutputBuffers:
    """Full render into OutputBuffers (color, AOVs, halves, variance).
    resume_file: a state file to continue from (when its scene hash is
    `scene_hash_value`) and to save to at the end; checkpoint_cb(bufs,
    passes done) runs after a batch once checkpoint_interval seconds have
    passed since the last."""
    meta = scene.meta
    if wavefront not in ("auto", "regen", "lockstep"):
        raise ValueError(f"wavefront {wavefront!r}: one of auto, regen, lockstep")
    use_regen = wavefront == "regen" or (wavefront == "auto" and not meta.has_forward)
    spp = spp if spp is not None else meta.spp
    w, h = meta.res_x, meta.res_y
    n_pix = w * h
    m = samples_per_pass
    aov_names = tuple(a[0] for a in meta.aovs)
    bufs = OutputBuffers(w, h, aovs=aov_names)

    start_pass = 0
    if resume_file:
        extra = bufs.load_state(resume_file, scene_hash_value)
        if extra is not None:
            start_pass = int(extra.get("next_pass", 0))
            if verbose:
                print(f"  resumed at pass {start_pass}")

    dev = scene.shade_pack.device
    lanes = _lane_arrays(meta, m)
    pix_map = lanes[2]
    px, py, pix = (torch.as_tensor(a, device=dev) for a in lanes)
    lane = torch.arange(px.shape[0], device=dev)
    seed_pair = (seed & 0xFFFFFFFF, 0)
    total_passes = (spp + m - 1) // m
    done = start_pass
    t0 = time.time()
    last_ckpt = t0
    rng = np.random.default_rng(seed ^ 0x5EED)
    while done < total_passes:
        if adaptive and bufs.count.min() >= ADAPTIVE_THRESHOLD_SPP:
            # one pass of budget, allocated by tile error
            err = _tile_error(bufs, w, h)
            p = err.ravel() / max(err.sum(), 1e-20)
            pix_sel = _sample_pixels_by_tile(p, w, h, rng, n_pix * m)
            px_a = torch.as_tensor(pix_sel % w, device=dev)
            py_a = torch.as_tensor(pix_sel // w, device=dev)
            out = trace_batch(scene, seed_pair, torch.arange(len(pix_sel), device=dev), px_a,
                              py_a, done, n_passes=1)
            rad = out[0] if aov_names else out
            bufs.add_batch_sparse(rad.cpu().numpy(), pix_sel)
            done += 1
        elif use_regen:
            nb = max(1, min(passes_per_batch, total_passes - done))
            out = trace_regen_batch(scene, seed_pair, px, py, pix, done, n_passes=nb)
            rad, aux = out if aov_names else (out, None)
            bufs.add_pixel_sums(rad.cpu().numpy(), nb * m, _numpy(aux))
            done += nb
        else:
            nb = max(1, min(passes_per_batch, total_passes - done))
            out = trace_batch(scene, seed_pair, lane, px, py, done, n_passes=nb)
            rad, aux = out if aov_names else (out, None)
            bufs.add_batch(rad.cpu().numpy(), nb, m, n_pix, _numpy(aux), pix_map=pix_map)
            done += nb
        if verbose:
            dt = time.time() - t0
            rate = n_pix * m * (done - start_pass) / dt / 1e6
            print(f"  spp {min(done * m, spp)}/{total_passes * m}  ({dt:.1f}s, {rate:.2f} "
                  f"Mpaths/s)")
        if (checkpoint_cb and checkpoint_interval > 0
                and time.time() - last_ckpt > checkpoint_interval):
            checkpoint_cb(bufs, done)
            last_ckpt = time.time()

    if resume_file:
        bufs.save_state(resume_file, scene_hash_value, {"next_pass": done})
    return bufs


def _tile_error(bufs, w, h):
    """4x4-tile relative error from the two-buffer variance, with a 95th
    percentile clamp and neighbour dilation (PathTraceIntegrator.cpp:44-85)."""
    var = bufs.pixel_variance()
    mean = bufs.color().mean(-1)
    rel = var / np.maximum(mean * mean, 1e-4)
    th, tw = (h + 3) // 4, (w + 3) // 4
    rel = np.pad(rel, ((0, th * 4 - h), (0, tw * 4 - w)))
    tiles = rel.reshape(th, 4, tw, 4).mean((1, 3))
    clamp = np.percentile(tiles, 95)
    tiles = np.minimum(tiles, max(clamp, 1e-20))
    d = np.maximum(tiles, np.roll(tiles, 1, 0))
    d = np.maximum(d, np.roll(tiles, -1, 0))
    d = np.maximum(d, np.roll(tiles, 1, 1))
    d = np.maximum(d, np.roll(tiles, -1, 1))
    return d + 1e-12


def _sample_pixels_by_tile(tile_p, w, h, rng, budget):
    """`budget` pixel indices: a tile drawn by tile_p, then a pixel of it."""
    tw = (w + 3) // 4
    tiles = rng.choice(len(tile_p), size=budget, p=tile_p)
    ty, tx = tiles // tw, tiles % tw
    x = np.minimum(tx * 4 + rng.integers(0, 4, len(tiles)), w - 1)
    y = np.minimum(ty * 4 + rng.integers(0, 4, len(tiles)), h - 1)
    return (y * w + x).astype(np.int64)


def render_flat(scene: FlatScene, spp: int | None = None, seed: int = DEFAULT_SEED,
                verbose: bool = False, samples_per_pass: int = 1, passes_per_batch: int = 32,
                adaptive: bool = False, wavefront: str = "auto") -> np.ndarray:
    """Render and return the linear HDR framebuffer (H, W, 3) float32."""
    return render_buffers(scene, spp=spp, seed=seed, verbose=verbose,
                          samples_per_pass=samples_per_pass, passes_per_batch=passes_per_batch,
                          adaptive=adaptive, wavefront=wavefront).color()


def render_scene(doc_or_path, device, spp=None, seed=DEFAULT_SEED, verbose=False,
                 wavefront: str = "auto"):
    """Load + flatten + render on `device`; returns (linear_hdr, tonemapped_ldr01)."""
    doc = load_scene(doc_or_path) if isinstance(doc_or_path, str) else doc_or_path
    scene = flatten_scene(doc, device)
    hdr = render_flat(scene, spp=spp, seed=seed, verbose=verbose, wavefront=wavefront)
    ldr = tonemap(scene.meta.tonemap, torch.as_tensor(hdr)).numpy()
    return hdr, np.clip(ldr, 0.0, 1.0)
