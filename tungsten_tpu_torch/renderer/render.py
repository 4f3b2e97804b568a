"""Render driver: spp-batched accumulation through the regen path tracer.

Port of the regen branch of tungsten_tpu/renderer/render.py
(render_buffers:149-191, render_flat, render_scene). Batches are capped by
a static `passes_per_batch`, which is what the JAX package does off the TPU
(its DispatchGovernor probes a TPU watchdog and is not ported). Adaptive
sampling, meshes of devices and resume files are not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from ..integrators.path_tracer import trace_regen_batch
from ..models.cameras.tonemap import tonemap
from ..scene.flatten import FlatScene, flatten_scene
from ..scene.load import load_scene
from .framebuffer import OutputBuffers

DEFAULT_SEED = 0xBA5EBA11
TILE = 16  # lanes are ordered in 16x16 image tiles (render.py _lane_arrays)


def _lane_arrays(meta):
    """Lane -> pixel maps in the JAX package's 16x16-tile order (one sample
    per pixel per pass). The order decides which path id, and so which RNG
    stream, each pixel's samples receive; it is kept for per-pixel parity."""
    w, h = meta.res_x, meta.res_y
    xs, ys = np.meshgrid(np.arange(w, dtype=np.int64), np.arange(h, dtype=np.int64))
    tile_id = (ys // TILE) * ((w + TILE - 1) // TILE) + (xs // TILE)
    order = np.argsort(tile_id.ravel(), kind="stable")
    px = xs.ravel()[order]
    py = ys.ravel()[order]
    return px, py, py * w + px


def render_buffers(scene: FlatScene, spp: int | None = None, seed: int = DEFAULT_SEED,
                   passes_per_batch: int = 32) -> OutputBuffers:
    """Full render into OutputBuffers through the regenerating wavefront,
    `passes_per_batch` passes (one sample per pixel each) per batch."""
    meta = scene.meta
    spp = spp if spp is not None else meta.spp
    dev = scene.shade_pack.device
    bufs = OutputBuffers(meta.res_x, meta.res_y)
    px, py, pix = (torch.as_tensor(a, device=dev) for a in _lane_arrays(meta))
    seed_pair = (seed & 0xFFFFFFFF, 0)
    done = 0
    while done < spp:
        nb = min(passes_per_batch, spp - done)
        rad = trace_regen_batch(scene, seed_pair, px, py, pix, done, n_passes=nb)
        bufs.add_pixel_sums(rad.cpu().numpy(), nb)
        done += nb
    return bufs


def render_flat(scene: FlatScene, spp: int | None = None, seed: int = DEFAULT_SEED,
                passes_per_batch: int = 32) -> np.ndarray:
    """Render and return the linear HDR framebuffer (H, W, 3) float32."""
    return render_buffers(scene, spp=spp, seed=seed, passes_per_batch=passes_per_batch).color()


def render_scene(doc_or_path, device, spp=None, seed=DEFAULT_SEED):
    """Load + flatten + render on `device`; returns (linear_hdr, tonemapped_ldr01)."""
    doc = load_scene(doc_or_path) if isinstance(doc_or_path, str) else doc_or_path
    scene = flatten_scene(doc, device)
    hdr = render_flat(scene, spp=spp, seed=seed)
    ldr = tonemap(scene.meta.tonemap, torch.as_tensor(hdr)).numpy()
    return hdr, np.clip(ldr, 0.0, 1.0)
