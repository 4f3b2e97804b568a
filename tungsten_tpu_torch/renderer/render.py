"""Render loop: spp-batched accumulation through a wavefront path tracer.

Port of tungsten_tpu/renderer/render.py (render_buffers:102-215, render_flat,
render_scene) with its `wavefront` argument: "regen" is the regenerating
wavefront (trace_regen_batch, per-pixel sums from the device), "lockstep"
the lockstep one (trace_batch, per-lane sums accumulated through the
lane -> pixel map), "auto" the JAX package's rule: regen on one device
unless a material has a forward lobe, lockstep then (the port has no device
mesh). Batches are capped by a static
`passes_per_batch`, which is what the JAX package does off the TPU (its
DispatchGovernor probes a TPU watchdog and is not ported). Adaptive sampling,
meshes of devices, several samples per pass and resume files are not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from ..integrators.path_tracer import trace_batch, trace_regen_batch
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
                   passes_per_batch: int = 32, wavefront: str = "auto") -> OutputBuffers:
    """Full render into OutputBuffers, `passes_per_batch` passes (one sample
    per pixel each) per batch, through the `wavefront` named."""
    meta = scene.meta
    if wavefront not in ("auto", "regen", "lockstep"):
        raise ValueError(f"wavefront {wavefront!r}: one of auto, regen, lockstep")
    use_regen = wavefront == "regen" or (wavefront == "auto" and not meta.has_forward)
    spp = spp if spp is not None else meta.spp
    dev = scene.shade_pack.device
    bufs = OutputBuffers(meta.res_x, meta.res_y)
    lanes = _lane_arrays(meta)
    pix_map = lanes[2]
    px, py, pix = (torch.as_tensor(a, device=dev) for a in lanes)
    lane = torch.arange(px.shape[0], device=dev)
    n_pix = meta.res_x * meta.res_y
    seed_pair = (seed & 0xFFFFFFFF, 0)
    done = 0
    while done < spp:
        nb = min(passes_per_batch, spp - done)
        if use_regen:
            rad = trace_regen_batch(scene, seed_pair, px, py, pix, done, n_passes=nb)
            bufs.add_pixel_sums(rad.cpu().numpy(), nb)
        else:
            rad = trace_batch(scene, seed_pair, lane, px, py, done, n_passes=nb)
            bufs.add_batch(rad.cpu().numpy(), nb, 1, n_pix, pix_map=pix_map)
        done += nb
    return bufs


def render_flat(scene: FlatScene, spp: int | None = None, seed: int = DEFAULT_SEED,
                passes_per_batch: int = 32, wavefront: str = "auto") -> np.ndarray:
    """Render and return the linear HDR framebuffer (H, W, 3) float32."""
    return render_buffers(scene, spp=spp, seed=seed, passes_per_batch=passes_per_batch,
                          wavefront=wavefront).color()


def render_scene(doc_or_path, device, spp=None, seed=DEFAULT_SEED, wavefront: str = "auto"):
    """Load + flatten + render on `device`; returns (linear_hdr, tonemapped_ldr01)."""
    doc = load_scene(doc_or_path) if isinstance(doc_or_path, str) else doc_or_path
    scene = flatten_scene(doc, device)
    hdr = render_flat(scene, spp=spp, seed=seed, wavefront=wavefront)
    ldr = tonemap(scene.meta.tonemap, torch.as_tensor(hdr)).numpy()
    return hdr, np.clip(ldr, 0.0, 1.0)
