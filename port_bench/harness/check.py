"""The comparison that decides `correct`: every frame the window rendered,
against the plain reference (reference/), block by block.

The frame and the reference's estimate are reduced to means over blocks of
BLOCK x BLOCK pixels, per channel. Each block's difference is divided by its
standard error: the reference's, from its own per-pixel sample variance over
its spp, and the frame's, taken as the same per-sample variance over the
frame's spp (the program's estimator has its own variance; quasi-random
samples give it less, so this errs wide), plus a floor of REL_FLOOR of the
block's mean for blocks with no noise (the sky). Three numbers are
compared, each the largest over the window's frames: `z_max`, the largest
|z| over a frame's blocks and channels (a fault in one place), `z2_mean`,
the mean of z^2 over them (a fault spread over the frame: about 1 where the
frame and the reference agree), and `noise`, the frame's own noise
measured against the reference's. A frame with a non-finite pixel reads
infinity in all three.

`noise` is measured, not modelled: the difference of two frames of the run
(seeded apart; frame k with frame k + 1, the last with the first) has the
variance twice the frame's, whatever the image holds. Over blocks of a
32nd of the frame's width (whole blocks only; SPPM's photons blur a pixel
into its neighbours, so single pixels would not do), each block mean of
the difference, squared and halved, is held against the block mean's
variance from the reference's per-sample variance at the frame's spp;
`noise` is the median over blocks and channels, over the median of
chi-square(1), so a firefly in one block moves it little. A frame that
took half the samples (or SPPM half the photons) that the rate counts
reads about twice what it should; its expectation, and so z, stay.
"""
from __future__ import annotations

import math

import numpy as np
import torch

BLOCK = 32
NOISE_BLOCKS_ACROSS = 32
CHI2_1_MEDIAN = 0.454936423119572
REL_FLOOR = 1e-3


def _block_sums(x: torch.Tensor, b: int):
    """(H, W, C) -> per-block sums (Hb, Wb, C) and pixel counts (Hb, Wb, 1)."""
    h, w, c = x.shape
    hb, wb = -(-h // b), -(-w // b)
    pad = torch.zeros((hb * b, wb * b, c), dtype=x.dtype, device=x.device)
    pad[:h, :w] = x
    ones = torch.zeros((hb * b, wb * b, 1), dtype=x.dtype, device=x.device)
    ones[:h, :w] = 1
    s = pad.reshape(hb, b, wb, b, c).sum((1, 3))
    n = ones.reshape(hb, b, wb, b, 1).sum((1, 3))
    return s, n


def compare(frame, ref_mean, ref_var, ref_spp: int, frame_spp: int,
            block: int = BLOCK) -> dict:
    """{"z_max", "z2_mean"} of frame's block means against the reference's."""
    dev = ref_mean.device
    f = torch.as_tensor(np.asarray(frame), device=dev).to(torch.float64)
    if not bool(torch.isfinite(f).all()):
        return {"z_max": math.inf, "z2_mean": math.inf}
    sf, n = _block_sums(f, block)
    sr, _ = _block_sums(ref_mean, block)
    sv, _ = _block_sums(ref_var, block)
    mf, mr = sf / n, sr / n
    var = sv / (n * n) * (1.0 / ref_spp + 1.0 / frame_spp)
    var = var + (REL_FLOOR * mr) ** 2 + 1e-18
    z = (mf - mr).abs() / torch.sqrt(var)
    return {"z_max": float(z.max()), "z2_mean": float((z * z).mean())}


def noise(frame, other, ref_var, frame_spp: int) -> float:
    """The median over blocks and channels of (the block mean of frame -
    other)^2 / 2 over the block mean's variance at the reference's
    per-sample variance and the frame's spp, divided by the median of
    chi-square with one degree of freedom: about 1 where the frame's noise
    is the reference estimator's at the frame's spp."""
    dev = ref_var.device
    a = torch.as_tensor(np.asarray(frame), device=dev).to(torch.float64)
    b = torch.as_tensor(np.asarray(other), device=dev).to(torch.float64)
    d = a - b
    if not bool(torch.isfinite(d).all()):
        return math.inf
    block = max(1, d.shape[1] // NOISE_BLOCKS_ACROSS)
    sd, n = _block_sums(d, block)
    sv, _ = _block_sums(ref_var, block)
    keep = (sv > 0).logical_and(n == block * block)
    if not bool(keep.any()):
        return math.inf
    z2 = (sd * sd)[keep] / (2.0 * sv[keep] / frame_spp)
    return float(z2.median()) / CHI2_1_MEDIAN


def judge(images, extra, ref_mean, ref_var, ref_spp: int, frame_spp: int) -> list:
    """The compared numbers of each of the window's frames: compare()'s and
    the noise of frame k paired with frame k + 1 (the last with the first;
    `extra`, frames rendered for the check alone, follow the window's)."""
    frames = list(images) + list(extra)
    out = []
    for k, im in enumerate(images):
        r = compare(im, ref_mean, ref_var, ref_spp, frame_spp)
        r["noise"] = noise(im, frames[(k + 1) % len(frames)], ref_var, frame_spp)
        out.append(r)
    return out


def reference_image(scene_path: str, mode: str, spp: int, seed: int, device, dtype=torch.float32,
                    **kw):
    """The reference's (mean, per-sample variance), each (H, W, 3) float64
    on `device`, from the scene files alone, and the scene's triangle count."""
    from reference.render import Reference
    from reference.scene import load

    ref = Reference(load(scene_path, device, dtype))
    return (*ref.render(spp, seed, mode, **kw), int(ref.sc.v0.shape[0]))

