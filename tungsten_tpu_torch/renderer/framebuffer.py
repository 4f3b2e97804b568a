"""Output buffers (host, numpy): per-pixel radiance sums and sample counts.

Port of the part of tungsten_tpu/renderer/framebuffer.py OutputBuffers that
the render paths use (add_pixel_sums for the regen wavefront, add_batch for
the lockstep one, color). The two-buffer halves, Welford variance, AOVs and
resume state wait for the features that read them.
"""
from __future__ import annotations

import numpy as np


class OutputBuffers:
    def __init__(self, res_x: int, res_y: int):
        self.res = (res_y, res_x)
        n = res_x * res_y
        self.sum = np.zeros((n, 3), np.float64)
        self.count = np.zeros(n, np.int64)

    def add_pixel_sums(self, rad, n_samples: int):
        """Accumulate one batch whose per-pixel reduction happened on the
        device: rad is the (n_pix, 3) radiance SUM over n_samples samples."""
        self.sum += np.asarray(rad, np.float64)
        self.count += n_samples

    def add_batch(self, rad_sum, n_passes: int, m: int, n_pix: int, pix_map=None):
        """Accumulate one batch of the lockstep wavefront: rad_sum is the
        per-lane SUM (m * n_pix, 3) over n_passes passes with m samples per
        pixel; pix_map maps lane -> pixel (None: lanes are m pixel grids in
        pixel order)."""
        rad_lanes = np.asarray(rad_sum, np.float64)[: m * n_pix]
        if pix_map is None:
            rad = rad_lanes.reshape(m, n_pix, 3).sum(0)
        else:
            rad = np.zeros((n_pix, 3), np.float64)
            np.add.at(rad, pix_map[: m * n_pix], rad_lanes)
        self.sum += rad
        self.count += n_passes * m

    def color(self) -> np.ndarray:
        h, w = self.res
        c = self.sum / np.maximum(self.count, 1)[:, None]
        return c.reshape(h, w, 3).astype(np.float32)
