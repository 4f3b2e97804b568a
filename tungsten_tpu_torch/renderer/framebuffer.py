"""Output buffers (host, numpy): per-pixel radiance sums and sample counts.

Port of the part of tungsten_tpu/renderer/framebuffer.py OutputBuffers that
the regen render path uses (add_pixel_sums, color). The two-buffer halves,
Welford variance, AOVs and resume state wait for the features that read them.
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

    def color(self) -> np.ndarray:
        h, w = self.res
        c = self.sum / np.maximum(self.count, 1)[:, None]
        return c.reshape(h, w, 3).astype(np.float32)
