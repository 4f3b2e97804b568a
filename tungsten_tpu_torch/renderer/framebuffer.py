"""Output buffers (host, numpy): accumulation, AOVs, two-buffer halves and
online variance, checkpoint / resume state.

Port of tungsten_tpu/renderer/framebuffer.py, whole (OutputBuffer.hpp:
20-220): per-pixel sums and sample counts, the A / B halves (odd / even
batches) whose difference estimates the pixel variance, Welford's online
variance of the batch means, the AOV sums (depth, normal, albedo) with
their halves, and the resume state: an npz with a JSON header guarded by
the scene hash (Integrator.cpp:94-162), in the JAX package's layout, so a
state file written by either package loads in the other. One departure:
the state carries `aov_count` too (the JAX package's leaves it out, and
there a resumed render divides the whole AOV sums by the resumed batches'
samples only); a state file without it resumes as in the JAX package.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np


AOV_NAMES = ("depth", "normal", "albedo", "visibility")


class OutputBuffers:
    def __init__(self, res_x: int, res_y: int, aovs=(), twobuffer=True, variance=True):
        self.res = (res_y, res_x)
        n = res_x * res_y
        self.sum = np.zeros((n, 3), np.float64)
        self.count = np.zeros(n, np.int64)
        self.twobuffer = twobuffer
        self.variance = variance
        if twobuffer:
            self.sum_a = np.zeros((n, 3), np.float64)
            self.sum_b = np.zeros((n, 3), np.float64)
            self.count_a = np.zeros(n, np.int64)
            self.count_b = np.zeros(n, np.int64)
        if variance:
            self.mean = np.zeros((n, 3), np.float64)
            self.m2 = np.zeros((n, 3), np.float64)
        self.aovs = {k: np.zeros((n, 3 if k in ("normal", "albedo") else 1), np.float64)
                     for k in aovs}
        # A/B halves per AOV: NFOR's feature prefilter needs two-buffer
        # feature variance (denoiser.cpp:147-180 loads featureA/B/variance)
        self.aovs_a = {k: np.zeros_like(v) for k, v in self.aovs.items()} if twobuffer else {}
        self.aovs_b = {k: np.zeros_like(v) for k, v in self.aovs.items()} if twobuffer else {}
        self.aov_count = np.zeros(n, np.int64) if aovs else None
        self.passes = 0

    def add_batch(self, rad_sum, n_passes, m, n_pix, aux=None, pix_map=None):
        """Accumulate one uniform batch: rad_sum is the per-lane SUM over
        n_passes passes with m samples per pixel. pix_map: lane -> pixel."""
        rad_lanes = np.asarray(rad_sum, np.float64)[: m * n_pix]
        if pix_map is None:
            rad = rad_lanes.reshape(m, n_pix, 3).sum(0)
        else:
            rad = np.zeros((n_pix, 3), np.float64)
            np.add.at(rad, pix_map[: m * n_pix], rad_lanes)
        n_samples = n_passes * m
        self.sum += rad
        self.count += n_samples
        self.passes += 1
        batch_mean = rad / n_samples
        if self.variance:
            delta = batch_mean - self.mean
            self.mean += delta / self.passes
            self.m2 += delta * (batch_mean - self.mean)
        if self.twobuffer:
            if self.passes % 2 == 1:
                self.sum_a += rad
                self.count_a += n_samples
            else:
                self.sum_b += rad
                self.count_b += n_samples
        if aux:
            half = self.aovs_a if (self.twobuffer and self.passes % 2 == 1) else self.aovs_b
            for k, v in aux.items():
                if k in self.aovs:
                    a = np.asarray(v, np.float64)[: m * n_pix]
                    if pix_map is None:
                        a = a.reshape(m, n_pix, -1).sum(0)
                    else:
                        acc = np.zeros((n_pix, a.shape[-1] if a.ndim > 1 else 1), np.float64)
                        np.add.at(acc, pix_map[: m * n_pix], a.reshape(m * n_pix, -1))
                        a = acc
                    self.aovs[k] += a.reshape(self.aovs[k].shape)
                    if self.twobuffer:
                        half[k] += a.reshape(self.aovs[k].shape)
            if self.aov_count is not None:
                self.aov_count += n_samples

    def add_pixel_sums(self, rad, n_samples, aux=None):
        """Accumulate one uniform batch whose reduction already happened
        on-device: rad is the per-pixel SUM (n_pix, 3) over n_samples
        samples/pixel (the regenerating wavefront deposits per pixel)."""
        rad = np.asarray(rad, np.float64)
        self.sum += rad
        self.count += n_samples
        self.passes += 1
        if self.variance:
            batch_mean = rad / n_samples
            delta = batch_mean - self.mean
            self.mean += delta / self.passes
            self.m2 += delta * (batch_mean - self.mean)
        if self.twobuffer:
            if self.passes % 2 == 1:
                self.sum_a += rad
                self.count_a += n_samples
            else:
                self.sum_b += rad
                self.count_b += n_samples
        if aux:
            half = self.aovs_a if (self.twobuffer and self.passes % 2 == 1) else self.aovs_b
            for k, v in aux.items():
                if k in self.aovs:
                    a = np.asarray(v, np.float64).reshape(self.aovs[k].shape)
                    self.aovs[k] += a
                    if self.twobuffer:
                        half[k] += a
            if self.aov_count is not None:
                self.aov_count += n_samples

    def add_batch_sparse(self, rad, pix):
        """Accumulate an adaptive batch: rad (B, 3) one sample per lane,
        pix (B,) pixel index per lane."""
        rad = np.asarray(rad, np.float64)
        np.add.at(self.sum, pix, rad)
        np.add.at(self.count, pix, 1)
        self.passes += 1
        if self.twobuffer:
            tgt_s, tgt_c = (
                (self.sum_a, self.count_a)
                if self.passes % 2 == 1
                else (self.sum_b, self.count_b)
            )
            np.add.at(tgt_s, pix, rad)
            np.add.at(tgt_c, pix, 1)

    def color(self) -> np.ndarray:
        h, w = self.res
        c = self.sum / np.maximum(self.count, 1)[:, None]
        return c.reshape(h, w, 3).astype(np.float32)

    def aov(self, name) -> np.ndarray:
        h, w = self.res
        a = self.aovs[name] / np.maximum(self.aov_count, 1)[:, None]
        return a.reshape(h, w, -1).astype(np.float32)

    def nfor_inputs(self):
        """Assemble the NFOR pipeline inputs (utils/nfor.nfor): the color
        half buffers + sample variance of the mean, and per-AOV feature
        dicts with two-buffer feature variance ((a-b)^2/4, the same
        estimator denoiser.cpp:117 uses for combined features)."""
        h, w = self.res
        a, b = self.half_images()
        # variance of the FULL-buffer pixel mean: m2/(passes-1) is the
        # variance of batch means, /passes gives the mean's variance (the
        # reference's sampleVariance buffer; denoiser.cpp:71 uses 2*var as
        # the half-buffer variance)
        var = self.sample_variance() / max(self.passes, 1)
        feats = []
        for k in self.aovs:
            ca = np.maximum(self.count_a, 1)[:, None]
            cb = np.maximum(self.count_b, 1)[:, None]
            fa = (self.aovs_a[k] / ca).reshape(h, w, -1)
            fb = (self.aovs_b[k] / cb).reshape(h, w, -1)
            feats.append(
                {
                    "buffer_a": fa,
                    "buffer_b": fb,
                    "variance": (fa - fb) ** 2 * 0.25,
                }
            )
        return a, b, var, feats

    def half_images(self):
        h, w = self.res
        a = (self.sum_a / np.maximum(self.count_a, 1)[:, None]).reshape(h, w, 3)
        b = (self.sum_b / np.maximum(self.count_b, 1)[:, None]).reshape(h, w, 3)
        return a.astype(np.float32), b.astype(np.float32)

    def pixel_variance(self) -> np.ndarray:
        """Two-buffer variance estimate of the pixel mean (OutputBuffer
        two-buffer mode): var ~ (A - B)^2 / 4."""
        a, b = self.half_images()
        return ((a - b) ** 2 * 0.25).mean(-1).astype(np.float32)

    def sample_variance(self) -> np.ndarray:
        """Welford per-sample variance (OutputBuffer.hpp:110-122)."""
        h, w = self.res
        v = self.m2 / np.maximum(self.passes - 1, 1)
        return v.reshape(h, w, 3).astype(np.float32)

    # ---- resume state (Integrator.cpp:108-162) ----
    def save_state(self, path: str, scene_hash: str, extra=None):
        state = {
            "sum": self.sum,
            "count": self.count,
        }
        if self.twobuffer:
            state.update(sum_a=self.sum_a, sum_b=self.sum_b, count_a=self.count_a,
                         count_b=self.count_b)
        if self.variance:
            state.update(mean=self.mean, m2=self.m2)
        for k, v in self.aovs.items():
            state[f"aov_{k}"] = v
        for k, v in self.aovs_a.items():
            state[f"aova_{k}"] = v
        for k, v in self.aovs_b.items():
            state[f"aovb_{k}"] = v
        if self.aov_count is not None:
            state["aov_count"] = self.aov_count
        header = json.dumps(
            {"scene_hash": scene_hash, "passes": self.passes, "extra": extra or {}}
        )
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, __header__=np.frombuffer(header.encode(), np.uint8), **state)
        os.replace(tmp, path)

    def load_state(self, path: str, scene_hash: str):
        """Returns the extra dict, or None if the state doesn't match."""
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            header = json.loads(bytes(z["__header__"]).decode())
            if header["scene_hash"] != scene_hash:
                return None
            self.sum = z["sum"]
            self.count = z["count"]
            if self.twobuffer and "sum_a" in z:
                self.sum_a, self.sum_b = z["sum_a"], z["sum_b"]
                self.count_a, self.count_b = z["count_a"], z["count_b"]
            if self.variance and "mean" in z:
                self.mean, self.m2 = z["mean"], z["m2"]
            for k in list(self.aovs):
                if f"aov_{k}" in z:
                    self.aovs[k] = z[f"aov_{k}"]
                if f"aova_{k}" in z and self.twobuffer:
                    self.aovs_a[k] = z[f"aova_{k}"]
                    self.aovs_b[k] = z[f"aovb_{k}"]
            if self.aov_count is not None and "aov_count" in z:
                self.aov_count = z["aov_count"]
        self.passes = header["passes"]
        return header.get("extra", {})


def scene_hash(doc) -> str:
    """Scene-JSON hash guarding resume files (Integrator.cpp:94-106)."""
    payload = json.dumps(
        {
            "bsdfs": [{k: v for k, v in b.items() if not k.startswith("_") and not callable(v)}
                      for b in doc.bsdfs],
            "primitives": [{k: v for k, v in p.items() if not k.startswith("_")}
                           for p in doc.primitives],
            "camera": doc.camera,
            "integrator": doc.integrator,
            "media": doc.media,
        },
        sort_keys=True,
        default=str,
    )
    return hashlib.sha1(payload.encode()).hexdigest()
