"""2D importance distribution with an alias table.

Port of Distribution2D from tungsten_tpu/sampling/distributions.py: the same
host-side (numpy) build, so `alias_pack` and `joint_pdf` are bit-identical,
and the same O(1) Walker alias draw on the device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Distribution2D:
    """Row-major 2D distribution over (h, w) cells.

    alias_pack: (h*w, 4) [stay-prob, alias cell, pdf(cell), pdf(alias)];
    joint_pdf: (h*w,) discrete cell probabilities."""

    alias_pack: torch.Tensor
    joint_pdf: torch.Tensor
    shape: tuple

    @staticmethod
    def build_arrays(weights: np.ndarray) -> dict:
        """Numpy build: {"alias_pack", "joint_pdf", "shape"} exactly as the
        JAX package's Distribution2D.build computes them."""
        w = np.asarray(weights, np.float64)
        MAX_CELLS = 1 << 20
        while w.shape[0] * w.shape[1] > MAX_CELLS and w.shape[0] % 2 == 0 and w.shape[1] % 2 == 0:
            w = 0.25 * (w[0::2, 0::2] + w[1::2, 0::2] + w[0::2, 1::2] + w[1::2, 1::2])
        h, width = w.shape
        row_sums = w.sum(axis=1)
        total = row_sums.sum()
        if total <= 0.0:
            w = np.ones_like(w)
            row_sums = w.sum(axis=1)
            total = row_sums.sum()
        marg = row_sums / total
        safe_rows = np.where(row_sums > 0, row_sums, 1.0)[:, None]
        cond = np.where(row_sums[:, None] > 0, w / safe_rows, 1.0 / width)
        joint = (marg[:, None] * cond).ravel()
        prob, alias = _build_alias(joint)
        apack = np.stack(
            [prob, alias.astype(np.float64), joint, joint[alias]], axis=1
        ).astype(np.float32)
        return {"alias_pack": apack, "joint_pdf": joint.astype(np.float32),
                "shape": (h, width)}

    @staticmethod
    def from_arrays(alias_pack, joint_pdf, shape, device) -> "Distribution2D":
        return Distribution2D(
            alias_pack=torch.as_tensor(np.array(alias_pack, np.float32), device=device),
            joint_pdf=torch.as_tensor(np.array(joint_pdf, np.float32), device=device),
            shape=tuple(int(s) for s in shape),
        )

    @staticmethod
    def build(weights: np.ndarray, device) -> "Distribution2D":
        a = Distribution2D.build_arrays(weights)
        return Distribution2D.from_arrays(a["alias_pack"], a["joint_pdf"], a["shape"], device)

    def sample(self, u):
        """u: (..., 2) -> (x, y, pdf_discrete, uv_remapped (..., 2))."""
        h, w = self.shape
        n_cells = h * w
        u0 = torch.clamp(u[..., 0], 0.0, 1.0 - 1e-7)
        u1 = torch.clamp(u[..., 1], 0.0, 1.0 - 1e-7)
        k = torch.clamp((u0 * n_cells).to(torch.int64), max=n_cells - 1)
        r0 = u0 * n_cells - k.to(torch.float32)
        row = self.alias_pack[k]
        pk = row[..., 0]
        stay = u1 < pk
        cell = torch.where(stay, k, row[..., 1].to(torch.int64))
        pdf = torch.where(stay, row[..., 2], row[..., 3])
        r1 = torch.where(
            stay,
            u1 / torch.clamp(pk, min=1e-20),
            (u1 - pk) / torch.clamp(1.0 - pk, min=1e-20),
        )
        x = cell % w
        y = cell // w
        vx = torch.clamp(r0, 0.0, 1.0)
        vy = torch.clamp(r1, 0.0, 1.0)
        return x, y, pdf, torch.stack([vx, vy], dim=-1)

    def prob(self, x, y):
        """Discrete probability of cell (x, y)."""
        h, w = self.shape
        return self.joint_pdf[torch.clamp(y, 0, h - 1) * w + torch.clamp(x, 0, w - 1)]


def _build_alias(p: np.ndarray):
    """Walker alias table, vectorized wave variant of Vose's method (a copy
    of distributions.py _build_alias)."""
    n = p.shape[0]
    scaled = np.asarray(p, np.float64) * n
    prob = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int64)
    for _ in range(64):
        small = np.where(scaled < 1.0 - 1e-12)[0]
        large = np.where(scaled >= 1.0 + 1e-12)[0]
        if small.size == 0 or large.size == 0:
            break
        surplus = scaled[large] - 1.0
        cum = np.cumsum(surplus)
        deficit = 1.0 - scaled[small]
        dcum = np.cumsum(deficit)
        donor_pos = np.searchsorted(cum, dcum - 1e-15, side="left")
        ok = donor_pos < large.size
        s_ok = small[ok]
        d_ok = large[donor_pos[ok]]
        prob[s_ok] = scaled[s_ok]
        alias[s_ok] = d_ok
        scaled[s_ok] = 1.0
        consumed = np.bincount(
            donor_pos[ok], weights=deficit[ok], minlength=large.size
        )
        scaled[large] -= consumed
    return prob.astype(np.float32), alias.astype(np.int32)


def searchsorted_strided(flat, base, u, row_len, max_len: int):
    """'right' searchsorted of u in flat[base : base + row_len], per lane
    (distributions.py _searchsorted_strided): a branchless binary search of
    ceil(log2(max_len + 1)) gathers. flat: concatenated sorted rows; base, u,
    row_len: (N,)."""
    steps = max(1, math.ceil(math.log2(max_len + 1)))
    lo = torch.zeros_like(base)  # invariant: flat[base + lo] <= u (cdf[0] == 0)
    width = row_len.clone()
    for _ in range(steps):
        half = width // 2
        mid = lo + half
        go_right = flat[torch.clamp(base + mid, 0, flat.shape[0] - 1)] <= u
        lo = torch.where(go_right, mid, lo)
        width = torch.where(go_right, width - half, half)
    return lo + 1
