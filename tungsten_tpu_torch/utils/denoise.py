"""Feature-guided first-order regression denoiser (the regression core of
NFOR, Bitterli 2016), the denoiser's mode for loose images.

Port of tungsten_tpu/utils/denoise.py (:40-88), in float64 torch: within
each (2r+1)^2 window, fit color ~ a . f + b over the feature vector
f = [1, albedo, normal, depth] by least squares on the window's moments,
then average the overlapping windows' models (guided-filter aggregation);
where a variance is given, the raw estimate is kept where it has
converged. Every window sum is an integral-image box sum.
"""
from __future__ import annotations

import torch


def _f64(a, device):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float64)
    return torch.as_tensor(a, dtype=torch.float64, device=device)


def _box_sum(img, r):
    """Box sum over (2r+1)^2 windows by integral images, edge-clamped."""
    h, w = img.shape[:2]
    ii = img.new_zeros((h + 1, w + 1) + tuple(img.shape[2:]))
    ii[1:, 1:] = torch.cumsum(torch.cumsum(img, 0), 1)
    dev = img.device
    y0 = torch.clamp(torch.arange(h, device=dev) - r, 0, h)
    y1 = torch.clamp(torch.arange(h, device=dev) + r + 1, 0, h)
    x0 = torch.clamp(torch.arange(w, device=dev) - r, 0, w)
    x1 = torch.clamp(torch.arange(w, device=dev) + r + 1, 0, w)

    def at(ys, xs):
        return ii.index_select(0, ys).index_select(1, xs)

    return at(y1, x1) - at(y0, x1) - at(y1, x0) + at(y0, x0)


def denoise(color, albedo=None, normal=None, depth=None, variance=None, radius=5, reg=1e-3,
            device=None):
    """color (H, W, 3); the features optional, (H, W, 3) / (H, W, 1).
    Returns (H, W, 3) float32 on color's device (a tensor's own, else
    `device`, the CPU by default)."""
    if device is None:
        device = color.device if isinstance(color, torch.Tensor) else torch.device("cpu")
    c = _f64(color, device)
    h, w = c.shape[:2]
    feats = [torch.ones((h, w, 1), dtype=torch.float64, device=device)]
    for f in (albedo, normal):
        if f is not None:
            feats.append(_f64(f, device).reshape(h, w, -1))
    if depth is not None:
        d = _f64(depth, device).reshape(h, w, 1)
        feats.append(d / max(float(d.max()), 1e-9))
    f = torch.cat(feats, dim=-1)  # (H, W, F)
    nf = f.shape[-1]

    n_win = _box_sum(torch.ones((h, w, 1), dtype=torch.float64, device=device), radius)
    mean_f = _box_sum(f, radius) / n_win
    mean_c = _box_sum(c, radius) / n_win

    # the window covariances: E[f f^T] - E[f]E[f]^T and E[f c^T] - E[f]E[c]^T
    ff = f[..., :, None] * f[..., None, :]
    fc = f[..., :, None] * c[..., None, :]
    cov_ff = _box_sum(ff.reshape(h, w, -1), radius).reshape(h, w, nf, nf) / n_win[..., None]
    cov_fc = _box_sum(fc.reshape(h, w, -1), radius).reshape(h, w, nf, 3) / n_win[..., None]
    cov_ff = cov_ff - mean_f[..., :, None] * mean_f[..., None, :]
    cov_fc = cov_fc - mean_f[..., :, None] * mean_c[..., None, :]

    eye = torch.eye(nf, dtype=torch.float64, device=device) * reg
    a = torch.linalg.solve(cov_ff + eye, cov_fc)  # (H, W, F, 3)
    b = mean_c - torch.einsum("hwfc,hwf->hwc", a, mean_f)

    # the overlapping window models, averaged
    a_bar = _box_sum(a.reshape(h, w, -1), radius).reshape(h, w, nf, 3) / n_win[..., None]
    b_bar = _box_sum(b, radius) / n_win
    out = torch.einsum("hwfc,hwf->hwc", a_bar, f) + b_bar

    v = _f64(variance, device)
    if v is not None and float(v.max()) > 0.0:
        # keep the raw estimate where it has converged (low relative variance)
        v = v.reshape(h, w, -1).mean(-1, keepdim=True)
        rel = v / torch.clamp(c.abs().mean(-1, keepdim=True) ** 2, min=1e-6)
        alpha = torch.clamp(rel / (rel + 2e-3), 0.0, 1.0)
        out = alpha * out + (1 - alpha) * c
    return torch.clamp(out, min=0.0).to(torch.float32)
