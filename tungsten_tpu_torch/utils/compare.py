"""Image comparison metrics: MSE / RMSE (hdrmanip --mse / --rmse,
src/hdrmanip/hdrmanip.cpp:204-223) and SSIM.

Port of tungsten_tpu/utils/compare.py (:13-58), in float64 torch. SSIM
follows Wang et al. 2004 with the 11x11 gaussian window (sigma 1.5), per
channel over the valid windows, averaged. Arrays or tensors in, on the
first one's device (the CPU for an array).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _f64(a, device=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device or a.device, dtype=torch.float64)
    return torch.as_tensor(a, dtype=torch.float64, device=device)


def mse(a, b) -> float:
    a = _f64(a)
    return float(torch.mean((a - _f64(b, a.device)) ** 2))


def rmse(a, b) -> float:
    return mse(a, b) ** 0.5


def _gaussian_kernel(size=11, sigma=1.5, device=None):
    ax = torch.arange(size, dtype=torch.float64, device=device) - size // 2
    g = torch.exp(-0.5 * (ax / sigma) ** 2)
    k = g[:, None] * g[None, :]
    return k / k.sum()


def _filter2(img, k):
    """Valid-mode 2D correlation of every channel of img (H, W, C) with k."""
    x = img.permute(2, 0, 1)[:, None]  # (C, 1, H, W)
    return F.conv2d(x, k[None, None])[:, 0].permute(1, 2, 0)


def ssim(a, b, data_range: float = 1.0) -> float:
    a = _f64(a)
    b = _f64(b, a.device)
    if a.dim() == 2:
        a, b = a[..., None], b[..., None]
    k = _gaussian_kernel(device=a.device)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a, mu_b = _filter2(a, k), _filter2(b, k)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    s_aa = _filter2(a * a, k) - mu_aa
    s_bb = _filter2(b * b, k) - mu_bb
    s_ab = _filter2(a * b, k) - mu_ab
    num = (2 * mu_ab + c1) * (2 * s_ab + c2)
    den = (mu_aa + mu_bb + c1) * (s_aa + s_bb + c2)
    return float(torch.mean(num / den))
