"""Tabulated reconstruction filters with negative lobes, on torch tensors.

Port of tungsten_tpu/models/cameras/rfilter.py (ReconstructionFilter.hpp:
19-33 / .cpp:15-58): mitchell_netravali (B = C = 1/3), catmull_rom and
lanczos (sinc-2), evaluated into a 31-bin table over [0, WIDTH). Sampling
draws |x| from the binned CDF with weight 1 (the negative-lobe bins get
about zero mass); `eval_approx` is the SIGNED nearest-bin lookup
(`evalApproximate`) that the light tracer's splats use. gaussian has a
table too, for the splat side; its sampling stays analytic.

The tables are numpy, built on the host once per filter name (they depend
on nothing else); the samplers run on tensors of any device.
"""
from __future__ import annotations

import numpy as np
import torch

RES = 31  # RFILTER_RESOLUTION
WIDTH = 2.0  # every tabulated filter is 2 wide (ReconstructionFilter.cpp:24-28)


def _mitchell(x):
    B = C = 1.0 / 3.0
    if x < 1.0:
        return (1.0 / 6.0) * (
            (12 - 9 * B - 6 * C) * x**3 + (-18 + 12 * B + 6 * C) * x**2 + (6 - 2 * B))
    if x < 2.0:
        return (1.0 / 6.0) * (
            (-B - 6 * C) * x**3 + (6 * B + 30 * C) * x**2
            + (-12 * B - 48 * C) * x + (8 * B + 24 * C))
    return 0.0


def _catmull_rom(x):
    if x < 1.0:
        return (1.0 / 6.0) * ((12.0 - 3.0) * x**3 + (-18.0 + 3.0) * x**2 + 6.0)
    if x < 2.0:
        return (1.0 / 6.0) * (-3.0 * x**3 + 15.0 * x**2 - 24.0 * x + 12.0)
    return 0.0


def _lanczos(x):
    if x == 0.0:
        return 1.0
    if x < 2.0:
        return np.sin(np.pi * x) * np.sin(np.pi * x / 2.0) / (np.pi**2 * x**2 / 2.0)
    return 0.0


_EVAL = {
    "mitchell_netravali": _mitchell,
    "catmull_rom": _catmull_rom,
    "lanczos": _lanczos,
    "gaussian": lambda x: float(np.exp(-2.0 * x * x) - np.exp(-8.0)) if x < 2.0 else 0.0,
}

_CACHE = {}


def tables(name):
    """(filter (RES+1,), cdf (RES+1,), bin_size) as numpy, the reference's
    precompute(): the cdf over the raw (signed) bin values, the filter
    normalized so that the 2 * WIDTH wide splat kernel integrates to ~1."""
    if name not in _CACHE:
        f = np.array([_EVAL[name]((i * WIDTH) / RES) for i in range(RES)] + [0.0])
        s = f[:RES].sum()
        cdf = np.zeros(RES + 1)
        np.cumsum(f[:RES] / s, out=cdf[1:])
        cdf[RES] = 1.0
        filt = f / (s * 2.0 * WIDTH / RES)
        _CACHE[name] = (filt.astype(np.float32), cdf.astype(np.float32), WIDTH / RES)
    return _CACHE[name]


def is_tabulated(name):
    return name in _EVAL


def sample_offset_1d(name, xi):
    """ReconstructionFilter::sample (hpp:86-104): fold xi around 0.5 for the
    sign, invert the magnitude's binned CDF. The raw cdf is not monotone
    where the filter has negative lobes; the reference's scan for the first
    i with xi < cdf[i] is a searchsorted over the running-max cdf, while lo
    and p read the raw cdf, as the reference does."""
    _, cdf, bin_size = tables(name)
    cdf_t = torch.as_tensor(cdf, device=xi.device)
    runmax = torch.as_tensor(np.maximum.accumulate(cdf)[: RES - 1], device=xi.device)
    negative = xi < 0.5
    xi = torch.where(negative, xi * 2.0, (xi - 0.5) * 2.0)
    # first i in [0, RES-1) with xi < cdf[i], else RES-1 (hpp:93-99)
    idx = torch.clamp(torch.searchsorted(runmax, xi.contiguous(), right=True), 1, RES - 1)
    lo = cdf_t[idx - 1]
    p = cdf_t[idx] - lo
    u = bin_size * (idx.to(torch.float32) + (xi - lo) / torch.clamp(p, min=1e-12))
    return torch.where(negative, -u, u)


def sample_offset(name, u2):
    """(N, 2) filter displacement in pixels, weight 1."""
    return torch.stack([sample_offset_1d(name, u2[..., 0]), sample_offset_1d(name, u2[..., 1])],
                       dim=-1)


def eval_approx(name, x):
    """evalApproximate (hpp:210-213): the SIGNED nearest-bin filter value."""
    filt, _, bin_size = tables(name)
    idx = torch.clamp((torch.abs(x) * (1.0 / bin_size)).to(torch.int64), max=RES)
    return torch.as_tensor(filt, device=x.device)[idx]
