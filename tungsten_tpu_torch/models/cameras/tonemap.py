"""Tonemapping operators (Tonemap.hpp:25-47) on torch tensors.

Port of tungsten_tpu/models/cameras/tonemap.py.
"""
from __future__ import annotations

import torch


def tonemap(name: str, c):
    if name == "linear":
        return c
    if name == "gamma":
        return torch.pow(torch.clamp(c, min=0.0), 1.0 / 2.2)
    if name == "reinhard":
        cc = torch.clamp(c, min=0.0)
        return torch.pow(cc / (cc + 1.0), 1.0 / 2.2)
    if name == "filmic":
        x = torch.clamp(c - 0.004, min=0.0)
        return (x * (6.2 * x + 0.5)) / (x * (6.2 * x + 1.7) + 0.06)
    if name == "pbrt":
        c = torch.clamp(c, min=0.0)
        return torch.where(c < 0.0031308, 12.92 * c, 1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)
    raise ValueError(f"unknown tonemap: {name}")
