"""Shared BSDF machinery: lobe flags and the batched sample record.

Port of tungsten_tpu/models/bsdfs/common.py (BsdfLobes.hpp:13-34 flags).
Directions are in the local shading frame (+z = shading normal), wi points
away from the surface, eval() returns f * |cos(theta_o)|, sample() returns
weight = f*cos/pdf and a solid-angle pdf.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


class Lobes:
    NULL = 0
    GLOSSY_R = 1 << 0
    GLOSSY_T = 1 << 1
    DIFFUSE_R = 1 << 2
    DIFFUSE_T = 1 << 3
    SPECULAR_R = 1 << 4
    SPECULAR_T = 1 << 5
    ANISOTROPIC = 1 << 6
    FORWARD = 1 << 7

    GLOSSY = GLOSSY_R | GLOSSY_T
    DIFFUSE = DIFFUSE_R | DIFFUSE_T
    SPECULAR = SPECULAR_R | SPECULAR_T
    TRANSMISSIVE = GLOSSY_T | DIFFUSE_T | SPECULAR_T
    REFLECTIVE = GLOSSY_R | DIFFUSE_R | SPECULAR_R
    ALL = TRANSMISSIVE | REFLECTIVE | ANISOTROPIC

    @staticmethod
    def is_transmissive(lobes):
        return (lobes & Lobes.TRANSMISSIVE) != 0

    @staticmethod
    def is_pure_specular(lobes):
        return (lobes != 0) & ((lobes & ~Lobes.SPECULAR) == 0)

    @staticmethod
    def has_specular(lobes):
        return (lobes & Lobes.SPECULAR) != 0


@dataclass
class BsdfSample:
    """Batched BSDF sample: wo (N,3) local, weight (N,3) = f*cos/pdf,
    pdf (N,), lobe (N,) int64 sampled-lobe flags, valid (N,) bool."""

    wo: torch.Tensor
    weight: torch.Tensor
    pdf: torch.Tensor
    lobe: torch.Tensor
    valid: torch.Tensor

    @staticmethod
    def invalid(n, device):
        z3 = torch.zeros((n, 3), dtype=torch.float32, device=device)
        wo = z3.clone()
        wo[:, 2] = 1.0
        return BsdfSample(
            wo=wo, weight=z3,
            pdf=torch.zeros((n,), dtype=torch.float32, device=device),
            lobe=torch.zeros((n,), dtype=torch.int64, device=device),
            valid=torch.zeros((n,), dtype=torch.bool, device=device),
        )
