"""Shared BSDF machinery: lobe flags and the batched sample record.

Port of tungsten_tpu/models/bsdfs/common.py (BsdfLobes.hpp:13-34 flags).
Directions are in the local shading frame (+z = shading normal), wi points
away from the surface, eval() returns f * |cos(theta_o)| with the
non-adjoint eta^2 folded in, sample() returns weight = f*cos/pdf and a
solid-angle pdf; dirac lobes report pdf as a discrete probability and
eval() / pdf() exclude them. A roughness slot holds a scalar or a texture
id encoded as -(id + 2) (pack_roughness / resolve_roughness).
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

    @staticmethod
    def has_forward(lobes):
        return (lobes & Lobes.FORWARD) != 0

    @staticmethod
    def is_forward(lobes):
        return lobes == Lobes.FORWARD


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


def pack_roughness(spec, key, default, tex_builder):
    """Roughness parameter slot: the scalar value, or -(tex_id + 2) where
    the scene drives it with a texture (the reference's roughness is a
    Texture, e.g. RoughConductorBsdf::_roughness). resolve_roughness
    decodes it at eval time."""
    r = spec.get(key, default)
    if isinstance(r, (int, float)):
        return float(r)
    from ..textures.textures import texture_from_spec

    tid = texture_from_spec(r, tex_builder, spec.get("_resolve_path"))
    tex_builder.rough_ids.append(tid)
    return -(float(tid) + 2.0)


def resolve_roughness(ctx, rough_param, uv):
    """Per-lane roughness: scalar slots pass through; negative-encoded
    texture ids evaluate the texture's first channel at uv, over the static
    texture kinds the roughness slots use (`MaterialTable.rough_kinds`)."""
    from ..textures.textures import eval_texture

    mats, textures = ctx
    if len(mats.rough_kinds) == 0:
        return rough_param  # static: no textured roughness in this scene
    tid = torch.clamp((-rough_param - 2.0).to(torch.int64), min=0)
    tex_r = eval_texture(textures, tid, uv, may=mats.rough_kinds)[..., 0]
    return torch.where(rough_param < -1.0, tex_r, rough_param)
