"""Transparency wrapper (TransparencyBsdf.cpp) on torch tensors: a base
BSDF plus a forward (pass-through) lobe weighted by 1 - alpha, alpha a
number or a texture.

Port of tungsten_tpu/models/bsdfs/transparency.py. Params: [0] base
material index, [1] alpha texture id.
"""
from __future__ import annotations

import torch

from .common import Lobes

NAME = "transparency"
IS_WRAPPER = True


def lobes_for(spec, sub_lobes_of):
    return Lobes.FORWARD | sub_lobes_of(spec["_base_index"])


def pack(spec, params, tex_builder):
    params[0] = spec.get("_base_index", -1)
    if params[0] < 0:
        raise ValueError("transparency requires a base bsdf")
    from ..textures.textures import texture_from_spec

    params[1] = texture_from_spec(spec.get("alpha", 1.0), tex_builder, spec.get("_resolve_path"))
    return params


def forward_transparency(ctx, params, albedo, uv, wi):
    """eval(forwardEvent) = 1 - opacity (TransparencyBsdf::eval)."""
    from ..textures.textures import eval_texture

    opacity = eval_texture(ctx[1], params[..., 1].to(torch.int64), uv)[..., 0]
    return (1.0 - opacity)[..., None].expand(*wi.shape[:-1], 3)


def eval(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    from .dispatch import nested_eval

    return nested_eval(ctx, params[..., 0].to(torch.int64), uv, wi, wo, nonspecular_only)


def pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    from .dispatch import nested_pdf

    return nested_pdf(ctx, params[..., 0].to(torch.int64), uv, wi, wo, nonspecular_only)


def sample(ctx, params, albedo, uv, wi, u2, u1, nonspecular_only=False):
    from .dispatch import nested_sample

    return nested_sample(ctx, params[..., 0].to(torch.int64), uv, wi, u2, u1, nonspecular_only)
