"""Mixed BSDF (MixedBsdf.cpp) on torch tensors: a blend of two non-wrapper
BSDFs by a ratio that may be a texture, sampled by one-sample MIS.

Port of tungsten_tpu/models/bsdfs/mixed.py. Params: [0] bsdf0 index, [1]
bsdf1 index, [2] ratio texture id. The sample re-evaluates the branch it
did not take (eval and pdf at the sampled direction).
"""
from __future__ import annotations

import torch

from .common import BsdfSample, Lobes

NAME = "mixed"
IS_WRAPPER = True


def lobes_for(spec, sub_lobes_of):
    return sub_lobes_of(spec["_bsdf0_index"]) | sub_lobes_of(spec["_bsdf1_index"])


def pack(spec, params, tex_builder):
    params[0] = spec.get("_bsdf0_index", -1)
    params[1] = spec.get("_bsdf1_index", -1)
    if params[0] < 0 or params[1] < 0:
        raise ValueError("mixed requires bsdf0 and bsdf1")
    from ..textures.textures import texture_from_spec

    params[2] = texture_from_spec(spec.get("ratio", 0.5), tex_builder, spec.get("_resolve_path"))
    return params


def _parts(ctx, params, uv):
    from ..textures.textures import eval_texture

    ratio = eval_texture(ctx[1], params[..., 2].to(torch.int64), uv)[..., 0]
    return params[..., 0].to(torch.int64), params[..., 1].to(torch.int64), ratio


def _adjusted_ratio(ctx, id0, id1, ratio, nonspecular_only):
    """The ratio over the non-specular lobes: 1 or 0 where one side has
    none, -1 where neither has."""
    from .dispatch import material_lobes

    if not nonspecular_only:
        return ratio
    mask = ~(Lobes.SPECULAR | Lobes.FORWARD)
    ok0 = (material_lobes(ctx[0], id0) & mask) != 0
    ok1 = (material_lobes(ctx[0], id1) & mask) != 0
    return torch.where(ok0 & ok1, ratio, torch.where(ok0, 1.0, torch.where(ok1, 0.0, -1.0)))


def eval(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    from .dispatch import nested_eval

    id0, id1, ratio = _parts(ctx, params, uv)
    f0 = nested_eval(ctx, id0, uv, wi, wo, nonspecular_only)
    f1 = nested_eval(ctx, id1, uv, wi, wo, nonspecular_only)
    return albedo * (f0 * ratio[..., None] + f1 * (1.0 - ratio)[..., None])


def pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only=False):
    from .dispatch import nested_pdf

    id0, id1, ratio = _parts(ctx, params, uv)
    r = _adjusted_ratio(ctx, id0, id1, ratio, nonspecular_only)
    p0 = nested_pdf(ctx, id0, uv, wi, wo, nonspecular_only)
    p1 = nested_pdf(ctx, id1, uv, wi, wo, nonspecular_only)
    return torch.where(r >= 0.0, p0 * r + p1 * (1.0 - r), 0.0)


def sample(ctx, params, albedo, uv, wi, u2, u1, nonspecular_only=False):
    from .dispatch import nested_eval, nested_pdf, nested_sample

    id0, id1, ratio = _parts(ctx, params, uv)
    r = _adjusted_ratio(ctx, id0, id1, ratio, nonspecular_only)
    pick0 = u1 < r
    u1_re = torch.clamp(
        torch.where(pick0, u1 / torch.clamp(r, min=1e-7),
                    (u1 - r) / torch.clamp(1.0 - r, min=1e-7)), 0.0, 1.0 - 1e-7)
    s0 = nested_sample(ctx, id0, uv, wi, u2, u1_re, nonspecular_only)
    s1 = nested_sample(ctx, id1, uv, wi, u2, u1_re, nonspecular_only)
    p3 = pick0[..., None]
    wo = torch.where(p3, s0.wo, s1.wo)
    lobe = torch.where(pick0, s0.lobe, s1.lobe)
    valid = torch.where(pick0, s0.valid, s1.valid) & (r >= 0.0)

    # one-sample MIS (MixedBsdf::sample): f / pdf with the mixture pdf, the
    # sampled side's f rebuilt from weight * pdf
    own_f = torch.where(p3, s0.weight * s0.pdf[..., None], s1.weight * s1.pdf[..., None])
    other_f = torch.where(p3, nested_eval(ctx, id1, uv, wi, wo, nonspecular_only),
                          nested_eval(ctx, id0, uv, wi, wo, nonspecular_only))
    other_pdf = torch.where(pick0, nested_pdf(ctx, id1, uv, wi, wo, nonspecular_only),
                            nested_pdf(ctx, id0, uv, wi, wo, nonspecular_only))
    r_own = torch.where(pick0, r, 1.0 - r)
    f = own_f * r_own[..., None] + other_f * (1.0 - r_own)[..., None]
    p = torch.where(pick0, s0.pdf, s1.pdf) * r_own + other_pdf * (1.0 - r_own)
    w = albedo * f / torch.clamp(p, min=1e-30)[..., None]
    return BsdfSample(wo=wo, weight=torch.where(valid[..., None], w, 0.0), pdf=p, lobe=lobe,
                      valid=valid)
