"""Environment-light sampling on torch tensors.

Port of the infinite-sphere subset of tungsten_tpu/models/primitives/lights.py
(InfiniteSphere.cpp:27-50,161-229): lat-long importance sampling of the
emission bitmap (or uniform-sphere sampling of a constant env), with
pdf = pdf_uv / (2 pi^2 sin theta). Area, point and cap lights are not ported;
scene/flatten.py refuses scenes that have them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ...math import vecops as vo
from ...sampling import warps
from ..textures.textures import eval_texture

INF = 3.0e38


@dataclass
class LightSample:
    d: torch.Tensor  # (N, 3) direction from shading point to light
    dist: torch.Tensor  # (N,)
    pdf: torch.Tensor  # (N,) solid-angle pdf
    radiance: torch.Tensor  # (N, 3)
    valid: torch.Tensor  # (N,) bool


def _env_may(env):
    return (env.tex_kind,) if env.tex_kind >= 0 else None


def _env_tex(env, shape, device):
    return torch.full(shape, env.tex, dtype=torch.int64, device=device)


def direction_to_uv(env, d):
    """World direction -> lat-long uv + sinTheta (InfiniteSphere.cpp:33-38)."""
    w = d @ env.inv_rot.T
    sin_theta = torch.sqrt(torch.clamp(1.0 - w[..., 1] * w[..., 1], min=0.0))
    u = torch.atan2(w[..., 2], w[..., 0]) * warps.INV_TWO_PI + 0.5
    v = torch.acos(torch.clamp(-w[..., 1], -1.0, 1.0)) * warps.INV_PI
    return torch.stack([u, v], dim=-1), sin_theta


def uv_to_direction(env, uv):
    phi = (uv[..., 0] - 0.5) * (2.0 * math.pi)
    theta = uv[..., 1] * math.pi
    sin_theta = torch.sin(theta)
    local = torch.stack(
        [torch.cos(phi) * sin_theta, -torch.cos(theta), torch.sin(phi) * sin_theta], dim=-1)
    return local @ env.rot.T, sin_theta


def env_radiance(scene, d):
    """Emission of the env seen along escape direction d."""
    uv, _ = direction_to_uv(scene.env, d)
    return eval_texture(scene.textures, _env_tex(scene.env, d.shape[:-1], d.device), uv,
                        may=_env_may(scene.env))


def env_direct_pdf(scene, d):
    """Solid-angle pdf of the env's sampleDirect for direction d."""
    if scene.meta.env_is_constant:
        return torch.full(d.shape[:-1], warps.INV_FOUR_PI, dtype=torch.float32, device=d.device)
    env = scene.env
    h, w = env.dist.shape
    uv, sin_theta = direction_to_uv(env, d)
    x = torch.clamp((uv[..., 0] * w).to(torch.int64), 0, w - 1)
    row = torch.clamp(((1.0 - uv[..., 1]) * h).to(torch.int64), 0, h - 1)
    pdf_uv = env.dist.prob(x, row) * (w * h)
    return torch.where(
        sin_theta > 1e-6,
        pdf_uv * warps.INV_PI * warps.INV_TWO_PI / torch.clamp(sin_theta, min=1e-6), 0.0)


def sample_env_direct(scene, u2) -> LightSample:
    """sampleDirect of the scene's env light."""
    env = scene.env
    n = u2.shape[0]
    dev = u2.device
    if scene.meta.env_is_constant:
        d = warps.uniform_sphere(u2)
        uv, _ = direction_to_uv(env, d)
        rad = eval_texture(scene.textures, _env_tex(env, (n,), dev), uv, may=_env_may(env))
        return LightSample(
            d=d, dist=torch.full((n,), INF, device=dev),
            pdf=torch.full((n,), warps.INV_FOUR_PI, device=dev),
            radiance=rad, valid=torch.ones((n,), dtype=torch.bool, device=dev),
        )
    h, w = env.dist.shape
    x, row, pdf_d, uvr = env.dist.sample(u2)
    # BitmapTexture::sample: u = (vx + x)/w, v = 1 - (vy + row)/h
    uv = torch.stack([(uvr[..., 0] + x) / w, 1.0 - (uvr[..., 1] + row) / h], dim=-1)
    d, sin_theta = uv_to_direction(env, uv)
    pdf = pdf_d * (w * h) * warps.INV_PI * warps.INV_TWO_PI / torch.clamp(sin_theta, min=1e-6)
    rad = eval_texture(scene.textures, _env_tex(env, (n,), dev), uv, may=_env_may(env))
    return LightSample(
        d=d, dist=torch.full((n,), INF, device=dev), pdf=pdf, radiance=rad,
        valid=(sin_theta > 1e-6) & (pdf > 0.0),
    )


def _merge_ls(sel, a: LightSample, b: LightSample) -> LightSample:
    return LightSample(
        d=vo.where3(sel, a.d, b.d),
        dist=torch.where(sel, a.dist, b.dist),
        pdf=torch.where(sel, a.pdf, b.pdf),
        radiance=vo.where3(sel, a.radiance, b.radiance),
        valid=torch.where(sel, a.valid, b.valid),
    )


def infinite_radiance(scene, d):
    """Emission seen by an escaped ray: the env's (no caps in the slice)."""
    return env_radiance(scene, d)


def any_infinite_sampled(meta) -> bool:
    """True when the escape-winning infinite light has a light row."""
    return meta.env_light_index >= 0


def infinite_winner_pdf(scene, d):
    """Direct-sampling pdf of the env for escape direction d (0 when the env
    is not samplable, which makes the MIS weight 1)."""
    if scene.meta.env_light_index < 0:
        return torch.zeros(d.shape[:-1], device=d.device)
    return env_direct_pdf(scene, d)


def infinite_winner_choice_pdf(scene, d, p):
    """chooseLight probability of the env: 1 with the single light the
    slice supports."""
    return torch.full(d.shape[:-1], 1.0 / max(scene.meta.n_lights, 1), device=d.device)
