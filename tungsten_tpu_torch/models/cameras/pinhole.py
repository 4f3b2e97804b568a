"""Pinhole camera ray generation on torch tensors.

Port of the pinhole branch of tungsten_tpu/models/cameras/pinhole.py
(PinholeCamera.cpp:70-86): horizontal fov, isotropic pixels, reconstruction
filter importance-sampled analytically with weight 1. Thinlens,
equirectangular and cubemap cameras raise NotImplementedError.
"""
from __future__ import annotations

import torch

from ...math import vecops as vo
from ...sampling import warps


def filter_offset(filter_name: str, u2):
    """Sample the reconstruction-filter displacement in pixels, weight 1."""
    if filter_name == "dirac":
        return torch.zeros_like(u2)
    if filter_name == "box":
        return u2 - 0.5
    if filter_name == "tent":
        return torch.stack(
            [warps.tent_filter_sample(u2[..., 0]), warps.tent_filter_sample(u2[..., 1])],
            dim=-1,
        )
    if filter_name == "gaussian":
        gx, gy = warps.gaussian_filter_sample(u2[..., 0], u2[..., 1])
        return torch.stack([gx, gy], dim=-1)
    raise NotImplementedError(f"reconstruction filter {filter_name!r} is not ported")


def camera_rays_w(camera, meta, px, py, u_filter, u_lens=None):
    """px, py: (N,) integer pixel coords; u_filter: (N, 2) uniforms.
    Returns (origin (N,3), direction (N,3), weight (N,) = 1)."""
    if meta.camera_type != "pinhole":
        raise NotImplementedError(f"camera type {meta.camera_type!r} is not ported")
    w = meta.res_x
    ratio = meta.res_y / meta.res_x
    f = filter_offset(meta.filter, u_filter)
    local = torch.stack(
        [
            -1.0 + (px.to(torch.float32) + 0.5 + f[..., 0]) * (2.0 / w),
            ratio - (py.to(torch.float32) + 0.5 + f[..., 1]) * (2.0 / w),
            camera.plane_dist.expand(px.shape),
        ],
        dim=-1,
    )
    local = vo.normalize(local)
    d = local @ camera.rot.T
    o = camera.pos.expand(d.shape)
    return o, d, torch.ones(px.shape, dtype=torch.float32, device=px.device)
