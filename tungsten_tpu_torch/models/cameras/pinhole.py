"""Camera ray generation on torch tensors: pinhole, thinlens,
equirectangular, cubemap (src/core/cameras/, CameraFactory.cpp:10-15).

Port of tungsten_tpu/models/cameras/pinhole.py, lane for lane.
Pinhole (PinholeCamera.cpp:70-86): horizontal fov, isotropic pixels, the
reconstruction filter importance-sampled with weight 1.
Thinlens (ThinlensCamera.cpp): the aperture texture's sample (disk, blade,
bitmap or const), focal-plane targeting, cat-eye vignetting (weight 0
outside the diaphragm).
Equirectangular (EquirectangularCamera.cpp): lat-long directions.
Cubemap (CubemapCamera.cpp): six faces side by side.
"""
from __future__ import annotations

import math

import torch

from ...math import vecops as vo
from ...sampling import warps
from . import rfilter


def _tent(u2):
    return torch.stack(
        [warps.tent_filter_sample(u2[..., 0]), warps.tent_filter_sample(u2[..., 1])], dim=-1)


def filter_offset(filter_name: str, u2):
    """Sample the reconstruction-filter displacement in pixels, weight 1.
    mitchell_netravali, catmull_rom and lanczos go through their 31-bin
    tables; an unknown name behaves as tent, as the JAX package's does."""
    if filter_name == "dirac":
        return torch.zeros_like(u2)
    if filter_name == "box":
        return u2 - 0.5
    if filter_name == "tent":
        return _tent(u2)
    if filter_name == "gaussian":
        gx, gy = warps.gaussian_filter_sample(u2[..., 0], u2[..., 1])
        return torch.stack([gx, gy], dim=-1)
    if rfilter.is_tabulated(filter_name):
        return rfilter.sample_offset(filter_name, u2)
    return _tent(u2)


def _sample_aperture(camera, meta, u2):
    """Aperture texture sample in [0,1]^2 (ThinlensCamera::samplePosition).
    disk: SampleWarp::uniformDisk; blade: a uniform point in one of N fan
    triangles (BladeTexture.cpp:103-124); bitmap: Distribution2D over the
    texel luminance; const: the unit square."""
    kind = meta.aperture_kind
    if kind == "blade":
        nb = meta.ap_blades
        blade_angle = 2.0 * math.pi / nb
        u = u2[..., 0] * nb
        blade = torch.clamp(u.to(torch.int32), 0, nb - 1)
        u = u - blade.to(torch.float32)
        phi = camera.ap_angle + blade.to(torch.float32) * blade_angle
        sin_phi, cos_phi = torch.sin(phi), torch.cos(phi)
        base_edge_scale = 2.0 * math.sin(math.pi / nb)
        bex = -math.sin(blade_angle * 0.5) * base_edge_scale
        bey = math.cos(blade_angle * 0.5) * base_edge_scale
        u_sqrt = torch.sqrt(u)
        alpha = 1.0 - u_sqrt
        beta = (1.0 - u2[..., 1]) * u_sqrt
        lx = (1.0 + bex) * beta + (1.0 - alpha - beta)
        ly = bey * beta
        return torch.stack([lx * cos_phi - ly * sin_phi, ly * cos_phi + lx * sin_phi],
                           dim=-1) * 0.5 + 0.5
    if kind == "bitmap" and camera.ap_dist is not None:
        h, w = camera.ap_dist.shape
        x, row, _, uvr = camera.ap_dist.sample(u2)
        return torch.stack([(uvr[..., 0] + x) / w, 1.0 - (uvr[..., 1] + row) / h], dim=-1)
    if kind == "const":
        return u2
    return warps.uniform_disk(u2) * 0.5 + 0.5


def camera_rays(camera, meta, px, py, u_filter, u_lens=None):
    """Rays only (the weight dropped)."""
    o, d, _ = camera_rays_w(camera, meta, px, py, u_filter, u_lens)
    return o, d


def camera_rays_w(camera, meta, px, py, u_filter, u_lens=None):
    """px, py: (N,) integer pixel coords; u_filter / u_lens: (N, 2)
    uniforms. Returns (origin (N, 3), direction (N, 3), weight (N,)): the
    weight is 0 for thinlens rays that the cat-eye diaphragm vignettes
    (ThinlensCamera.cpp:119-124), else 1."""
    w = meta.res_x
    h = meta.res_y
    ratio = meta.res_y / meta.res_x
    f = filter_offset(meta.filter, u_filter)
    ctype = meta.camera_type
    ones = torch.ones(px.shape, dtype=torch.float32, device=px.device)

    if ctype == "equirectangular":
        u = (px.to(torch.float32) + 0.5 + f[..., 0]) / w
        v = (py.to(torch.float32) + 0.5 + f[..., 1]) / h
        phi = (u - 0.5) * (2.0 * math.pi)
        theta = (1.0 - v) * math.pi
        st = torch.sin(theta)
        local = torch.stack([torch.cos(phi) * st, -torch.cos(theta), torch.sin(phi) * st], dim=-1)
        d = local @ camera.rot.T
        return camera.pos.expand(d.shape), d, ones

    if ctype == "cubemap":
        # six faces side by side: +x -x +y -y +z -z (CubemapCamera layout)
        fw = w // 6
        face = torch.clamp(px // fw, 0, 5)
        fx = ((px % fw).to(torch.float32) + 0.5 + f[..., 0]) / fw * 2.0 - 1.0
        fy = 1.0 - ((py.to(torch.float32) + 0.5 + f[..., 1]) / h) * 2.0
        one = torch.ones_like(fx)
        dirs = [torch.stack([one, fy, -fx], -1), torch.stack([-one, fy, fx], -1),
                torch.stack([fx, one, -fy], -1), torch.stack([fx, -one, fy], -1),
                torch.stack([fx, fy, one], -1), torch.stack([-fx, fy, -one], -1)]
        local = dirs[0]
        for i in range(1, 6):
            local = torch.where((face == i)[..., None], dirs[i], local)
        d = vo.normalize(local) @ camera.rot.T
        return camera.pos.expand(d.shape), d, ones

    if ctype == "thinlens":
        # ThinlensCamera::sampleDirection: (pixel + filter offset), no +0.5
        plane = torch.stack(
            [-1.0 + (px.to(torch.float32) + f[..., 0]) * (2.0 / w),
             ratio - (py.to(torch.float32) + f[..., 1]) * (2.0 / w),
             camera.plane_dist.expand(px.shape)], dim=-1)
        plane = plane * (camera.focus_dist / camera.plane_dist)
        ap01 = _sample_aperture(camera, meta, u_lens)
        lens_xy = (ap01 * 2.0 - 1.0) * camera.aperture_size
        lens = torch.stack([lens_xy[..., 0], lens_xy[..., 1], torch.zeros_like(lens_xy[..., 0])],
                           -1)
        local = vo.normalize(plane - lens)
        wgt = ones
        if meta.cateye > 0.0:
            # the diaphragm projected along the ray by the cat-eye strength:
            # outside the aperture radius the ray is vignetted
            k = camera.cateye * camera.plane_dist
            dia_x = lens_xy[..., 0] - k * local[..., 0] / local[..., 2]
            dia_y = lens_xy[..., 1] - k * local[..., 1] / local[..., 2]
            wgt = torch.where(dia_x * dia_x + dia_y * dia_y > camera.aperture_size ** 2, 0.0, wgt)
        d = local @ camera.rot.T
        o = camera.pos + lens @ camera.rot.T
        return o, d, wgt

    # pinhole (and, as in the JAX package, any other name)
    local = torch.stack(
        [-1.0 + (px.to(torch.float32) + 0.5 + f[..., 0]) * (2.0 / w),
         ratio - (py.to(torch.float32) + 0.5 + f[..., 1]) * (2.0 / w),
         camera.plane_dist.expand(px.shape)], dim=-1)
    local = vo.normalize(local)
    d = local @ camera.rot.T
    return camera.pos.expand(d.shape), d, ones
