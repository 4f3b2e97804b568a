"""Camera importance for the adjoint techniques (the light tracer's and
BDPT's t = 1 connections): PinholeCamera::evalDirection / sampleDirect
(PinholeCamera.cpp:88-127).

Port of tungsten_tpu/models/cameras/connect.py in its form: the pinhole's
importance whatever the scene's camera (a thinlens is connected to as a
pinhole at its position), and the film window widened by a fixed filter
width of 1 pixel on each side, the tent's, whatever the scene's filter
(the tabulated filters' width is 2)."""
from __future__ import annotations

import torch

from ...math import vecops as vo


def camera_eval_direction(camera, meta, d_world):
    """Importance of direction d_world (N, 3) leaving the camera.
    Returns (weight (N,), pixel_xy (N, 2), valid (N,))."""
    local = d_world @ camera.rot  # R^T d, the rotation being orthonormal
    valid = local[..., 2] > 0.0
    scale = camera.plane_dist / torch.where(valid, local[..., 2], 1.0)
    lx = local[..., 0] * scale
    ly = local[..., 1] * scale
    pixel_size_x = 1.0 / meta.res_x
    ratio = meta.res_y / meta.res_x
    px = (lx + 1.0) / (2.0 * pixel_size_x)
    py = (ratio - ly) / (2.0 * pixel_size_x)
    fw = 1.0  # the tent's filter width (connect.py:24-26)
    valid = valid & (px > 0.5 - fw) & (py > 0.5 - fw)
    valid = valid & (px < meta.res_x - 0.5 + fw) & (py < meta.res_y - 0.5 + fw)
    cos3 = (local[..., 2] / torch.clamp(vo.length(local), min=1e-20)) ** 3
    weight = camera.plane_dist ** 2 / torch.clamp(
        4.0 * pixel_size_x * pixel_size_x * cos3, min=1e-20)
    return weight, torch.stack([px, py], dim=-1), valid


def camera_sample_direct(camera, meta, p):
    """Connect points p (N, 3) to the pinhole (PinholeCamera::sampleDirect).
    Returns (d toward the camera (N, 3), dist (N,), weight = importance /
    r^2 (N,), pixel (N, 2), valid (N,))."""
    dvec = camera.pos - p
    r_sq = vo.length_sq(dvec)
    dist = torch.sqrt(torch.clamp(r_sq, min=1e-30))
    d = dvec / dist[..., None]
    w, pixel, valid = camera_eval_direction(camera, meta, -d)
    return d, dist, w / torch.clamp(r_sq, min=1e-30), pixel, valid
