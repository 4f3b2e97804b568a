"""IES (LM-63) photometric-profile loader baked to a lat-long bitmap.

Mirror of IesTexture.cpp: parse the candela web, expand type-C horizontal
symmetries (0 / 0-90 / 0-180 degrees -> full circle, wrapHorzAngles
IesTexture.cpp:45-75), resample onto a (resolution x 2*resolution) grid with
u = horz/360, v-flipped vert = (1-v)*180, bilinear in the angle tables, and
normalize by the maximum (IesTexture.cpp:151-213).

The port's own copy of tungsten_tpu/models/textures/ies.py: the same numpy code, so it
yields the same arrays; the port imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np


def parse_ies(text: str):
    """Returns (vert_angles, horz_angles, candelas (H, V), photometric_type)
    or None on malformed input."""
    lines = text.splitlines()
    i = 0
    while i < len(lines) and "TILT=" not in lines[i]:
        i += 1
    if i >= len(lines):
        return None
    tilt_line = lines[i]
    rest = " ".join(lines[i + 1 :]).replace(",", " ").split()
    pos = 0

    def take(n):
        nonlocal pos
        vals = [float(rest[pos + k]) for k in range(n)]
        pos += n
        return vals

    if "TILT=INCLUDE" in tilt_line:
        take(1)  # lamp-to-luminaire geometry
        n_ang = int(take(1)[0])
        take(2 * n_ang)
    header = take(10)
    n_vert = int(header[3])
    n_horz = int(header[4])
    ptype = int(header[5])
    take(3)  # ballast, future, watts
    vert = np.asarray(take(n_vert))
    horz = np.asarray(take(n_horz))
    cd = np.asarray(take(n_vert * n_horz)).reshape(n_horz, n_vert)
    cd = cd * header[2]  # candela multiplier
    return vert, horz, cd, ptype


def _wrap_horz(ptype, horz, cd):
    """Type-C symmetry expansion (IesTexture.cpp wrapHorzAngles)."""
    if ptype != 1:
        return horz, cd
    if horz[-1] == 0.0:
        return np.array([0.0, 360.0]), np.vstack([cd[0], cd[0]])
    if horz[-1] == 90.0:
        h2 = np.concatenate([horz, 180.0 - horz[-2::-1]])
        h2[-1] = 180.0
        cd = np.vstack([cd, cd[-2::-1]])
        horz = h2
    if horz[-1] == 180.0:
        h2 = np.concatenate([horz, 360.0 - horz[-2::-1]])
        h2[-1] = 360.0
        cd = np.vstack([cd, cd[-2::-1]])
        horz = h2
    return horz, cd


def bake_ies(vert, horz, cd, ptype, resolution=256):
    horz, cd = _wrap_horz(ptype, horz, cd)
    w, h = resolution * 2, resolution
    xs = (np.arange(w) + 0.5) / w
    ys = (np.arange(h) + 0.5) / h
    hz = xs * 360.0
    vt = (1.0 - ys) * 180.0
    if ptype != 1:
        hz = np.where(hz > 180.0, hz - 360.0, hz)
        vt = np.where(vt > 90.0, vt - 180.0, vt)

    # bilinear in the (irregular) angle tables; out-of-range -> 0
    def interp_axis(angles, q):
        i1 = np.searchsorted(angles, q, side="left")
        inside = (q >= angles[0]) & (q <= angles[-1])
        i1 = np.clip(i1, 1, len(angles) - 1)
        i0 = i1 - 1
        a0, a1 = angles[i0], angles[i1]
        f = np.where(a1 > a0, (q - a0) / np.maximum(a1 - a0, 1e-9), 0.0)
        return i0, i1, np.clip(f, 0.0, 1.0), inside

    r0, r1, fu, okh = interp_axis(horz, hz)
    c0, c1, fv, okv = interp_axis(vert, vt)
    if ptype == 1:
        okh = np.ones_like(okh)
    grid = (
        (cd[np.ix_(r0, c0)] * (1 - fu)[:, None] + cd[np.ix_(r1, c0)] * fu[:, None])
        * (1 - fv)[None, :]
        + (cd[np.ix_(r0, c1)] * (1 - fu)[:, None] + cd[np.ix_(r1, c1)] * fu[:, None])
        * fv[None, :]
    )  # (W, H)
    grid = grid * (okh[:, None] & okv[None, :])
    img = grid.T.astype(np.float32)  # (H, W)
    m = img.max()
    if m > 0:
        img /= m
    return np.repeat(img[..., None], 3, axis=-1)


def bake_ies_file(path: str, resolution: int = 256) -> np.ndarray:
    with open(path, "r", errors="replace") as f:
        parsed = parse_ies(f.read())
    if parsed is None:
        return np.full((resolution, resolution * 2, 3), 1.0 / (2.0 * np.pi), np.float32)
    vert, horz, cd, ptype = parsed
    return bake_ies(vert, horz, cd, ptype, resolution)
