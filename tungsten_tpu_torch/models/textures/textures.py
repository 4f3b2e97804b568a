"""Texture table: host-side assembly + batched evaluation on torch tensors.

Port of tungsten_tpu/models/textures/textures.py: the constant, checker,
bitmap (wrapped, or clamped as an IES profile's), disk and blade types, the
IES profiles baked to a clamped bitmap (ies.py) and the `_prebuilt`
entries the resource packs of a minecraft_map register. The host side is
the same numpy code (same ids, same packed rows), so tables built here equal
the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import math

import numpy as np
import torch

TEX_CONSTANT = 0
TEX_CHECKER = 1
TEX_BITMAP = 2
TEX_DISK = 3
TEX_BLADE = 4

_PARAMS = 8
_TEX4_MAX = 1 << 23  # texel count above which the 2x2-block pack is skipped


@dataclass
class TextureTable:
    tpack: torch.Tensor  # (K, 9) [params(8) | type]
    data: torch.Tensor  # (P, 3) concatenated bitmap texels
    data4: Optional[torch.Tensor]  # (P, 12) 2x2-block pack, or None
    present: tuple  # static texture types present

    @staticmethod
    def from_arrays(tpack, data, data4, device) -> "TextureTable":
        tpack = np.array(tpack, np.float32)
        return TextureTable(
            tpack=torch.as_tensor(tpack, device=device),
            data=torch.as_tensor(np.array(data, np.float32), device=device),
            data4=None if data4 is None else torch.as_tensor(
                np.array(data4, np.float32), device=device),
            present=tuple(sorted({int(t) for t in tpack[:, -1]})),
        )


class TextureBuilder:
    """Host-side accumulation of scene textures (textures.py TextureBuilder)."""

    def __init__(self):
        self.types: List[int] = []
        self.params: List[np.ndarray] = []
        self.blobs: List[np.ndarray] = []
        self._blob_meta: List[tuple] = []
        self._blob_off = 0
        self._cache = {}
        # texture ids referenced by BSDF roughness slots (pack_roughness):
        # their kinds are resolve_roughness's static `may` hint
        self.rough_ids: List[int] = []

    def add_constant(self, rgb) -> int:
        rgb = np.asarray(rgb, np.float32).ravel()
        if rgb.size == 1:
            rgb = np.repeat(rgb, 3)
        key = ("const", tuple(rgb))
        if key in self._cache:
            return self._cache[key]
        p = np.zeros(_PARAMS, np.float32)
        p[:3] = rgb
        idx = self._push(TEX_CONSTANT, p)
        self._cache[key] = idx
        return idx

    def add_checker(self, on_color, off_color, res_u=20, res_v=20) -> int:
        on = np.asarray(on_color, np.float32).ravel()
        off = np.asarray(off_color, np.float32).ravel()
        if on.size == 1:
            on = np.repeat(on, 3)
        if off.size == 1:
            off = np.repeat(off, 3)
        p = np.zeros(_PARAMS, np.float32)
        p[:3] = on
        p[3:6] = off
        p[6] = res_u
        p[7] = res_v
        return self._push(TEX_CHECKER, p)

    def add_bitmap(self, img: np.ndarray, path_key=None, clamp=False) -> int:
        """A bitmap, repeat-wrapped or (an IES profile's) clamped at its edges."""
        key = ("bitmap", path_key, clamp, 1.0)
        if path_key is not None and key in self._cache:
            return self._cache[key]
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        h, w = img.shape[:2]
        p = np.zeros(_PARAMS, np.float32)
        p[0] = self._blob_off
        p[1] = w
        p[2] = h
        p[3] = 1.0 if clamp else 0.0
        p[4] = 1.0  # scale
        self.blobs.append(img.reshape(-1, 3))
        self._blob_meta.append((h, w, clamp))
        self._blob_off += h * w
        idx = self._push(TEX_BITMAP, p)
        if path_key is not None:
            self._cache[key] = idx
        return idx

    def add_disk(self, value=1.0) -> int:
        v = np.asarray(value, np.float32).ravel()
        if v.size == 1:
            v = np.repeat(v, 3)
        p = np.zeros(_PARAMS, np.float32)
        p[:3] = v
        return self._push(TEX_DISK, p)

    def add_blade(self, blades=6, angle=0.593412, value=1.0) -> int:
        v = np.asarray(value, np.float32).ravel()
        if v.size == 1:
            v = np.repeat(v, 3)
        p = np.zeros(_PARAMS, np.float32)
        p[:3] = v
        p[6] = blades
        p[7] = angle
        return self._push(TEX_BLADE, p)

    def _push(self, t: int, p: np.ndarray) -> int:
        self.types.append(t)
        self.params.append(p)
        return len(self.types) - 1

    def image(self, tex_id: int) -> np.ndarray:
        """Host-side texels (H, W, 3) of a bitmap (env-map distributions)."""
        assert self.types[tex_id] == TEX_BITMAP
        off, w, h = (int(self.params[tex_id][i]) for i in range(3))
        flat = np.concatenate(self.blobs, axis=0)
        return flat[off: off + w * h].reshape(h, w, 3)

    def kinds_of(self, ids) -> tuple:
        """Static sorted tuple of the texture types of these ids: the
        eval_texture `may` hint (invalid ids contribute none)."""
        return tuple(sorted({self.types[i] for i in ids if 0 <= int(i) < len(self.types)}))

    def average(self, tex_id: int) -> np.ndarray:
        """Mean value of a texture (Texture::average), for light weights."""
        t, p = self.types[tex_id], self.params[tex_id]
        if t == TEX_CONSTANT:
            return p[:3].copy()
        if t == TEX_CHECKER:
            return 0.5 * (p[:3] + p[3:6])
        if t == TEX_DISK:
            return np.float32(np.pi * 0.25) * p[:3]
        if t == TEX_BLADE:
            nb = max(p[6], 3.0)
            return np.float32(0.125 * nb * np.sin(2.0 * np.pi / nb)) * p[:3]
        return self.image(tex_id).mean(axis=(0, 1))

    def build_arrays(self) -> dict:
        """{"tpack", "data", "data4"} as numpy, laid out as textures.py
        TextureBuilder.build lays them out."""
        if not self.types:
            self.add_constant([0.0, 0.0, 0.0])
        data = (np.concatenate(self.blobs, axis=0) if self.blobs
                else np.zeros((1, 3), np.float32))
        data4 = None
        if self.blobs and data.shape[0] <= _TEX4_MAX:
            packs = []
            for img, (h, w, clamp) in zip(self.blobs, self._blob_meta):
                t = img.reshape(h, w, 3)
                if clamp:
                    iu1 = np.minimum(np.arange(w) + 1, w - 1)
                    iv1 = np.minimum(np.arange(h) + 1, h - 1)
                else:
                    iu1 = (np.arange(w) + 1) % w
                    iv1 = (np.arange(h) + 1) % h
                packs.append(np.concatenate(
                    [t, t[:, iu1], t[iv1], t[iv1][:, iu1]], axis=-1).reshape(-1, 12))
            data4 = np.concatenate(packs, axis=0)
        tpack = np.concatenate(
            [np.stack(self.params), np.asarray(self.types, np.float32)[:, None]],
            axis=1).astype(np.float32)
        return {"tpack": tpack, "data": data, "data4": data4}


def _eval_constant(params, uv):
    return params[..., 0:3]


def _eval_checker(params, uv):
    # CheckerTexture::operator[]: on = (iu ^ iv) & 1 (truncating casts)
    iu = (uv[..., 0] * params[..., 6]).to(torch.int32)
    iv = (uv[..., 1] * params[..., 7]).to(torch.int32)
    on = ((iu ^ iv) & 1) == 1
    return torch.where(on[..., None], params[..., 0:3], params[..., 3:6])


def _eval_bitmap(data, params, uv, data4=None):
    off = params[..., 0].to(torch.int64)
    w = params[..., 1].to(torch.int64)
    h = params[..., 2].to(torch.int64)
    clamp = params[..., 3] > 0.5

    u = uv[..., 0] * params[..., 1] - 0.5
    v = (1.0 - uv[..., 1]) * params[..., 2] - 0.5
    iu0 = torch.floor(u).to(torch.int64)
    iv0 = torch.floor(v).to(torch.int64)
    fu = u - iu0
    fv = v - iv0

    def wrap(i, n):
        n = torch.clamp(n, min=1)
        return torch.where(clamp, torch.minimum(torch.clamp(i, min=0), n - 1),
                           ((i % n) + n) % n)

    iu1 = wrap(iu0 + 1, w)
    iv1 = wrap(iv0 + 1, h)
    iu0 = wrap(iu0, w)
    iv0 = wrap(iv0, h)
    fu = fu[..., None]
    fv = fv[..., None]
    if data4 is not None:
        row = data4[torch.clamp(off + iu0 + iv0 * w, 0, data4.shape[0] - 1)]
        c00, c10 = row[..., 0:3], row[..., 3:6]
        c01, c11 = row[..., 6:9], row[..., 9:12]
    else:
        def safe(idx):
            return torch.clamp(idx, 0, data.shape[0] - 1)

        c00 = data[safe(off + iu0 + iv0 * w)]
        c10 = data[safe(off + iu1 + iv0 * w)]
        c01 = data[safe(off + iu0 + iv1 * w)]
        c11 = data[safe(off + iu1 + iv1 * w)]
    return (c00 * (1 - fu) + c10 * fu) * (1 - fv) + (c01 * (1 - fu) + c11 * fu) * fv


def _eval_disk(params, uv):
    # DiskTexture::operator[]: the unit disk centred at uv (0.5, 0.5)
    d = uv - 0.5
    inside = d[..., 0] ** 2 + d[..., 1] ** 2 < 0.25
    return torch.where(inside[..., None], params[..., 0:3], 0.0)


def _eval_blade(params, uv):
    # BladeTexture::operator[] (BladeTexture.cpp:73-88): the n-gon aperture
    nb = torch.clamp(params[..., 6], min=3.0)
    angle = params[..., 7]
    blade_angle = (2.0 * math.pi) / nb
    g = uv * 2.0 - 1.0
    phi = torch.atan2(g[..., 1], g[..., 0]) - angle
    phi = -(torch.floor(phi / blade_angle) * blade_angle + angle)
    sp, cp = torch.sin(phi), torch.cos(phi)
    lx = g[..., 0] * cp - g[..., 1] * sp
    ly = g[..., 1] * cp + g[..., 0] * sp
    bnx = torch.cos(blade_angle * 0.5)
    bny = torch.sin(blade_angle * 0.5)
    outside = bnx * (lx - 1.0) + bny * ly > 0.0
    center = (uv[..., 0] + uv[..., 1]) == 0.0  # the reference's uv == 0 special case
    val = torch.where(outside[..., None], 0.0, params[..., 0:3])
    return torch.where(center[..., None], params[..., 0:3], val)


def eval_texture(table: TextureTable, tex_id, uv, may=None, pre=None):
    """Batched lookup: tex_id (N,), uv (N, 2) -> rgb (N, 3), masked over the
    texture types present (narrowed by the static `may` hint). `pre` is an
    optional (params, type) pair the caller already gathered."""
    if pre is not None:
        params, ttype = pre
    else:
        row = table.tpack[torch.clamp(tex_id, 0, table.tpack.shape[0] - 1)]
        params = row[..., :-1]
        ttype = row[..., -1].to(torch.int64)
    kinds = table.present if may is None else tuple(t for t in table.present if t in may)
    out = torch.zeros(uv.shape[:-1] + (3,), dtype=torch.float32, device=uv.device)
    for t in kinds:
        if t == TEX_CONSTANT:
            val = _eval_constant(params, uv)
        elif t == TEX_CHECKER:
            val = _eval_checker(params, uv)
        elif t == TEX_BITMAP:
            val = _eval_bitmap(table.data, params, uv, table.data4)
        elif t == TEX_DISK:
            val = _eval_disk(params, uv)
        elif t == TEX_BLADE:
            val = _eval_blade(params, uv)
        else:
            raise NotImplementedError(f"texture type id {t} is not ported")
        out = torch.where((ttype == t)[..., None], val, out)
    return out


def texture_from_spec(spec, tex_builder: TextureBuilder, resolve_path=None) -> int:
    """JSON texture value -> table id (TextureFactory.cpp dispatch: scalar /
    rgb constants, strings = bitmap or .ies paths, dicts by "type")."""
    if isinstance(spec, str):
        from ...io.imageio import load_image

        if spec.lower().endswith(".ies"):
            from .ies import bake_ies_file

            img = bake_ies_file(resolve_path(spec) if resolve_path else spec)
            return tex_builder.add_bitmap(img, path_key=spec, clamp=True)
        img = load_image(resolve_path(spec) if resolve_path else spec)
        return tex_builder.add_bitmap(img, path_key=spec)
    if isinstance(spec, dict):
        t = spec.get("type")
        if t == "_prebuilt":
            # a texture already registered with this builder (the resource
            # pack entries of a minecraft_map, mc_resources.py)
            return int(spec["id"])
        if t == "checker":
            return tex_builder.add_checker(
                spec.get("on_color", 0.8), spec.get("off_color", 0.2),
                spec.get("res_u", 20), spec.get("res_v", 20),
            )
        if t == "constant":
            return tex_builder.add_constant(spec.get("value", 1.0))
        if t == "bitmap":
            from ...io.imageio import load_image

            f = spec["file"]
            img = load_image(resolve_path(f) if resolve_path else f)
            return tex_builder.add_bitmap(img, path_key=f)
        if t == "disk":
            return tex_builder.add_disk(spec.get("value", 1.0))
        if t == "blade":
            return tex_builder.add_blade(spec.get("blades", 6), spec.get("angle", 0.593412),
                                         spec.get("value", 1.0))
        if t == "ies":
            from .ies import bake_ies_file

            f = spec["file"]
            img = bake_ies_file(resolve_path(f) if resolve_path else f,
                                resolution=int(spec.get("resolution", 256)))
            return tex_builder.add_bitmap(img, path_key=f, clamp=True)
        raise NotImplementedError(f"texture type {t!r} is not ported")
    return tex_builder.add_constant(spec)
