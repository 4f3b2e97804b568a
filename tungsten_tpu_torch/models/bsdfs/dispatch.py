"""Material table + batched masked BSDF dispatch on torch tensors.

Port of tungsten_tpu/models/bsdfs/dispatch.py for the nine BSDF families
the port carries: lambert, null, mirror, rough_conductor, dielectric,
rough_dielectric, conductor, plastic and rough_plastic. Type ids are the
JAX package's (`_MODULES` order, dispatch.py:42-47), so packed material
rows are interchangeable. The wrappers (smooth_coat, rough_coat, mixed,
transparency), the fibers and the other types raise NotImplementedError,
naming the type.

The hot loop reads one packed row per lane (`gpack2`, 28 floats):
[params(16) | type | albedo tex id | lobes | albedo texture header (9)].
Like the JAX package, every call evaluates each type present in the scene
over all lanes and selects by mask.

Module interface (batched over lanes; ctx = (MaterialTable, TextureTable)):
    NAME; LOBES or lobes_for(spec, sub_lobes); pack(spec, params, tex_builder)
    eval(ctx, params, albedo, uv, wi, wo, nonspecular_only) -> (N, 3)
    pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only) -> (N,)
    sample(ctx, params, albedo, uv, wi, u2, u1, nonspecular_only) -> BsdfSample
    eta_sq(params, wi, wo) -> (N,) where eta != 1 (the dielectrics)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from . import (conductor, dielectric, lambert, mirror, null, plastic, rough_conductor,
               rough_dielectric, rough_plastic)
from .common import BsdfSample
from ..textures.textures import eval_texture, texture_from_spec

N_PARAMS = 16

# type id -> module, with the JAX package's ids
_MODULES = {0: lambert, 1: null, 2: mirror, 3: rough_conductor, 7: dielectric,
            8: rough_dielectric, 9: conductor, 10: plastic, 11: rough_plastic}
_IDS = {m.NAME: i for i, m in _MODULES.items()}
N_TYPES = 21  # the JAX package's type-id space (len(_MODULES) there)


def type_name(tid: int) -> str:
    return _MODULES[tid].NAME


@dataclass
class MaterialTable:
    gpack2: torch.Tensor  # (M, 28) packed dispatch rows
    present: tuple  # static type ids present
    albedo_kinds: tuple  # static texture kinds albedo textures use
    rough_kinds: tuple  # static texture kinds roughness slots use (() = none)

    @staticmethod
    def from_arrays(gpack2, rough_kinds, device) -> "MaterialTable":
        g = np.array(gpack2, np.float32)
        return MaterialTable(
            gpack2=torch.as_tensor(g, device=device),
            present=tuple(sorted({int(t) for t in g[:, N_PARAMS]})),
            albedo_kinds=tuple(sorted({int(t) for t in g[:, -1]})),
            rough_kinds=tuple(sorted(int(t) for t in np.asarray(rough_kinds).ravel())),
        )


def _module(spec):
    tname = spec.get("type", "lambert")
    if tname not in _IDS:
        raise NotImplementedError(f"bsdf type '{tname}' is not ported")
    return _IDS[tname], _MODULES[_IDS[tname]]


def pack_materials(bsdf_specs: List[dict], tex_builder) -> dict:
    """bsdf specs -> numpy {"gpack": (M, 18) [params | type | albedo tex],
    "lobes": (M,)}, as dispatch.py pack_materials packs them. Roughness
    textures land in tex_builder.rough_ids."""
    n = len(bsdf_specs)
    params, types, lobes, albedo = [], [], [], []
    for spec in bsdf_specs:
        tid, mod = _module(spec)
        params.append(mod.pack(spec, np.zeros(N_PARAMS, np.float32), tex_builder))
        types.append(tid)
        lobes.append(mod.lobes_for(spec, None) if hasattr(mod, "lobes_for") else mod.LOBES)
        albedo.append(texture_from_spec(spec.get("albedo", 1.0), tex_builder,
                                        spec.get("_resolve_path")))
    if n == 0:
        params, types, lobes, albedo = [np.zeros(N_PARAMS, np.float32)], [0], [0], [0]
    gpack = np.concatenate(
        [np.stack(params), np.asarray(types, np.float32)[:, None],
         np.asarray(albedo, np.float32)[:, None]], axis=1).astype(np.float32)
    return {"gpack": gpack, "lobes": np.asarray(lobes, np.int32)}


def build_gpack2(packed: dict, tpack: np.ndarray) -> np.ndarray:
    """pack_materials' rows + the texture table -> the (M, 28) dispatch rows:
    each material's lobes and its albedo texture's header appended
    (flatten.py:1093-1099)."""
    gpack = packed["gpack"]
    at = np.clip(gpack[:, -1].astype(np.int64), 0, tpack.shape[0] - 1)
    return np.concatenate([gpack, packed["lobes"].astype(np.float32)[:, None], tpack[at]],
                          axis=1).astype(np.float32)


def gather(mats: MaterialTable, textures, mat_id, uv):
    """ONE row gather per lane -> (params, type, albedo, lobes)."""
    row = mats.gpack2[torch.clamp(mat_id, 0, mats.gpack2.shape[0] - 1)]
    params = row[..., :N_PARAMS]
    mtype = row[..., N_PARAMS].to(torch.int64)
    tex_id = row[..., N_PARAMS + 1].to(torch.int64)
    lobes = row[..., N_PARAMS + 2].to(torch.int64)
    hdr = row[..., N_PARAMS + 3:]
    albedo = eval_texture(textures, tex_id, uv, may=mats.albedo_kinds,
                          pre=(hdr[..., :-1], hdr[..., -1].to(torch.int64)))
    return params, mtype, albedo, lobes


def bsdf_eval(mats: MaterialTable, pre, uv, wi, wo, nonspecular_only=False, textures=None):
    """f * |cos| (N, 3) of the gathered rows `pre`; `textures` is read where
    a roughness slot holds a texture."""
    params, mtype, albedo = pre[:3]
    ctx = (mats, textures)
    out = torch.zeros(wi.shape[:-1] + (3,), dtype=torch.float32, device=wi.device)
    for tid in mats.present:
        f = _MODULES[tid].eval(ctx, params, albedo, uv, wi, wo, nonspecular_only)
        out = torch.where((mtype == tid)[..., None], f, out)
    return out


def bsdf_pdf(mats: MaterialTable, pre, uv, wi, wo, nonspecular_only=False, textures=None):
    params, mtype, albedo = pre[:3]
    ctx = (mats, textures)
    out = torch.zeros(wi.shape[:-1], dtype=torch.float32, device=wi.device)
    for tid in mats.present:
        p = _MODULES[tid].pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only)
        out = torch.where(mtype == tid, p, out)
    return out


def bsdf_sample(mats: MaterialTable, pre, uv, wi, u2, u1, nonspecular_only=False,
                textures=None) -> BsdfSample:
    params, mtype, albedo = pre[:3]
    ctx = (mats, textures)
    res = BsdfSample.invalid(wi.shape[0], wi.device)
    for tid in mats.present:
        s = _MODULES[tid].sample(ctx, params, albedo, uv, wi, u2, u1, nonspecular_only)
        m = mtype == tid
        res = BsdfSample(
            wo=torch.where(m[..., None], s.wo, res.wo),
            weight=torch.where(m[..., None], s.weight, res.weight),
            pdf=torch.where(m, s.pdf, res.pdf),
            lobe=torch.where(m, s.lobe, res.lobe),
            valid=torch.where(m, s.valid, res.valid),
        )
    return res


def bsdf_eta_sq(mats: MaterialTable, pre, wi, wo):
    """sqr(Bsdf::eta(event)): the non-adjoint radiance factor that eval and
    sample fold in (Bsdf.hpp:87); adjoint transport divides it back out.
    Only the dielectrics have eta != 1."""
    params, mtype = pre[:2]
    out = torch.ones(wi.shape[:-1], dtype=torch.float32, device=wi.device)
    for tid in mats.present:
        mod = _MODULES[tid]
        if hasattr(mod, "eta_sq"):
            out = torch.where(mtype == tid, mod.eta_sq(params, wi, wo), out)
    return out
