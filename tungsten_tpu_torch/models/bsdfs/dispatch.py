"""Material table + batched masked BSDF dispatch on torch tensors.

Port of tungsten_tpu/models/bsdfs/dispatch.py for the two BSDF families the
slice carries. Type ids are the JAX package's (`_MODULES` order,
dispatch.py:42-47): lambert = 0, rough_conductor = 3, so packed material rows
are interchangeable. Every other BSDF type raises NotImplementedError.

The hot loop reads one packed row per lane (`gpack2`, 28 floats):
[params(16) | type | albedo tex id | lobes | albedo texture header (9)].
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from . import lambert, rough_conductor
from .common import BsdfSample
from ..textures.textures import eval_texture, texture_from_spec

N_PARAMS = 16

# type id -> module, with the JAX package's ids
_MODULES = {0: lambert, 3: rough_conductor}
_IDS = {m.NAME: i for i, m in _MODULES.items()}


@dataclass
class MaterialTable:
    gpack2: torch.Tensor  # (M, 28) packed dispatch rows
    present: tuple  # static type ids present
    albedo_kinds: tuple  # static texture kinds albedo textures use

    @staticmethod
    def from_arrays(gpack2, device) -> "MaterialTable":
        g = np.array(gpack2, np.float32)
        return MaterialTable(
            gpack2=torch.as_tensor(g, device=device),
            present=tuple(sorted({int(t) for t in g[:, N_PARAMS]})),
            albedo_kinds=tuple(sorted({int(t) for t in g[:, -1]})),
        )


def pack_materials(bsdf_specs: List[dict], tex_builder) -> dict:
    """bsdf specs -> numpy {"gpack": (M, 18) [params | type | albedo tex],
    "lobes": (M,)}, as dispatch.py pack_materials packs them."""
    n = len(bsdf_specs)
    params, types, lobes, albedo = [], [], [], []
    for spec in bsdf_specs:
        tname = spec.get("type", "lambert")
        if tname not in _IDS:
            raise NotImplementedError(f"bsdf type '{tname}' is not ported")
        tid = _IDS[tname]
        mod = _MODULES[tid]
        params.append(mod.pack(spec, np.zeros(N_PARAMS, np.float32), tex_builder))
        types.append(tid)
        lobes.append(mod.LOBES)
        albedo.append(texture_from_spec(spec.get("albedo", 1.0), tex_builder,
                                        spec.get("_resolve_path")))
    if n == 0:
        params, types, lobes, albedo = [np.zeros(N_PARAMS, np.float32)], [0], [0], [0]
    gpack = np.concatenate(
        [np.stack(params), np.asarray(types, np.float32)[:, None],
         np.asarray(albedo, np.float32)[:, None]], axis=1).astype(np.float32)
    return {"gpack": gpack, "lobes": np.asarray(lobes, np.int32)}


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


def bsdf_eval(mats: MaterialTable, pre, uv, wi, wo):
    params, mtype, albedo = pre[:3]
    out = torch.zeros(wi.shape[:-1] + (3,), dtype=torch.float32, device=wi.device)
    for tid in mats.present:
        f = _MODULES[tid].eval(params, albedo, uv, wi, wo)
        out = torch.where((mtype == tid)[..., None], f, out)
    return out


def bsdf_pdf(mats: MaterialTable, pre, uv, wi, wo):
    params, mtype, albedo = pre[:3]
    out = torch.zeros(wi.shape[:-1], dtype=torch.float32, device=wi.device)
    for tid in mats.present:
        p = _MODULES[tid].pdf(params, albedo, uv, wi, wo)
        out = torch.where(mtype == tid, p, out)
    return out


def bsdf_sample(mats: MaterialTable, pre, uv, wi, u2, u1) -> BsdfSample:
    params, mtype, albedo = pre[:3]
    res = BsdfSample.invalid(wi.shape[0], wi.device)
    for tid in mats.present:
        s = _MODULES[tid].sample(params, albedo, uv, wi, u2, u1)
        m = mtype == tid
        res = BsdfSample(
            wo=torch.where(m[..., None], s.wo, res.wo),
            weight=torch.where(m[..., None], s.weight, res.weight),
            pdf=torch.where(m, s.pdf, res.pdf),
            lobe=torch.where(m, s.lobe, res.lobe),
            valid=torch.where(m, s.valid, res.valid),
        )
    return res
