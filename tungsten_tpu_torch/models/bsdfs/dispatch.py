"""Material table + batched masked BSDF dispatch on torch tensors.

Port of tungsten_tpu/models/bsdfs/dispatch.py for every BSDF of the JAX
package: lambert, null, mirror, rough_conductor, smooth_coat, oren_nayar,
phong, dielectric, rough_dielectric, conductor, plastic, rough_plastic,
thinsheet, transparency, forward, mixed, diffuse_transmission, rough_coat
and the fibers hair, lambertian_fiber and rough_wire. Type ids are the JAX
package's (`_MODULES` order, dispatch.py:42-47), so packed material rows are
interchangeable. Unknown names raise NotImplementedError, naming the type.
The fibers read their local frame with the fiber tangent on y (the
tracers' `_shading_frame` builds it from FlatScene.tri_tan); hair's
azimuthal tables are precomputed per hair material at pack time and ride in
`MaterialTable.hair_tables` / `hair_cdf` / `hair_sums`.

The hot loop reads one packed row per lane (`gpack2`, 28 floats):
[params(16) | type | albedo tex id | lobes | albedo texture header (9)].
Like the JAX package, every call evaluates each type present in the scene
over all lanes and selects by mask.

Nesting: the wrappers (smooth_coat, rough_coat, mixed, transparency; IS_WRAPPER)
reference a substrate material by table index and re-enter the dispatcher
through `nested_eval` / `nested_pdf` / `nested_sample`, which loop over the
non-wrapper types only: one level of nesting, as the JAX package allows
(deeper nesting and coat-on-coat raise at pack time). A nested call reads the
substrate's row from `MaterialTable.sub_pre` where the tracer stashed it (the
second half of a `gpack3` row: the self row and the substrate row in one
gather, built where no `mixed` is present), and gathers the row by index
otherwise.

Module interface (batched over lanes; ctx = (MaterialTable, TextureTable)):
    NAME; LOBES or lobes_for(spec, sub_lobes_of); IS_WRAPPER (default False);
    pack(spec, params, tex_builder)
    eval(ctx, params, albedo, uv, wi, wo, nonspecular_only) -> (N, 3)
    pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only) -> (N,)
    sample(ctx, params, albedo, uv, wi, u2, u1, nonspecular_only) -> BsdfSample
    eta_sq(params, wi, wo) -> (N,) where eta != 1 (the dielectrics)
    forward_transparency(ctx, params, albedo, uv, wi) -> (N, 3) where the
    type has a forward lobe (thinsheet, transparency, forward)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from . import (conductor, dielectric, diffuse_transmission, forward, hair, lambert,
               lambertian_fiber, mirror, mixed, null, oren_nayar, phong, plastic, rough_coat,
               rough_conductor, rough_dielectric, rough_plastic, rough_wire, smooth_coat,
               thinsheet, transparency)
from .common import BsdfSample
from ..textures.textures import eval_texture, texture_from_spec

N_PARAMS = 16
ROW = N_PARAMS + 12  # a gpack2 row; a gpack3 row is two of them

# type id -> module, with the JAX package's ids; 18-20 are the fibers
_MODULES = {0: lambert, 1: null, 2: mirror, 3: rough_conductor, 4: smooth_coat,
            5: oren_nayar, 6: phong, 7: dielectric, 8: rough_dielectric, 9: conductor,
            10: plastic, 11: rough_plastic, 12: thinsheet, 13: transparency, 14: forward,
            15: mixed, 16: diffuse_transmission, 17: rough_coat, 18: hair,
            19: lambertian_fiber, 20: rough_wire}
_IDS = {m.NAME: i for i, m in _MODULES.items()}
N_TYPES = len(_MODULES)  # the JAX package's type-id space
HAIR_KEYS = ("hair_tables", "hair_cdf", "hair_sums")  # MaterialTable's hair arrays
# the references a wrapper-on-wrapper check reads (dispatch.py:168; a
# transparency's base is left to lobes_for's depth check)
SUB_KEYS = ("_substrate_index", "_bsdf0_index", "_bsdf1_index")


def type_name(tid: int) -> str:
    return _MODULES[tid].NAME


def module_for_id(tid: int):
    return _MODULES[tid]


def is_wrapper(mod) -> bool:
    return getattr(mod, "IS_WRAPPER", False)


@dataclass
class MaterialTable:
    gpack2: torch.Tensor  # (M, 28) packed dispatch rows
    present: tuple  # static type ids present
    albedo_kinds: tuple  # static texture kinds albedo textures use
    rough_kinds: tuple  # static texture kinds roughness slots use (() = none)
    # (M, 56) [own gpack2 row | its substrate's]: built where a single-substrate
    # wrapper is present and mixed is not, else None
    gpack3: Optional[torch.Tensor] = None
    # the substrate rows of the lanes' own materials, decoded, stashed by a
    # tracer for the nested calls (dataclasses.replace; None: gather by index)
    sub_pre: Optional[tuple] = None
    # hair's azimuthal tables, one slab per hair material (hair.py
    # precompute_azimuthal), None without hair: (H, 3, 64, 64, 3) N_p,
    # (H, 3, 64, 65) row CDFs, (H, 3, 64) row sums
    hair_tables: Optional[torch.Tensor] = None
    hair_cdf: Optional[torch.Tensor] = None
    hair_sums: Optional[torch.Tensor] = None

    @staticmethod
    def from_arrays(gpack2, rough_kinds, device, gpack3=None, hair=None) -> "MaterialTable":
        """`hair`: {HAIR_KEYS: numpy} where a hair material is present."""
        g = np.array(gpack2, np.float32)
        present = tuple(sorted({int(t) for t in g[:, N_PARAMS]}))
        hair = {k: v for k, v in (hair or {}).items() if v is not None}
        if _IDS["hair"] in present and sorted(hair) != sorted(HAIR_KEYS):
            raise KeyError(f"from_arrays: a hair material needs {HAIR_KEYS}, given {sorted(hair)}")
        return MaterialTable(
            gpack2=torch.as_tensor(g, device=device),
            present=present,
            albedo_kinds=tuple(sorted({int(t) for t in g[:, -1]})),
            rough_kinds=tuple(sorted(int(t) for t in np.asarray(rough_kinds).ravel())),
            gpack3=None if gpack3 is None else torch.as_tensor(
                np.array(gpack3, np.float32), device=device),
            **{k: torch.as_tensor(np.array(v, np.float32), device=device)
               for k, v in hair.items()},
        )


def _module(spec):
    tname = spec.get("type", "lambert")
    if tname not in _IDS:
        raise NotImplementedError(f"bsdf type '{tname}' is not ported")
    return _IDS[tname], _MODULES[_IDS[tname]]


def _hair_pre_pass(bsdf_specs: List[dict]) -> dict:
    """Each hair spec's azimuthal tables (dispatch.py:114-139): the melanin
    mixture (or an explicit sigma_a) -> sigma_a (HairBcsdf.cpp:433-440:
    lerp from eumelanin to pheomelanin by melanin_ratio), beta_r from the
    roughness; the spec gets `_hair_index`, `_beta_r` and `_scale_rad`, which
    hair.pack reads. Returns {HAIR_KEYS: stacked numpy} or {} without hair."""
    slabs = []
    for b in bsdf_specs:
        if b.get("type") != "hair":
            continue
        if "sigma_a" in b:
            sa = b["sigma_a"]
            sigma = np.asarray(sa if isinstance(sa, list) else [sa] * 3, np.float64)
        else:
            c = float(b.get("melanin_concentration", 0.25))
            ratio = float(b.get("melanin_ratio", 0.5))
            eu = np.array([0.419, 0.697, 1.37])
            ph = np.array([0.187, 0.4, 1.05])
            sigma = c * ((1.0 - ratio) * eu + ratio * ph)
        beta_r = max(np.pi / 2 * float(b.get("roughness", 0.1)), 0.04)
        b.update(_hair_index=len(slabs), _beta_r=beta_r,
                 _scale_rad=float(np.deg2rad(float(b.get("scale_angle", 2.0)))))
        slabs.append(hair.precompute_azimuthal(sigma, beta_r))
    return {k: np.stack(v) for k, v in zip(HAIR_KEYS, zip(*slabs))} if slabs else {}


def pack_materials(bsdf_specs: List[dict], tex_builder) -> dict:
    """bsdf specs (nested references resolved to indices by load.py) ->
    numpy {"gpack": (M, 18) [params | type | albedo tex], "lobes": (M,),
    "sub_of": (M,) the substrate of a single-substrate wrapper, else -1,
    "hair": {HAIR_KEYS: stacked tables} ({} without hair)}, as dispatch.py
    pack_materials packs them. Roughness textures land in
    tex_builder.rough_ids."""
    bsdf_specs = [dict(b) for b in bsdf_specs]
    hair_arrays = _hair_pre_pass(bsdf_specs)
    n = len(bsdf_specs)

    def lobes_of(i, depth=0):
        spec = bsdf_specs[i]
        _, mod = _module(spec)
        if hasattr(mod, "lobes_for"):
            if depth > 1:
                raise NotImplementedError("bsdf nesting deeper than one level")
            return mod.lobes_for(spec, lambda j: lobes_of(j, depth + 1))
        return mod.LOBES

    params, types, lobes, albedo, subs = [], [], [], [], []
    for spec in bsdf_specs:
        tid, mod = _module(spec)
        if is_wrapper(mod):
            for key in SUB_KEYS:
                j = spec.get(key, -1)
                if j >= 0 and is_wrapper(_module(bsdf_specs[j])[1]):
                    raise NotImplementedError("nested wrapper bsdfs (coat-on-coat)")
        params.append(mod.pack(spec, np.zeros(N_PARAMS, np.float32), tex_builder))
        types.append(tid)
        lobes.append(lobes_of(len(types) - 1))
        albedo.append(texture_from_spec(spec.get("albedo", 1.0), tex_builder,
                                        spec.get("_resolve_path")))
        subs.append(spec.get("_substrate_index", spec.get("_base_index", -1)))
    if n == 0:
        params, types, lobes, albedo, subs = [np.zeros(N_PARAMS, np.float32)], [0], [0], [0], [-1]
    gpack = np.concatenate(
        [np.stack(params), np.asarray(types, np.float32)[:, None],
         np.asarray(albedo, np.float32)[:, None]], axis=1).astype(np.float32)
    return {"gpack": gpack, "lobes": np.asarray(lobes, np.int32),
            "sub_of": np.asarray(subs, np.int32), "hair": hair_arrays}


def build_gpack2(packed: dict, tpack: np.ndarray) -> np.ndarray:
    """pack_materials' rows + the texture table -> the (M, 28) dispatch rows:
    each material's lobes and its albedo texture's header appended
    (flatten.py:1093-1099)."""
    gpack = packed["gpack"]
    at = np.clip(gpack[:, -1].astype(np.int64), 0, tpack.shape[0] - 1)
    return np.concatenate([gpack, packed["lobes"].astype(np.float32)[:, None], tpack[at]],
                          axis=1).astype(np.float32)


def build_gpack3(packed: dict, gpack2: np.ndarray):
    """The (M, 56) rows [own row | substrate row] where some material is a
    single-substrate wrapper and none is mixed, else None (flatten.py:
    1100-1113; a row without a substrate carries row 0, unused)."""
    sub = packed["sub_of"]
    if not (sub >= 0).any() or _IDS["mixed"] in set(packed["gpack"][:, N_PARAMS].astype(int)):
        return None
    return np.concatenate([gpack2, gpack2[np.clip(sub, 0, gpack2.shape[0] - 1)]], axis=1)


def _parse(mats: MaterialTable, textures, row, uv):
    params = row[..., :N_PARAMS]
    mtype = row[..., N_PARAMS].to(torch.int64)
    tex_id = row[..., N_PARAMS + 1].to(torch.int64)
    lobes = row[..., N_PARAMS + 2].to(torch.int64)
    hdr = row[..., N_PARAMS + 3:]
    albedo = eval_texture(textures, tex_id, uv, may=mats.albedo_kinds,
                          pre=(hdr[..., :-1], hdr[..., -1].to(torch.int64)))
    return params, mtype, albedo, lobes


def gather(mats: MaterialTable, textures, mat_id, uv):
    """ONE row gather per lane -> (params, type, albedo, lobes), and with
    `gpack3` the substrate's decoded row as a fifth entry."""
    if mats.gpack3 is not None:
        row = mats.gpack3[torch.clamp(mat_id, 0, mats.gpack3.shape[0] - 1)]
        return (_parse(mats, textures, row[..., :ROW], uv)
                + (_parse(mats, textures, row[..., ROW:], uv),))
    row = mats.gpack2[torch.clamp(mat_id, 0, mats.gpack2.shape[0] - 1)]
    return _parse(mats, textures, row, uv)


def stash_substrate(mats: MaterialTable, pre):
    """(mats, pre) with a gpack3 gather's substrate rows stashed in
    `mats.sub_pre` for the nested calls (path_tracer.py:1459-1466); as
    given without one."""
    if len(pre) <= 4:
        return mats, pre
    return dataclasses.replace(mats, sub_pre=pre[4]), pre[:4]


def material_lobes(mats: MaterialTable, mat_id):
    """The lobe mask of material `mat_id` (the JAX MaterialTable.lobes; an
    index out of range is clamped, as a JAX gather clamps it: a masked
    branch reads other types' parameters as ids)."""
    return mats.gpack2[torch.clamp(mat_id, 0, mats.gpack2.shape[0] - 1),
                       N_PARAMS + 2].to(torch.int64)


def _present(mats: MaterialTable, nested):
    if not nested:
        return mats.present
    return tuple(t for t in mats.present if not is_wrapper(_MODULES[t]))


def bsdf_eval(mats: MaterialTable, pre, uv, wi, wo, nonspecular_only=False, textures=None,
              nested=False):
    """f * |cos| (N, 3) of the gathered rows `pre`; `textures` is read where
    a texture slot is evaluated. `nested` loops over the non-wrapper types."""
    params, mtype, albedo = pre[:3]
    ctx = (mats, textures)
    out = torch.zeros(wi.shape[:-1] + (3,), dtype=torch.float32, device=wi.device)
    for tid in _present(mats, nested):
        f = _MODULES[tid].eval(ctx, params, albedo, uv, wi, wo, nonspecular_only)
        out = torch.where((mtype == tid)[..., None], f, out)
    return out


def bsdf_pdf(mats: MaterialTable, pre, uv, wi, wo, nonspecular_only=False, textures=None,
             nested=False):
    params, mtype, albedo = pre[:3]
    ctx = (mats, textures)
    out = torch.zeros(wi.shape[:-1], dtype=torch.float32, device=wi.device)
    for tid in _present(mats, nested):
        p = _MODULES[tid].pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only)
        out = torch.where(mtype == tid, p, out)
    return out


def bsdf_sample(mats: MaterialTable, pre, uv, wi, u2, u1, nonspecular_only=False,
                textures=None, nested=False) -> BsdfSample:
    params, mtype, albedo = pre[:3]
    ctx = (mats, textures)
    res = BsdfSample.invalid(wi.shape[0], wi.device)
    for tid in _present(mats, nested):
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


def _nested_pre(ctx, mat_id, uv):
    mats, textures = ctx
    return mats.sub_pre if mats.sub_pre is not None else gather(mats, textures, mat_id, uv)


def nested_eval(ctx, mat_id, uv, wi, wo, nonspecular_only=False):
    """A wrapper's re-entry: the substrate material `mat_id` (per lane)."""
    return bsdf_eval(ctx[0], _nested_pre(ctx, mat_id, uv), uv, wi, wo, nonspecular_only,
                     ctx[1], nested=True)


def nested_pdf(ctx, mat_id, uv, wi, wo, nonspecular_only=False):
    return bsdf_pdf(ctx[0], _nested_pre(ctx, mat_id, uv), uv, wi, wo, nonspecular_only,
                    ctx[1], nested=True)


def nested_sample(ctx, mat_id, uv, wi, u2, u1, nonspecular_only=False):
    return bsdf_sample(ctx[0], _nested_pre(ctx, mat_id, uv), uv, wi, u2, u1,
                       nonspecular_only, ctx[1], nested=True)


def forward_transparency(mats: MaterialTable, pre, uv, wi, textures=None):
    """bsdf.eval(makeForwardEvent()) (N, 3) of the gathered rows `pre`: the
    straight-through transmission, nonzero only for the forward-lobed types
    (path_tracer.py:153-167)."""
    params, mtype, albedo = pre[:3]
    ctx = (mats, textures)
    out = torch.zeros(wi.shape[:-1] + (3,), dtype=torch.float32, device=wi.device)
    for tid in mats.present:
        mod = _MODULES[tid]
        if hasattr(mod, "forward_transparency"):
            val = mod.forward_transparency(ctx, params, albedo, uv, wi)
            out = torch.where((mtype == tid)[..., None], val, out)
    return out


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
