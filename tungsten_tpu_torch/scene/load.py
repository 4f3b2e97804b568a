"""Scene JSON loading: Tungsten's schema, unmodified.

Copy of tungsten_tpu/scene/load.py (the same defaults, including
`stratified_sampler: True`): the port imports nothing from the JAX package.

Mirrors Scene::fromJson (src/core/io/Scene.cpp:236-253): ordered load of
media, bsdfs, primitives, camera, integrator, renderer; named references
("bsdf": "Floor") resolve against earlier-declared objects; inline object
definitions are appended anonymously. Resources (meshes, textures) resolve
relative to the scene file's directory.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..utils import trace


DEFAULT_RENDERER = {
    "output_file": "TungstenRender.png",
    "hdr_output_file": "",
    "resume_render_file": "TungstenRenderState.dat",
    "overwrite_output_files": True,
    "adaptive_sampling": True,
    "enable_resume_render": False,
    "stratified_sampler": True,
    "scene_bvh": True,
    "spp": 32,
    "spp_step": 16,
    "checkpoint_interval": "0",
    "timeout": "0",
    "output_buffers": [],
}

DEFAULT_INTEGRATOR = {
    "type": "path_tracer",
    "min_bounces": 0,
    "max_bounces": 64,
    "enable_consistency_checks": False,
    "enable_two_sided_shading": True,
    "enable_light_sampling": True,
    "enable_volume_light_sampling": True,
    "low_order_scattering": True,
    "include_surfaces": True,
}

DEFAULT_CAMERA = {
    "type": "pinhole",
    "tonemap": "gamma",
    "resolution": [1000, 563],
    "reconstruction_filter": "tent",
    "fov": 60,
}


@dataclass
class SceneDocument:
    path: str
    media: List[dict]
    bsdfs: List[dict]  # each has resolved "_index"; primitives refer by index
    primitives: List[dict]  # each has "_bsdf_index" (int) resolved
    camera: dict
    integrator: dict
    renderer: dict
    bsdf_names: Dict[str, int] = field(default_factory=dict)
    medium_names: Dict[str, int] = field(default_factory=dict)

    def resolve_path(self, rel: str) -> str:
        if os.path.isabs(rel):
            return rel
        return os.path.join(os.path.dirname(self.path), rel)


def _with_defaults(d: Optional[dict], defaults: dict) -> dict:
    out = dict(defaults)
    out.update(d or {})
    return out


@trace.spanned("setup.load")
def load_scene(path: str) -> SceneDocument:
    with open(path) as f:
        raw = json.load(f)
    return parse_scene(raw, path)


def parse_scene(raw: dict, path: str = ".") -> SceneDocument:
    media = list(raw.get("media", []) or [])
    medium_names = {m["name"]: i for i, m in enumerate(media) if "name" in m}

    bsdfs = [dict(b) for b in raw.get("bsdfs", []) or []]
    bsdf_names = {b["name"]: i for i, b in enumerate(bsdfs) if "name" in b}

    doc = SceneDocument(
        path=path,
        media=media,
        bsdfs=bsdfs,
        primitives=[],
        camera=_with_defaults(raw.get("camera"), DEFAULT_CAMERA),
        integrator=_with_defaults(raw.get("integrator"), DEFAULT_INTEGRATOR),
        renderer=_with_defaults(raw.get("renderer"), DEFAULT_RENDERER),
        bsdf_names=bsdf_names,
        medium_names=medium_names,
    )

    def resolve_bsdf(ref) -> int:
        if ref is None:
            # Primitive's default lambert(0.8) (Primitive.hpp default bsdf)
            doc.bsdfs.append({"type": "lambert", "albedo": 0.8})
            return len(doc.bsdfs) - 1
        if isinstance(ref, str):
            if ref not in bsdf_names:
                raise KeyError(f"unknown bsdf reference: {ref!r}")
            return bsdf_names[ref]
        if isinstance(ref, dict):
            doc.bsdfs.append(dict(ref))
            return len(doc.bsdfs) - 1
        raise ValueError(f"bad bsdf reference: {ref!r}")

    def resolve_medium(ref) -> int:
        if ref is None:
            return -1
        if isinstance(ref, str):
            return medium_names[ref]
        if isinstance(ref, dict):
            doc.media.append(dict(ref))
            return len(doc.media) - 1
        raise ValueError(f"bad medium reference: {ref!r}")

    def expand_instances(prims):
        """Flatten "instances" primitives (Instance.cpp:60-93) into copies of
        their masters with composed matrix transforms: a TPU scene is one
        static triangle soup, so instancing happens at load. Binary instance
        resource files (instancesA/B streams) are not supported."""
        from ..math.transform import mat4_from_json

        out = []
        for p in prims:
            if p.get("type") != "instances":
                out.append(p)
                continue
            masters = p.get("masters", [])
            insts = p.get("instances", [])
            if isinstance(insts, str) or "instancesA" in p or "instancesB" in p:
                raise NotImplementedError("binary instance files not supported")
            base_m = mat4_from_json(p.get("transform"))
            for inst in insts:
                mid = int(inst.get("id", 0))
                if mid >= len(masters):
                    continue
                master = dict(masters[mid])
                im = mat4_from_json(inst.get("transform"))
                mm = mat4_from_json(master.get("transform"))
                master["transform"] = [float(v) for v in (base_m @ im @ mm).ravel()]
                out.append(master)
        return out

    for p in expand_instances(raw.get("primitives", []) or []):
        p = dict(p)
        p["_bsdf_index"] = resolve_bsdf(p.get("bsdf"))
        p["_int_medium"] = resolve_medium(p.get("int_medium"))
        p["_ext_medium"] = resolve_medium(p.get("ext_medium"))
        doc.primitives.append(p)

    # resolve nested bsdf references (coat substrates, transparency base,
    # mixed blend inputs); inline definitions are appended anonymously.
    # Iterate with a growing list so appended inline specs are processed too.
    i = 0
    while i < len(doc.bsdfs):
        b = doc.bsdfs[i]
        for json_key, idx_key in (
            ("substrate", "_substrate_index"),
            ("base", "_base_index"),
            ("bsdf0", "_bsdf0_index"),
            ("bsdf1", "_bsdf1_index"),
        ):
            if json_key in b and idx_key not in b:
                b[idx_key] = resolve_bsdf(b[json_key])
        i += 1

    # give material packers access to resource resolution
    for b in doc.bsdfs:
        b["_resolve_path"] = doc.resolve_path

    return doc
