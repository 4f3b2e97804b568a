"""mc-loader stage 2: resource-pack model resolution.

Port scope (ResourcePackLoader.cpp, Model.cpp, ModelResolver.hpp):
  - model JSON loading with parent-chain inheritance and "#var" texture
    variable resolution (Model.cpp loadTextures/loadElements + ModelResolver)
  - blockstate variant -> model reference (ResourcePackLoader::loadStates;
    first variant of a list is used deterministically where the reference
    randomizes per-instance with its rand source)
  - mapping.json legacy (id, data, mask) -> blockstate variant
    (ResourcePackLoader::buildBlockMapping, :228-295)
  - per-face-direction textures of FULL-CUBE models: for each of the six
    cube faces, the resolved element face lying on that boundary plane
    supplies the texture (CubicElement faces down/up/north/south/west/east)
  - emitters.json: emissive texture -> radiance scale
    (ResourcePackLoader::loadEmitters)

Documented simplifications (this stage): non-cube elements render as full
cubes textured by their nearest face (the reference instantiates every
CubicElement box, TraceableMinecraftMap::buildModel); element/variant
rotations and "multipart" states are ignored; special-case geometry
(stairs/fences/doors..., ResourcePackLoader::buildSpecialCase) falls back
to the plain variant; BiomeTexture tinting uses a constant foliage green
instead of the per-biome color ramp (BiomeTexture.cpp).

The port's own copy of tungsten_tpu/models/primitives/mc_resources.py: the same numpy code, so it
yields the same arrays; the port imports nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

# face order used by minecraft.py: (+x, -x, +y, -y, +z, -z) in world axes.
# minecraft model face names: east/west = +x/-x, up/down = +y/-y,
# south/north = +z/-z
_FACE_NAMES = ["east", "west", "up", "down", "south", "north"]

_TINT_GREEN = (0.41, 0.66, 0.26)  # constant grass/foliage tint stand-in


def _read_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class ResourcePack:
    """Loaded view of one or more resource-pack roots (later packs win,
    matching the reference's pack-path precedence)."""

    def __init__(self, roots: List[str]):
        self.roots = [str(r) for r in roots]
        self.models: Dict[str, dict] = {}
        self.states: Dict[str, dict] = {}
        self.emitters: Dict[str, dict] = {}
        self._resolved: Dict[str, dict] = {}
        self._images: Dict[str, Optional[np.ndarray]] = {}
        for root in self.roots:
            self._load_models(os.path.join(root, "assets/minecraft/models"))
            self._load_states(os.path.join(root, "assets/minecraft/blockstates"))
            em = _read_json(os.path.join(root, "emitters.json"))
            if isinstance(em, list):
                for e in em:
                    if isinstance(e, dict) and "texture" in e:
                        self.emitters[e["texture"]] = e
        self.mapping = self._load_mapping()
        if not self.models:
            raise ValueError(f"no models found in resource packs {roots}")

    # ---- raw loading ----
    def _load_models(self, base, prefix=""):
        if not os.path.isdir(base):
            return
        for entry in sorted(os.listdir(base)):
            p = os.path.join(base, entry)
            if os.path.isdir(p):
                self._load_models(p, prefix + entry + "/")
            elif entry.endswith(".json"):
                doc = _read_json(p)
                if isinstance(doc, dict):
                    self.models.setdefault(prefix + entry[:-5], doc)

    def _load_states(self, base):
        if not os.path.isdir(base):
            return
        for entry in sorted(os.listdir(base)):
            if entry.endswith(".json"):
                doc = _read_json(os.path.join(base, entry))
                if isinstance(doc, dict):
                    self.states.setdefault(entry[:-5], doc)

    def _load_mapping(self):
        """mapping.json rows -> {(id << 4) | data: (blockstate, variant)}
        (buildBlockMapping mask semantics: every data nibble j with
        (j & mask) == data maps to the row)."""
        out: Dict[int, Tuple[str, str]] = {}
        for root in self.roots:
            doc = _read_json(os.path.join(root, "mapping.json"))
            if not isinstance(doc, list):
                continue
            for row in doc:
                if not isinstance(row, dict) or "id" not in row:
                    continue
                bid = int(row["id"])
                data = int(row.get("data", 0))
                mask = int(row.get("mask", 15))
                state = row.get("blockstate", "")
                variant = row.get("variant", "normal")
                for j in range(16):
                    if (j & mask) == data:
                        out.setdefault((bid << 4) | j, (state, variant))
        return out

    # ---- model resolution (ModelResolver) ----
    def resolve_model(self, name: str) -> Optional[dict]:
        """Parent-chain merge: child textures/elements override the
        parent's; '#var' texture refs resolve through the merged dict."""
        if name in self._resolved:
            return self._resolved[name]
        chain = []
        cur = name
        seen = set()
        while cur and cur not in seen:
            seen.add(cur)
            m = self.models.get(cur) or self.models.get("block/" + cur)
            if m is None:
                break
            chain.append(m)
            cur = m.get("parent", "")
            cur = cur.split(":", 1)[-1]  # strip "minecraft:"
        if not chain:
            return None
        textures: Dict[str, str] = {}
        elements = None
        for m in reversed(chain):  # root parent first, child last wins
            textures.update(m.get("textures", {}))
            if m.get("elements"):
                elements = m["elements"]
        def deref(t, depth=0):
            while isinstance(t, str) and t.startswith("#") and depth < 16:
                t = textures.get(t[1:], "")
                depth += 1
            return t if isinstance(t, str) else ""
        res = dict(textures={k: deref(v) for k, v in textures.items()},
                   elements=elements or [])
        self._resolved[name] = res
        return res

    def state_model(self, state: str, variant: str) -> Optional[str]:
        """blockstate variant -> model name (first list entry; the
        reference samples one per block instance from its rand source)."""
        doc = self.states.get(state)
        if not doc:
            return None
        variants = doc.get("variants", {})
        v = variants.get(variant)
        if v is None and variants:
            v = next(iter(variants.values()))
        if isinstance(v, list) and v:
            v = v[0]
        if isinstance(v, dict):
            return str(v.get("model", "")).split(":", 1)[-1]
        return None

    # ---- textures ----
    def texture_image(self, tex: str) -> Optional[np.ndarray]:
        if tex in self._images:
            return self._images[tex]
        img = None
        tex_rel = tex.split(":", 1)[-1]
        for root in reversed(self.roots):  # later packs take precedence
            p = os.path.join(root, "assets/minecraft/textures",
                             tex_rel + ".png")
            if os.path.exists(p):
                from ...io.imageio import load_image

                img = np.asarray(load_image(p), np.float32)[..., :3]
                break
        self._images[tex] = img
        return img

    def face_textures(self, packed_id: int):
        """packed legacy id -> (six face texture names (+x,-x,+y,-y,+z,-z),
        tint flags, model found?). Full-cube face assignment: the element
        face on each boundary plane supplies that direction's texture; a
        model with no elements (e.g. pure cube_all parents) uses the 'all'
        / 'side'/'top'/'bottom' conventions."""
        entry = self.mapping.get(packed_id)
        if entry is None:
            return None
        state, variant = entry
        mname = self.state_model(state, variant)
        if not mname:
            return None
        model = self.resolve_model(mname)
        if model is None:
            return None
        texs = [None] * 6
        tints = [False] * 6
        for el in model["elements"]:
            faces = el.get("faces", {})
            for fi, fname in enumerate(_FACE_NAMES):
                f = faces.get(fname)
                if f and texs[fi] is None:
                    t = f.get("texture", "")
                    if t.startswith("#"):
                        t = model["textures"].get(t[1:], "")
                    texs[fi] = t or None
                    tints[fi] = "tintindex" in f
        t = model["textures"]
        fallback = (t.get("all") or t.get("side") or t.get("texture")
                    or next(iter(t.values()), None))
        for fi in range(6):
            if texs[fi] is None:
                if fi == 2:
                    texs[fi] = t.get("top") or t.get("end") or fallback
                elif fi == 3:
                    texs[fi] = t.get("bottom") or t.get("end") or fallback
                else:
                    texs[fi] = fallback
        return texs, tints

    def emission_of(self, tex: str):
        """emitters.json row for a texture -> emission rgb, or None.
        Accepts the reference's primary_scale on the texture's average
        color, or an explicit 'color'."""
        e = self.emitters.get(tex) or self.emitters.get(
            tex.split("/")[-1])
        if not e:
            return None
        if "color" in e:
            return [float(c) for c in np.broadcast_to(
                np.asarray(e["color"], np.float32).ravel(), (3,))]
        scale = float(e.get("primary_scale", e.get("scale", 1.0)))
        img = self.texture_image(tex)
        avg = img.mean(axis=(0, 1)) if img is not None else np.ones(3)
        return [float(c) for c in avg * scale]


def block_materials_pack(packed_ids: np.ndarray, axes: np.ndarray,
                         signs: np.ndarray, pack: ResourcePack,
                         tex_builder):
    """Resource-pack analog of minecraft.block_materials: per (block,
    face-direction) bsdf specs with REAL textures. Returns (specs,
    mat_of_face (F,), emission list per spec, uv_kind per spec).

    Faces whose block has no pack mapping fall back to the stage-1
    palette color (the reference's missing-texture magenta analog)."""
    from .minecraft import _A, _E, _MISSING

    # face-direction index in _FACE_NAMES order from (axis, sign):
    # axis 2 (x): +x -> 0, -x -> 1; axis 1 (y): 2/3; axis 0 (z): 4/5
    fdir = np.select(
        [(axes == 2) & (signs > 0), (axes == 2) & (signs < 0),
         (axes == 1) & (signs > 0), (axes == 1) & (signs < 0),
         (axes == 0) & (signs > 0), (axes == 0) & (signs < 0)],
        [0, 1, 2, 3, 4, 5])
    specs: List[dict] = []
    emis: List = []
    key_of: Dict[tuple, int] = {}
    mat_of_face = np.zeros(len(packed_ids), np.int32)
    tex_cache: Dict[str, int] = {}

    def tex_id(tname, tinted):
        key = (tname, tinted)
        if key not in tex_cache:
            img = pack.texture_image(tname)
            if img is None:
                tex_cache[key] = -1
            elif tinted:
                # constant-tint stand-in for BiomeTexture (see module doc)
                tex_cache[key] = tex_builder.add_bitmap(
                    img * np.asarray(_TINT_GREEN, np.float32),
                    path_key=f"__mc_tint_{tname}")
            else:
                tex_cache[key] = tex_builder.add_bitmap(
                    img, path_key=f"__mc_{tname}")
        return tex_cache[key]

    for i, (pid, fd) in enumerate(zip(packed_ids, fdir)):
        pid = int(pid)
        fd = int(fd)
        key = (pid, fd)
        if key not in key_of:
            ft = pack.face_textures(pid)
            spec = None
            emission = None
            if ft is not None:
                texs, tints = ft
                tname = texs[fd]
                tid = tex_id(tname, tints[fd]) if tname else -1
                if tid >= 0:
                    spec = {"name": f"__mc_{pid}_{fd}", "type": "lambert",
                            "albedo": {"type": "_prebuilt", "id": tid}}
                    emission = pack.emission_of(tname)
            if spec is None:
                b = pid >> 4
                if b in _E:
                    albedo, em = _E[b]
                    emission = list(em)
                else:
                    albedo = _A.get(b, _MISSING)
                spec = {"name": f"__mc_{pid}_{fd}", "type": "lambert",
                        "albedo": list(albedo)}
            key_of[key] = len(specs)
            specs.append(spec)
            emis.append(emission)
        mat_of_face[i] = key_of[key]
    return specs, mat_of_face, emis
