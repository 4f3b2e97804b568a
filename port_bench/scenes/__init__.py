"""The benchmark's scene writer: a frozen copy of the parts of the port's
synth.py that its configurations use (the materialtest-like scene and the
closed box with the glass ball), so that later changes to the program
cannot change the benchmark's inputs.

A configuration file (configs/<name>.json) gives the scene's kind and its
sizes as top-level keys; `write_scene(out_dir, cfg, integrator)` writes
scene.json, ball.obj and, for the materialtest kind, sky.pfm. The
integrator block follows the traffic: "path_tracer" or
"progressive_photon_map" (with the configuration's photon count).
"""
from __future__ import annotations

import copy
import json
import os

import numpy as np

INTEGRATORS = ("path_tracer", "progressive_photon_map")

BALL_BSDFS = [
    {"name": "floor", "type": "lambert",
     "albedo": {"type": "checker", "on_color": [0.8, 0.8, 0.8],
                "off_color": [0.2, 0.2, 0.2], "res_u": 20, "res_v": 20}},
    {"name": "ball", "type": "rough_conductor", "material": "Cu",
     "distribution": "ggx", "roughness": 0.1},
    {"name": "inner", "type": "lambert", "albedo": [0.6, 0.3, 0.2]},
]
CAUSTIC_BSDF = {"name": "ball", "type": "dielectric", "ior": 1.5}
BOX_BSDF = {"name": "wall", "type": "lambert", "albedo": [0.7, 0.68, 0.62]}
BOX_PRIMS = [
    {"type": "cube", "bsdf": "wall",
     "transform": {"position": [0.0, 2.0, 2.5], "scale": [8.0, 4.0, 10.0]}},
    {"type": "quad", "bsdf": "inner", "emission": [12.0, 11.0, 9.0],
     "transform": {"position": [0.0, 3.95, 1.5], "scale": 2.0, "rotation": [180, 0, 0]}},
]


def scene_dict(cfg: dict, integrator: str = "path_tracer") -> dict:
    """The scene document of configuration `cfg` under `integrator`."""
    sc = cfg
    if integrator not in INTEGRATORS:
        raise ValueError(f"integrator {integrator!r}: one of {INTEGRATORS}")
    doc = {
        "bsdfs": copy.deepcopy(BALL_BSDFS),
        "primitives": [
            {"type": "quad", "bsdf": "floor",
             "transform": {"position": [0, 0, 0], "scale": [12, 1, 12]}},
            {"type": "mesh", "file": "ball.obj", "smooth": True, "bsdf": "ball",
             "transform": {"position": [0, 1, 0]}},
            {"type": "cube", "bsdf": "inner",
             "transform": {"position": [1.9, 0.5, 0.6], "scale": 1.0,
                           "rotation": [0, 30, 0]}},
            {"type": "infinite_sphere", "emission": "sky.pfm",
             "transform": {"rotation": [0, 20, 0]}},
        ],
        "camera": {"type": "pinhole", "tonemap": "filmic", "fov": 40,
                   "resolution": list(sc["resolution"]),
                   "transform": {"position": [0.5, 2.2, 6.5], "look_at": [0.4, 0.8, 0],
                                 "up": [0, 1, 0]}},
        "integrator": {"type": "path_tracer", "max_bounces": sc["max_bounces"]},
        "renderer": {"spp": sc["spp"], "spp_step": sc["spp"]},
    }
    if sc["kind"] == "box":
        doc["bsdfs"].append(copy.deepcopy(BOX_BSDF))
        doc["primitives"] = doc["primitives"][1:3] + copy.deepcopy(BOX_PRIMS)
        doc["integrator"]["type"] = integrator
        if integrator == "progressive_photon_map":
            doc["integrator"]["photon_count"] = sc["photon_count"]
        if sc.get("caustic"):
            doc["bsdfs"] = [copy.deepcopy(CAUSTIC_BSDF) if b["name"] == "ball" else b
                            for b in doc["bsdfs"]]
    elif sc["kind"] != "materialtest" or integrator != "path_tracer":
        raise ValueError(f"scene kind {sc['kind']!r} under {integrator!r}")
    return doc


def write_sphere_obj(path: str, nu: int, nv: int):
    """Unit UV sphere, 2 * nu * nv triangles, with normals and uvs."""
    us = np.linspace(0.0, 2.0 * np.pi, nu + 1)
    vs = np.linspace(0.0, np.pi, nv + 1)
    uu, vv = np.meshgrid(us, vs, indexing="xy")
    pos = np.stack([np.sin(vv) * np.cos(uu), np.cos(vv), np.sin(vv) * np.sin(uu)],
                   axis=-1).reshape(-1, 3)
    uv = np.stack([uu / (2.0 * np.pi), 1.0 - vv / np.pi], axis=-1).reshape(-1, 2)
    j, i = np.meshgrid(np.arange(nv), np.arange(nu), indexing="ij")
    a = (j * (nu + 1) + i).ravel()
    b, c = a + 1, a + nu + 1
    dd = c + 1
    faces = np.concatenate([np.stack([a, b, dd], 1), np.stack([a, dd, c], 1)]) + 1
    lines = [f"v {x:.7f} {y:.7f} {z:.7f}\nvn {x:.7f} {y:.7f} {z:.7f}" for x, y, z in pos]
    lines += [f"vt {s:.7f} {t:.7f}" for s, t in uv]
    lines += [f"f {p}/{p}/{p} {q}/{q}/{q} {r}/{r}/{r}" for p, q, r in faces]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def sky(w: int, h: int) -> np.ndarray:
    """Lat-long sky (row 0 = up): blue gradient, dim ground, bright sun."""
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    theta = v[:, None] * np.pi  # 0 at the zenith
    phi = (u[None, :] - 0.5) * 2.0 * np.pi
    up = np.cos(theta)
    img = np.where(up[..., None] > 0.0,
                   np.array([0.35, 0.55, 1.0]) * (0.4 + 0.6 * up[..., None]),
                   np.array([0.25, 0.22, 0.2]) * np.ones_like(up)[..., None])
    img = np.broadcast_to(img, (h, w, 3)).copy()
    # sun at theta 40 deg, phi 60 deg, ~3 deg radius, radiance ~ 400
    sun_t, sun_p = np.deg2rad(40.0), np.deg2rad(60.0)
    dirs = np.stack([np.sin(theta) * np.cos(phi), np.cos(theta) * np.ones_like(phi),
                     np.sin(theta) * np.sin(phi)], axis=-1)
    sun = np.array([np.sin(sun_t) * np.cos(sun_p), np.cos(sun_t), np.sin(sun_t) * np.sin(sun_p)])
    cosang = np.clip(dirs @ sun, -1.0, 1.0)
    blob = 400.0 * np.exp(-((np.arccos(cosang) / np.deg2rad(3.0)) ** 2))
    img += blob[..., None] * np.array([1.0, 0.9, 0.75])
    return img.astype(np.float32)


def save_pfm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if img.ndim == 3 else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")
        f.write(np.ascontiguousarray(img[::-1]).astype("<f4").tobytes())


def write_scene(out_dir: str, cfg: dict, integrator: str = "path_tracer") -> str:
    """Write configuration `cfg`'s scene into out_dir; returns scene.json's path."""
    sc = cfg
    os.makedirs(out_dir, exist_ok=True)
    write_sphere_obj(os.path.join(out_dir, "ball.obj"), *sc["sphere_segments"])
    if sc["kind"] == "materialtest":
        save_pfm(os.path.join(out_dir, "sky.pfm"), sky(*sc["sky"]))
    path = os.path.join(out_dir, "scene.json")
    with open(path, "w") as f:
        json.dump(scene_dict(cfg, integrator), f, indent=1)
    return path
