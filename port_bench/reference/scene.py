"""The reference's own reading of a scene file: Tungsten's JSON schema for the
parts the benchmark's scenes use (mesh OBJ, quad, cube, infinite_sphere;
lambert with a constant or checker albedo, rough_conductor with a named
metal, dielectric; a pinhole camera with the tent filter).

Plain numpy and torch; nothing of the program is imported. Geometry is kept
as triangles in world space with vertex normals and uvs, in `dtype` on
`device`.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

# Palik's measured complex IOR of copper, per RGB channel (the values every
# physically based renderer ships for "Cu": eta, k)
METALS = {
    "Cu": ((0.2004376970, 0.9240334304, 1.1022119527),
           (3.9129485033, 2.4528477015, 2.1421879552)),
}

LAMBERT, CONDUCTOR, DIELECTRIC = 0, 1, 2

# unit quad in the xz plane, normal +y, and its two triangles' winding
QUAD_CORNERS = np.array([[-0.5, 0, -0.5], [0.5, 0, -0.5], [0.5, 0, 0.5], [-0.5, 0, 0.5]],
                        np.float64)
QUAD_UV = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
QUAD_TRIS = np.array([[0, 2, 1], [0, 3, 2]])


def _vec3(v, default=(0.0, 0.0, 0.0)):
    if v is None:
        v = default
    a = np.asarray(v, np.float64).ravel()
    return np.repeat(a, 3) if a.size == 1 else a


def _rot_yxz(deg):
    """Euler angles in degrees, applied as Tungsten's rotYXZ."""
    r = _vec3(deg) * np.pi / 180.0
    c, s = np.cos(r), np.sin(r)
    return np.array([
        [c[1] * c[2] - s[1] * s[0] * s[2], -c[1] * s[2] - s[1] * s[0] * c[2], -s[1] * c[0]],
        [c[0] * s[2], c[0] * c[2], -s[0]],
        [s[1] * c[2] + c[1] * s[0] * s[2], -s[1] * s[2] + c[1] * s[0] * c[2], c[1] * c[0]],
    ])


def transform(obj) -> np.ndarray:
    """A JSON transform (position, scale, rotation, look_at, up) -> 4x4."""
    obj = obj or {}
    pos = _vec3(obj.get("position"))
    x, y, z = np.eye(3)
    if "look_at" in obj:
        z = _vec3(obj["look_at"]) - pos
        y = _vec3(obj.get("up", (0.0, 1.0, 0.0)))
    # z first, then y, then x, each made orthogonal to those before it
    z = z / np.linalg.norm(z)
    y = y - z * z.dot(y)
    y = y / np.linalg.norm(y)
    x = x - z * z.dot(x)
    x = x - y * y.dot(x)
    x = np.cross(y, z) if x.dot(x) < 1e-5 else x / np.linalg.norm(x)
    if np.dot(np.cross(x, y), z) < 0.0:
        x = -x
    if "scale" in obj:
        s = _vec3(obj["scale"])
        x, y, z = x * s[0], y * s[1], z * s[2]
    if "rotation" in obj:
        r = _rot_yxz(obj["rotation"])
        x, y, z = r @ x, r @ y, r @ z
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, y, z, pos
    return m


def read_obj(path):
    """(positions, normals or None, uvs, triangles) of an OBJ's faces, each
    corner its own vertex."""
    vp, vn, vt, corners = [], [], [], []
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                vp.append([float(a) for a in t[1:4]])
            elif t[0] == "vn":
                vn.append([float(a) for a in t[1:4]])
            elif t[0] == "vt":
                vt.append([float(a) for a in t[1:3]])
            elif t[0] == "f":
                ids = [[int(a) if a else 0 for a in (s.split("/") + ["", ""])[:3]]
                       for s in t[1:]]
                for k in range(1, len(ids) - 1):
                    corners += [ids[0], ids[k], ids[k + 1]]
    c = np.asarray(corners, np.int64) - 1
    vp, vt = np.asarray(vp, np.float64), np.asarray(vt or [[0.0, 0.0]], np.float64)
    pos = vp[c[:, 0]]
    uv = np.where((c[:, 1] >= 0)[:, None], vt[np.maximum(c[:, 1], 0)], 0.0)
    nrm = np.asarray(vn, np.float64)[c[:, 2]] if vn and (c[:, 2] >= 0).all() else None
    return pos, nrm, uv, np.arange(len(c)).reshape(-1, 3)


def cube_soup():
    """The unit cube's 12 triangles, outward winding, a uv square a face."""
    pos, uv, tris = [], [], []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            a, b = (axis + 1) % 3, (axis + 2) % 3
            base = len(pos)
            for ua, ub in ((-0.5, -0.5), (0.5, -0.5), (0.5, 0.5), (-0.5, 0.5)):
                p = np.zeros(3)
                p[axis], p[a], p[b] = 0.5 * sign, ua, ub
                pos.append(p)
            uv += QUAD_UV.tolist()
            order = ((0, 1, 2), (0, 2, 3)) if sign > 0 else ((0, 2, 1), (0, 3, 2))
            tris += [[base + i for i in o] for o in order]
    return np.asarray(pos), None, np.asarray(uv), np.asarray(tris)


def read_pfm(path) -> np.ndarray:
    """(h, w, 3) float32, row 0 the image's top."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        w, h = (int(a) for a in f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
    ch = 3 if header == b"PF" else 1
    img = data.reshape(h, w, ch)[::-1].astype(np.float32)
    return np.repeat(img, 3, -1) if ch == 1 else img


@dataclass
class RefScene:
    v0: torch.Tensor  # (T, 3)
    v1: torch.Tensor
    v2: torch.Tensor
    n0: torch.Tensor  # (T, 3) shading normals at the corners
    n1: torch.Tensor
    n2: torch.Tensor
    uv: torch.Tensor  # (T, 3, 2)
    ng: torch.Tensor  # (T, 3) geometric normal by the winding
    mat: torch.Tensor  # (T,) int64 material index
    emit: torch.Tensor  # (T, 3) emitted radiance (0 where none)
    # materials, indexed by `mat`: type, albedo (const), checker (on, off,
    # res_u, res_v; res 0 = constant), eta, k, alpha, ior
    m_type: torch.Tensor
    m_albedo: torch.Tensor
    m_checker: torch.Tensor  # (M, 8)
    m_eta: torch.Tensor
    m_k: torch.Tensor
    m_alpha: torch.Tensor
    m_ior: torch.Tensor
    env: torch.Tensor | None  # (h, w, 3) lat-long radiance
    env_rot: torch.Tensor | None  # (3, 3) env -> world
    cam_pos: torch.Tensor
    cam_rot: torch.Tensor  # (3, 3) columns: camera x, y, z in the world
    plane_dist: float
    res: tuple
    max_bounces: int


def _material(spec):
    """-> (type, albedo, checker(8), eta, k, alpha, ior)."""
    t = spec.get("type", "lambert")
    albedo, checker = np.ones(3), np.zeros(8)
    eta, k, alpha, ior = np.ones(3), np.zeros(3), 0.0, 1.5
    a = spec.get("albedo", 1.0)
    if isinstance(a, dict):
        if a.get("type") != "checker":
            raise ValueError(f"reference: texture {a.get('type')!r} is not read")
        checker[0:3] = _vec3(a.get("on_color", 0.8))
        checker[3:6] = _vec3(a.get("off_color", 0.2))
        checker[6], checker[7] = a.get("res_u", 20), a.get("res_v", 20)
    else:
        albedo = _vec3(a)
    if t == "lambert":
        kind = LAMBERT
    elif t == "rough_conductor":
        kind = CONDUCTOR
        eta, k = (np.asarray(x, np.float64) for x in METALS[spec.get("material", "Cu")])
        if spec.get("distribution", "ggx") != "ggx":
            raise ValueError("reference: only the ggx distribution is read")
        alpha = max(float(spec.get("roughness", 0.1)), 1e-3)
    elif t == "dielectric":
        kind = DIELECTRIC
        ior = float(spec.get("ior", 1.5))
    else:
        raise ValueError(f"reference: bsdf {t!r} is not read")
    return kind, albedo, checker, eta, k, alpha, ior


def load(path, device, dtype=torch.float32) -> RefScene:
    with open(path) as f:
        doc = json.load(f)
    root = os.path.dirname(path)
    names = {b["name"]: i for i, b in enumerate(doc.get("bsdfs", []))}
    mats = [_material(b) for b in doc.get("bsdfs", [])]
    parts = []  # (pos, nrm, uv, tris, mat, emission)
    env = env_rot = None
    for prim in doc["primitives"]:
        ptype = prim["type"]
        m = transform(prim.get("transform"))
        if ptype == "infinite_sphere":
            env = read_pfm(os.path.join(root, prim["emission"]))
            r = m[:3, :3]
            env_rot = r / np.linalg.norm(r, axis=0, keepdims=True)
            continue
        if ptype == "mesh":
            pos, nrm, uv, tris = read_obj(os.path.join(root, prim["file"]))
            if not prim.get("smooth", True):
                nrm = None
        elif ptype == "quad":
            pos, nrm, uv, tris = QUAD_CORNERS, None, QUAD_UV, QUAD_TRIS
        elif ptype == "cube":
            pos, nrm, uv, tris = cube_soup()
        else:
            raise ValueError(f"reference: primitive {ptype!r} is not read")
        b = prim.get("bsdf")
        if isinstance(b, dict):
            mats.append(_material(b))
            mi = len(mats) - 1
        else:
            mi = names[b]
        wpos = pos @ m[:3, :3].T + m[:3, 3]
        wn = None
        if nrm is not None:
            wn = nrm @ np.linalg.inv(m[:3, :3])
            wn = wn / np.maximum(np.linalg.norm(wn, axis=-1, keepdims=True), 1e-30)
        parts.append((wpos, wn, uv, tris, mi, _vec3(prim.get("emission", 0.0))))
    v, n, uvs, mat, emit, ng = [[] for _ in range(6)]
    for wpos, wn, uv, tris, mi, e in parts:
        p = wpos[tris]  # (t, 3, 3)
        fn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-30)
        v.append(p)
        n.append(wn[tris] if wn is not None else np.repeat(fn[:, None], 3, 1))
        uvs.append(uv[tris])
        ng.append(fn)
        mat.append(np.full(len(tris), mi))
        emit.append(np.repeat(e[None], len(tris), 0))
    v, n = np.concatenate(v), np.concatenate(n)

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dt)

    cam = doc["camera"]
    cm = transform(cam.get("transform"))
    cm[:3, 0] = -cm[:3, 0]  # a Tungsten camera's right axis points to the image's left
    mt = list(zip(*mats))
    return RefScene(
        v0=t(v[:, 0]), v1=t(v[:, 1]), v2=t(v[:, 2]),
        n0=t(n[:, 0]), n1=t(n[:, 1]), n2=t(n[:, 2]), uv=t(np.concatenate(uvs)),
        ng=t(np.concatenate(ng)), mat=t(np.concatenate(mat), torch.int64),
        emit=t(np.concatenate(emit)),
        m_type=t(np.asarray(mt[0]), torch.int64), m_albedo=t(np.stack(mt[1])),
        m_checker=t(np.stack(mt[2])), m_eta=t(np.stack(mt[3])), m_k=t(np.stack(mt[4])),
        m_alpha=t(np.asarray(mt[5])), m_ior=t(np.asarray(mt[6])),
        env=None if env is None else t(env), env_rot=None if env is None else t(env_rot),
        cam_pos=t(cm[:3, 3]), cam_rot=t(cm[:3, :3] / np.linalg.norm(cm[:3, :3], axis=0)),
        plane_dist=float(1.0 / np.tan(np.deg2rad(cam.get("fov", 60)) * 0.5)),
        res=tuple(cam.get("resolution", (1000, 563))),
        max_bounces=int(doc.get("integrator", {}).get("max_bounces", 64)),
    )
