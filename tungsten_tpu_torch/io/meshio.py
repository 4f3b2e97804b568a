"""Triangle-mesh IO: Tungsten's .wo3 binary format and Wavefront OBJ.

Copy of tungsten_tpu/io/meshio.py: the port imports nothing from the JAX package.

.wo3 layout (MeshIO::loadWo3, src/core/io/MeshIO.cpp:12-28):
    u64 numVerts
    numVerts * Vertex{ pos: 3xf32, normal: 3xf32, uv: 2xf32 }   (32 bytes)
    u64 numTris
    numTris  * TriangleI{ v0, v1, v2: u32, material: i32 }      (16 bytes)

Returns SoA numpy arrays (the natural layout for flattening to device tables).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

_VERT_DTYPE = np.dtype(
    [("pos", np.float32, 3), ("normal", np.float32, 3), ("uv", np.float32, 2)]
)
_TRI_DTYPE = np.dtype([("vs", np.uint32, 3), ("material", np.int32)])


@dataclass
class MeshData:
    pos: np.ndarray  # (V, 3) f32
    normal: np.ndarray  # (V, 3) f32
    uv: np.ndarray  # (V, 2) f32
    indices: np.ndarray  # (T, 3) i32
    material: np.ndarray  # (T,) i32 (per-triangle sub-material, -1 = none)


def load_wo3(path: str) -> MeshData:
    with open(path, "rb") as f:
        nv = int(np.frombuffer(f.read(8), np.uint64)[0])
        verts = np.frombuffer(f.read(nv * _VERT_DTYPE.itemsize), _VERT_DTYPE, nv)
        nt = int(np.frombuffer(f.read(8), np.uint64)[0])
        tris = np.frombuffer(f.read(nt * _TRI_DTYPE.itemsize), _TRI_DTYPE, nt)
    return MeshData(
        pos=np.array(verts["pos"], np.float32),
        normal=np.array(verts["normal"], np.float32),
        uv=np.array(verts["uv"], np.float32),
        indices=np.array(tris["vs"], np.int64).astype(np.int32),
        material=np.array(tris["material"], np.int32),
    )


def save_wo3(path: str, mesh: MeshData) -> None:
    verts = np.zeros(len(mesh.pos), _VERT_DTYPE)
    verts["pos"] = mesh.pos
    verts["normal"] = mesh.normal
    verts["uv"] = mesh.uv
    tris = np.zeros(len(mesh.indices), _TRI_DTYPE)
    tris["vs"] = mesh.indices
    tris["material"] = mesh.material
    with open(path, "wb") as f:
        f.write(np.uint64(len(verts)).tobytes())
        f.write(verts.tobytes())
        f.write(np.uint64(len(tris)).tobytes())
        f.write(tris.tobytes())


def load_obj(path: str) -> MeshData:
    """Geometry-only OBJ load (positions/normals/uvs/faces, fan-triangulated),
    the equivalent of ObjLoader::loadGeometryOnly."""
    vp, vn, vt = [], [], []
    # OBJ indexes pos/uv/normal independently; we weld unique triplets.
    corner_cache = {}
    out_pos, out_nrm, out_uv = [], [], []
    faces = []

    def corner(spec: str) -> int:
        if spec in corner_cache:
            return corner_cache[spec]
        parts = spec.split("/")
        pi = int(parts[0])
        ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        pi = pi - 1 if pi > 0 else len(vp) + pi
        ti = ti - 1 if ti > 0 else (len(vt) + ti if ti else -1)
        ni = ni - 1 if ni > 0 else (len(vn) + ni if ni else -1)
        out_pos.append(vp[pi])
        out_uv.append(vt[ti] if 0 <= ti < len(vt) else (0.0, 0.0))
        out_nrm.append(vn[ni] if 0 <= ni < len(vn) else (0.0, 0.0, 0.0))
        idx = len(out_pos) - 1
        corner_cache[spec] = idx
        return idx

    with open(path, "r", errors="replace") as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                vp.append(tuple(float(x) for x in t[1:4]))
            elif t[0] == "vn":
                vn.append(tuple(float(x) for x in t[1:4]))
            elif t[0] == "vt":
                vt.append(tuple(float(x) for x in t[1:3]))
            elif t[0] == "f":
                idx = [corner(s) for s in t[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[k], idx[k + 1]))

    mesh = MeshData(
        pos=np.asarray(out_pos, np.float32).reshape(-1, 3),
        normal=np.asarray(out_nrm, np.float32).reshape(-1, 3),
        uv=np.asarray(out_uv, np.float32).reshape(-1, 2),
        indices=np.asarray(faces, np.int32).reshape(-1, 3),
        material=np.full(len(faces), -1, np.int32),
    )
    if not vn:
        compute_smooth_normals(mesh)
    return mesh


def load_mesh(path: str) -> MeshData:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wo3":
        return load_wo3(path)
    if ext == ".obj":
        return load_obj(path)
    raise ValueError(f"unsupported mesh format: {path}")


def compute_smooth_normals(mesh: MeshData) -> None:
    """Area-weighted vertex normals (TriangleMesh::computeSmoothNormals)."""
    p = mesh.pos.astype(np.float64)
    i = mesh.indices
    fn = np.cross(p[i[:, 1]] - p[i[:, 0]], p[i[:, 2]] - p[i[:, 0]])
    n = np.zeros_like(p)
    for k in range(3):
        np.add.at(n, i[:, k], fn)
    lens = np.linalg.norm(n, axis=1, keepdims=True)
    mesh.normal = np.where(lens > 0, n / np.maximum(lens, 1e-30), 0.0).astype(np.float32)
