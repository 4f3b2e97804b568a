"""Curve/strand file loaders: Cem Yuksel .hair and Tungsten .fiber.

Format facts mirror src/core/io/CurveIO.cpp (loadHair :118-205, loadFiber
:279-420). Both deliver (curve_ends (C,) uint32 cumulative vertex counts,
nodes (V, 4) float32 [x y z radius]).

.hair (cyHair): magic "HAIR", u32 curveCount, u32 nodeCount, u32 descriptor
bitfield (1=segments array u16, 2=points f32x3, 4=thickness f32,
8=transparency f32, 16=color f32x3), u32 defaultSegments, f32
defaultThickness, f32 defaultTransparency, 3x f32 defaultColor, 88-byte info.

.fiber: magic 80 BF 80 'F I B E R', u16 major/minor, u32 contentType, u64
headerLength, u64 numVertices, u64 numCurves, then attribute blocks:
u64 descriptorLength, {u64 dataLength, u16 flags (bit0 = per-curve), u8
valueType, u8 valuesPerElement, cstring name}, payload. We read
"num_vertices" (per-curve u16), "position" (f32x3), "width" (f32).

The port's own copy of tungsten_tpu/io/curveio.py: the same numpy code, so it
yields the same arrays; the port imports nothing of the JAX package.
"""
from __future__ import annotations

import struct

import numpy as np


def load_hair(path: str):
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"HAIR":
        raise ValueError(f"not a HAIR file: {path}")
    (curve_count, node_count, descriptor, default_segments) = struct.unpack_from(
        "<IIII", data, 4
    )
    default_thickness, _default_transp = struct.unpack_from("<ff", data, 20)
    off = 4 + 4 * 4 + 2 * 4 + 3 * 4 + 88  # header + defaults + file info

    if descriptor & 0x1:
        segs = np.frombuffer(data, "<u2", curve_count, off).astype(np.uint32)
        off += 2 * curve_count
    else:
        segs = np.full(curve_count, default_segments, np.uint32)
    curve_ends = np.cumsum(segs + 1).astype(np.uint32)

    if not (descriptor & 0x2):
        raise ValueError("HAIR file without points array")
    pos = np.frombuffer(data, "<f4", node_count * 3, off).reshape(-1, 3)
    off += 12 * node_count

    if descriptor & 0x4:
        thick = np.frombuffer(data, "<f4", node_count, off).copy()
        off += 4 * node_count
    else:
        thick = np.full(node_count, default_thickness, np.float32)

    nodes = np.concatenate([pos, 0.5 * thick[:, None]], axis=1).astype(np.float32)
    return curve_ends, nodes


_FIBER_MAGIC = bytes([0x80, 0xBF, 0x80, 0x46, 0x49, 0x42, 0x45, 0x52])
_FIBER_SIZES = [1, 1, 2, 2, 4, 4, 8, 8, 4, 8]
_FIBER_DTYPE = ["i1", "u1", "<i2", "<u2", "<i4", "<u4", "<i8", "<u8", "<f4", "<f8"]


def load_fiber(path: str):
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _FIBER_MAGIC:
        raise ValueError(f"not a FIBER file: {path}")
    major, _minor = struct.unpack_from("<HH", data, 8)
    (content_type,) = struct.unpack_from("<I", data, 12)
    if major != 1 or content_type != 0:
        raise ValueError("unsupported fiber version/content")
    header_len, n_verts, n_curves = struct.unpack_from("<QQQ", data, 16)

    curve_ends = None
    pos = None
    width = None
    off = int(header_len)
    while off + 8 <= len(data):
        (desc_len,) = struct.unpack_from("<Q", data, off)
        if desc_len == 0:
            break
        p = off + 8
        data_len, flags = struct.unpack_from("<QH", data, p)
        vtype, vper = struct.unpack_from("<BB", data, p + 10)
        # names are length-prefixed or zero-terminated depending on the
        # writer; Tungsten streams std::string as zero-terminated
        name_start = p + 12
        name_end = data.index(b"\x00", name_start)
        name = data[name_start:name_end].decode("ascii", "replace")
        payload = off + int(desc_len)
        per_curve = (flags & 1) != 0
        n_elem = int(data_len) // (_FIBER_SIZES[vtype] * max(vper, 1))

        def arr(dt, count, vp):
            a = np.frombuffer(data, dt, count * vp, payload)
            return a.reshape(count, vp) if vp > 1 else a

        if name == "num_vertices" and per_curve and vtype == 3 and vper == 1:
            counts = arr("<u2", min(n_elem, n_curves), 1).astype(np.uint32)
            if len(counts) < n_curves:
                counts = np.concatenate(
                    [counts, np.full(n_curves - len(counts), counts[-1], np.uint32)]
                )
            curve_ends = np.cumsum(counts).astype(np.uint32)
        elif name == "position" and not per_curve and vtype == 8 and vper == 3:
            pos = arr("<f4", min(n_elem, n_verts), 3).astype(np.float32)
        elif name == "width" and not per_curve and vtype == 8 and vper == 1:
            width = arr("<f4", min(n_elem, n_verts), 1).astype(np.float32)
        off = payload + int(data_len)

    if curve_ends is None or pos is None:
        raise ValueError(f"fiber file missing curves/positions: {path}")
    if len(pos) < n_verts:
        pos = np.concatenate([pos, np.repeat(pos[-1:], n_verts - len(pos), 0)])
    if width is None:
        width = np.full(int(n_verts), 1e-2, np.float32)
    elif len(width) < n_verts:
        width = np.concatenate(
            [width, np.full(int(n_verts) - len(width), width[-1], np.float32)]
        )
    nodes = np.concatenate([pos, 0.5 * width[:, None]], axis=1).astype(np.float32)
    return curve_ends, nodes


def load_curves(path: str):
    if path.lower().endswith(".hair"):
        return load_hair(path)
    return load_fiber(path)
