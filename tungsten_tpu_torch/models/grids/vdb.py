"""OpenVDB (.vdb) reader: container framing + the Tree_float_5_4_3 /
Tree_vec3s_5_4_3 tree decode, densified over the active bounding box.

The port's own copy of tungsten_tpu/models/grids/vdb.py (numpy, struct and
zlib; libblosc through ctypes where the library loads): the port imports
nothing of the JAX package, this numpy-only module included. The reference
links full OpenVDB (src/core/grids/VdbGrid.cpp:16-27 uses a FloatGrid
density and a Vec3fGrid emission); the decoder is validated against
archives made by an independent writer (tests/test_vdb.py, and its copy in
synth.py) covering the same layout (masks, tile values, active-mask + zlib
value compression, half floats). Framing fields whose exact version
cutoffs could not be verified against a real file (UUID encoding, the
instance-parent field in grid descriptors) are parsed TOLERANTLY: each
variant is tried and the one yielding self-consistent stream offsets wins.
Anything outside the decoded subset fails loudly with repack instructions
(blosc without libblosc, root-level tiles, multi-inactive-value nodes,
non-float value types).

Supported subset
  header  : int64 magic | uint32 file version (>=220) | uint32+uint32 lib
            version | bool hasGridOffsets | [zlib bool, 220-221 ONLY —
            from 222 compression is per-grid] | uuid (length-prefixed
            string OR raw 36 bytes) | metadata map | uint32 grid count |
            descriptors
  descr   : unique name | type string (optional "_HalfFloat" suffix) |
            [bool half | instance-parent string] | int64 gridPos,
            blockPos, endPos
  grid    : [uint32 per-grid compression (>=222)] | metadata map |
            transform (UniformScale / UniformScaleTranslate / Translation /
            Scale / ScaleTranslate / Affine maps) | topology | leaf buffers
  tree    : uint32 buffer-count(1); Root{background, tiles, children} ->
            Internal 32^3 -> Internal 16^3 -> Leaf 8^3. Node masks are raw
            LSB-first little-endian words; internal tile values and leaf
            buffers go through readCompressedValues (per-node int8 metadata,
            active-mask compaction, zlib framing with the negative-length
            raw escape, optional half floats).

Voxel order: OpenVDB offsets are x-major/z-minor (leaf offset =
x<<6 | y<<3 | z); the densified array is returned as (nz, ny, nx) to match
models/grids/grid.py's dense layout.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 0x56444220

COMPRESS_NONE = 0
COMPRESS_ZIP = 0x1
COMPRESS_ACTIVE_MASK = 0x2
COMPRESS_BLOSC = 0x4

# per-node value-compression metadata codes (openvdb/io/Compression.h)
NO_MASK_OR_INACTIVE_VALS = 0  # all inactive vals are +background
NO_MASK_AND_MINUS_BG = 1  # all inactive vals are -background
NO_MASK_AND_ONE_INACTIVE_VAL = 2
MASK_AND_NO_INACTIVE_VALS = 3
MASK_AND_ONE_INACTIVE_VAL = 4
MASK_AND_TWO_INACTIVE_VALS = 5
NO_MASK_AND_ALL_VALS = 6

# 5-4-3 tree geometry
LEAF_DIM = 8  # 8^3 leaf
INT4_DIM = 16  # 16^3 children of leaves -> node covers 128^3
INT5_DIM = 32  # 32^3 children of Internal4 -> node covers 4096^3
LEAF_SIZE = LEAF_DIM**3
INT4_SIZE = INT4_DIM**3
INT5_SIZE = INT5_DIM**3

MAX_DENSE_VOXELS = 192 * 1024 * 1024  # ~768 MB f32 budget for densify


class _R:
    def __init__(self, data: bytes):
        self.b = data
        self.o = 0

    def read(self, n):
        v = self.b[self.o : self.o + n]
        if len(v) < n:
            raise EOFError("truncated .vdb")
        self.o += n
        return v

    def u32(self):
        return struct.unpack("<I", self.read(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.read(8))[0]

    def i32(self):
        return struct.unpack("<i", self.read(4))[0]

    def i64(self):
        return struct.unpack("<q", self.read(8))[0]

    def f32(self):
        return struct.unpack("<f", self.read(4))[0]

    def f64(self):
        return struct.unpack("<d", self.read(8))[0]

    def boolean(self):
        return self.read(1)[0] != 0

    def name(self):
        return self.read(self.u32()).decode("utf-8", "replace")


def _read_metadata(r: _R):
    meta = {}
    count = r.u32()
    for _ in range(count):
        key = r.name()
        typ = r.name()
        size = r.u32()
        raw = r.read(size)
        if typ == "string":
            meta[key] = raw[4:].decode("utf-8", "replace") if size >= 4 else ""
        elif typ == "int64":
            meta[key] = struct.unpack("<q", raw)[0]
        elif typ == "int32":
            meta[key] = struct.unpack("<i", raw)[0]
        elif typ == "float":
            meta[key] = struct.unpack("<f", raw)[0]
        elif typ == "double":
            meta[key] = struct.unpack("<d", raw)[0]
        elif typ == "bool":
            meta[key] = raw[0] != 0
        elif typ == "vec3i":
            meta[key] = struct.unpack("<3i", raw)
        elif typ == "vec3d":
            meta[key] = struct.unpack("<3d", raw)
        else:
            meta[key] = raw
    return meta


# ---------------------------------------------------------------------------
# container framing


def _parse_header(r: _R, path):
    """Parse the archive header; returns (file_version, compression_flags).
    UUID encoding varies by library version — try the length-prefixed form
    first and fall back to a raw 36-char ASCII uuid (both appear in the
    wild), resyncing on whichever leaves the stream at a well-formed
    metadata map."""
    if r.u64() != MAGIC:
        raise ValueError(f"{path}: not a .vdb file")
    file_version = r.u32()
    r.u32()
    r.u32()  # library major/minor
    has_offsets = r.boolean()
    if file_version >= 222:
        # From 222 on the archive header carries NO compression field —
        # compression moves to a per-grid uint32 (read in _read_grid).
        # This default only covers grids written without the per-grid
        # field (not observed in practice).
        compression = COMPRESS_ZIP | COMPRESS_ACTIVE_MASK
    elif file_version >= 220:
        # 220-221: a single header bool selects zlib on/off
        compression = COMPRESS_ZIP if r.boolean() else COMPRESS_NONE
    else:
        compression = COMPRESS_ZIP
    # UUID variants
    save = r.o
    for variant in ("prefixed", "raw36", "raw16", "none"):
        r.o = save
        try:
            if variant == "prefixed":
                n = r.u32()
                if n not in (16, 32, 36):
                    raise ValueError
                r.read(n)
            elif variant == "raw36":
                raw = r.read(36)
                if not all(c in b"0123456789abcdefABCDEF-" for c in raw):
                    raise ValueError
            elif variant == "raw16":
                r.read(16)
            _probe_metadata(r)
            return file_version, compression, has_offsets
        except (ValueError, EOFError, UnicodeDecodeError):
            continue
    raise NotImplementedError(
        f"{path}: unrecognized .vdb header framing (version {file_version}) "
        "— repack to .npy with OpenVDB offline and use a {'type': 'dense'} "
        "grid spec"
    )


def _probe_metadata(r: _R):
    """Validate a metadata map at the cursor without consuming it (raises
    if the bytes there are not a plausible metadata map)."""
    save = r.o
    try:
        count = r.u32()
        if count > 4096:
            raise ValueError("implausible metadata count")
        r.o = save
        _read_metadata(r)
    finally:
        r.o = save


def _read_descriptor(r: _R, file_version, total):
    """One grid descriptor; tolerant to the optional instance-parent
    string vs bool-half layouts."""
    gname = r.name()
    gtype = r.name()
    half = False
    if gtype.endswith("_HalfFloat"):
        half = True
        gtype = gtype[: -len("_HalfFloat")]
    save = r.o

    def offsets_ok(a, b, c):
        return save < a <= b <= c <= total

    # variant A: instance-parent string, then 3 offsets
    try:
        r.o = save
        n = r.u32()
        if n > 4096:
            raise ValueError
        r.read(n)
        g, blk, end = r.i64(), r.i64(), r.i64()
        if offsets_ok(g, blk, end):
            return gname.split("\x1e")[0], gtype, half, g, blk, end
    except (ValueError, EOFError):
        pass
    # variant B: bool half flag, then 3 offsets
    try:
        r.o = save
        half_b = r.boolean()
        g, blk, end = r.i64(), r.i64(), r.i64()
        if offsets_ok(g, blk, end):
            return gname.split("\x1e")[0], gtype, half or half_b, g, blk, end
    except (ValueError, EOFError):
        pass
    # variant C: offsets immediately
    r.o = save
    g, blk, end = r.i64(), r.i64(), r.i64()
    if offsets_ok(g, blk, end):
        return gname.split("\x1e")[0], gtype, half, g, blk, end
    raise NotImplementedError(
        "unrecognized .vdb grid-descriptor framing — repack to .npy"
    )


# ---------------------------------------------------------------------------
# value IO


def _value_dtype(gtype, half):
    if "vec3s" in gtype or "vec3f" in gtype:
        return (np.float16 if half else np.float32), 3
    if "float" in gtype:
        return (np.float16 if half else np.float32), 1
    raise NotImplementedError(
        f".vdb grid type {gtype!r}: only float / vec3s value types are "
        "decoded — repack to .npy"
    )


def _blosc():
    """System libblosc via ctypes (OpenVDB's default value compressor;
    VdbGrid.cpp reads it through the full OpenVDB lib — we bind the same
    C library directly). Returns None when the library is unavailable."""
    global _BLOSC_LIB
    if _BLOSC_LIB is not _UNSET:
        return _BLOSC_LIB
    import ctypes

    try:
        lib = ctypes.CDLL("libblosc.so.1")
        lib.blosc_decompress_ctx.restype = ctypes.c_int
        lib.blosc_decompress_ctx.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
        ]
        lib.blosc_compress_ctx.restype = ctypes.c_int
        _BLOSC_LIB = lib
    except OSError:
        _BLOSC_LIB = None
    return _BLOSC_LIB


_UNSET = object()
_BLOSC_LIB = _UNSET


def _blosc_decompress(raw: bytes, nbytes: int, path: str) -> bytes:
    import ctypes

    lib = _blosc()
    if lib is None:
        raise NotImplementedError(
            f"{path}: blosc-compressed .vdb values and libblosc is not "
            "available — repack to .npy"
        )
    dest = ctypes.create_string_buffer(nbytes)
    n = lib.blosc_decompress_ctx(raw, dest, nbytes, 1)
    if n < 0:
        raise ValueError(f"{path}: blosc_decompress failed (code {n})")
    return dest.raw[:n]


def _read_data(r: _R, count, ncomp, compression, half, path):
    """readData: `count` values of `ncomp` components, honoring blosc/zlib
    framing (int64 byte count; <=0 means stored raw) and half floats."""
    dt = np.float16 if half else np.float32
    nbytes = count * ncomp * dt().itemsize
    if compression & COMPRESS_BLOSC:
        zn = r.i64()
        raw = r.read(-zn if zn <= 0 else zn)
        if zn > 0:
            raw = _blosc_decompress(raw, nbytes, path)
        vals = np.frombuffer(raw, dt, count * ncomp).astype(np.float32)
        return vals.reshape(count, ncomp)
    if compression & COMPRESS_ZIP:
        zn = r.i64()
        raw = r.read(-zn if zn <= 0 else zn)
        if zn > 0:
            raw = zlib.decompress(raw)
    else:
        raw = r.read(nbytes)
    vals = np.frombuffer(raw, dt, count * ncomp).astype(np.float32)
    return vals.reshape(count, ncomp)


def _read_compressed_values(r: _R, dest_count, ncomp, value_mask,
                            background, file_version, compression, half,
                            path):
    """io::readCompressedValues (openvdb/io/Compression.h): per-node int8
    metadata, up to two stored inactive values, a selection NodeMask for
    the two-inactive-value codes, active-mask compaction for EVERY code
    except NO_MASK_AND_ALL_VALS, then readData. Returns a dense
    (dest_count, ncomp) f32 array."""
    code = NO_MASK_AND_ALL_VALS
    if file_version >= 222:
        code = struct.unpack("<b", r.read(1))[0]
    bg = np.asarray(background, np.float32)
    # inactive-value reconstruction defaults (mirrors the reference reader)
    inactive1 = bg
    inactive0 = bg if code == NO_MASK_OR_INACTIVE_VALS else -bg
    if code in (NO_MASK_AND_ONE_INACTIVE_VAL, MASK_AND_ONE_INACTIVE_VAL,
                MASK_AND_TWO_INACTIVE_VALS):
        inactive0 = _read_data(r, 1, ncomp, COMPRESS_NONE, half, path)[0]
        if code == MASK_AND_TWO_INACTIVE_VALS:
            inactive1 = _read_data(r, 1, ncomp, COMPRESS_NONE, half, path)[0]
    selection = None
    if code in (MASK_AND_NO_INACTIVE_VALS, MASK_AND_ONE_INACTIVE_VAL,
                MASK_AND_TWO_INACTIVE_VALS):
        # bitmask selecting between the two distinct inactive values
        selection = _load_mask(r, dest_count)
    mask_compressed = bool(compression & COMPRESS_ACTIVE_MASK)
    compacted = (
        mask_compressed
        and code != NO_MASK_AND_ALL_VALS
        and file_version >= 222
    )
    n_stored = int(value_mask.sum()) if compacted else dest_count
    vals = _read_data(r, n_stored, ncomp, compression, half, path)
    if not compacted or n_stored == dest_count:
        return vals
    out = np.empty((dest_count, ncomp), np.float32)
    out[:] = inactive0
    if selection is not None:
        out[selection] = inactive1
    out[value_mask] = vals
    return out


def _load_mask(r: _R, size_bits):
    """NodeMask serialization: raw little-endian 64-bit words, bit i of the
    mask = bit (i & 63) of word (i >> 6), LSB first."""
    raw = np.frombuffer(r.read(size_bits // 8), np.uint8)
    return np.unpackbits(raw, bitorder="little").astype(bool)


def _offsets_to_xyz(dim):
    """OpenVDB node offsets are x-major/z-minor: off = (x*dim + y)*dim + z."""
    off = np.arange(dim**3)
    z = off % dim
    y = (off // dim) % dim
    x = off // (dim * dim)
    return x, y, z


# ---------------------------------------------------------------------------
# tree decode


def _read_internal_topology(r: _R, dim, child_reader, leaves, tiles, origin,
                            child_span, ctx):
    """InternalNode::readTopology: child mask, value mask, tile values via
    readCompressedValues, then children depth-first in bit order."""
    size = dim**3
    child_mask = _load_mask(r, size)
    value_mask = _load_mask(r, size)
    vals = _read_compressed_values(
        r, size, ctx["ncomp"], value_mask, ctx["background"],
        ctx["file_version"], ctx["compression"], ctx["half"], ctx["path"],
    )
    x, y, z = _offsets_to_xyz(dim)
    # active tiles (value on, no child): constant child_span^3 regions
    tile_idx = np.where(value_mask & ~child_mask)[0]
    for i in tile_idx:
        o = (
            origin[0] + int(x[i]) * child_span,
            origin[1] + int(y[i]) * child_span,
            origin[2] + int(z[i]) * child_span,
        )
        tiles.append((o, child_span, vals[i]))
    for i in np.where(child_mask)[0]:
        o = (
            origin[0] + int(x[i]) * child_span,
            origin[1] + int(y[i]) * child_span,
            origin[2] + int(z[i]) * child_span,
        )
        child_reader(r, o, leaves, tiles, ctx)


def _read_int5(r, origin, leaves, tiles, ctx):
    _read_internal_topology(
        r, INT5_DIM, _read_int4, leaves, tiles, origin,
        INT4_DIM * LEAF_DIM, ctx,
    )


def _read_int4(r, origin, leaves, tiles, ctx):
    _read_internal_topology(
        r, INT4_DIM, _read_leaf_topology, leaves, tiles, origin, LEAF_DIM,
        ctx,
    )


def _read_leaf_topology(r, origin, leaves, tiles, ctx):
    mask = _load_mask(r, LEAF_SIZE)
    leaves.append({"origin": origin, "mask": mask})


def _read_leaf_buffers(r, leaves, ctx):
    """Tree::readBuffers: leaves in the same DFS order as topology; each
    leaf re-stores its value mask then its 512-value buffer."""
    for lf in leaves:
        mask = _load_mask(r, LEAF_SIZE)
        lf["values"] = _read_compressed_values(
            r, LEAF_SIZE, ctx["ncomp"], mask, ctx["background"],
            ctx["file_version"], ctx["compression"], ctx["half"],
            ctx["path"],
        )


_MAP_DOUBLES = {
    "UniformScaleMap": 15,  # scale, voxel, inv, invSq, invTwice (Vec3d each)
    "ScaleMap": 15,
    "TranslationMap": 3,
    "UniformScaleTranslateMap": 18,  # translation + the 5 scale vectors
    "ScaleTranslateMap": 18,
    "AffineMap": 16,  # Mat4d
}


def _read_transform(r: _R, path):
    """Transform::read: registered map name + that map's double payload.
    Returns (voxel_size (3,), translation (3,))."""
    mname = r.name()
    if mname not in _MAP_DOUBLES:
        raise NotImplementedError(
            f"{path}: .vdb transform map {mname!r} not decoded — repack to "
            ".npy (supported: {sorted(_MAP_DOUBLES)})"
        )
    n = _MAP_DOUBLES[mname]
    d = struct.unpack(f"<{n}d", r.read(8 * n))
    if mname in ("UniformScaleMap", "ScaleMap"):
        return np.array(d[0:3]), np.zeros(3)
    if mname == "TranslationMap":
        return np.ones(3), np.array(d[0:3])
    if mname in ("UniformScaleTranslateMap", "ScaleTranslateMap"):
        # ScaleTranslateMap layout: translation first, then the scale block
        return np.array(d[3:6]), np.array(d[0:3])
    m = np.array(d).reshape(4, 4)
    return np.array([m[0, 0], m[1, 1], m[2, 2]]), np.array(m[3, 0:3])


def _read_grid(data, gridpos, gtype, half, file_version, compression, path):
    r = _R(data)
    r.o = gridpos
    if file_version >= 222:
        compression = r.u32()  # per-grid compression override
    gmeta = _read_metadata(r)
    half = half or bool(gmeta.get("is_saved_as_half_float", False))
    dt, ncomp = _value_dtype(gtype, half)
    voxel_size, translate = _read_transform(r, path)

    # --- topology ---
    buffer_count = r.u32()
    if buffer_count != 1:
        raise NotImplementedError(f"{path}: multi-buffer .vdb tree")
    background = _read_data(r, 1, ncomp, COMPRESS_NONE, half, path)[0]
    ctx = dict(
        ncomp=ncomp, background=background, file_version=file_version,
        compression=compression, half=half, path=path,
    )
    n_tiles = r.u32()
    n_children = r.u32()
    if n_tiles:
        # a root tile covers 4096^3 voxels — never densifiable
        raise NotImplementedError(
            f"{path}: active root-level tiles (4096^3 regions) cannot be "
            "densified — repack to .npy"
        )
    leaves, tiles = [], []
    for _ in range(n_children):
        o = (r.i32(), r.i32(), r.i32())
        _read_int5(r, o, leaves, tiles, ctx)
    _read_leaf_buffers(r, leaves, ctx)

    arr, index_min = _densify(leaves, tiles, background, ncomp, path)
    return arr, voxel_size, translate, index_min


def _densify(leaves, tiles, background, ncomp, path):
    """Dense (nz, ny, nx, ncomp) array over the VOXEL-exact active bbox
    (evalActiveVoxelBoundingBox semantics: min over active voxels/tiles,
    not leaf-aligned), plus the bbox minimum in file index space — the
    reference places the grid by file index (VdbGrid.cpp:231-249), so
    dense index q corresponds to file index q + index_min."""
    if not leaves and not tiles:
        return np.zeros((1, 1, 1, ncomp), np.float32), np.zeros(3, np.int64)
    lx, ly, lz = _offsets_to_xyz(LEAF_DIM)
    alos, ahis = [], []
    for lf in leaves:
        m = lf["mask"]
        if not m.any():
            continue
        o = np.asarray(lf["origin"])
        xs, ys, zs = lx[m], ly[m], lz[m]
        alos.append(o + (xs.min(), ys.min(), zs.min()))
        ahis.append(o + (xs.max() + 1, ys.max() + 1, zs.max() + 1))
    for o, span, _ in tiles:
        alos.append(np.asarray(o))
        ahis.append(np.asarray(o) + span)
    lo = np.min(np.array(alos), axis=0)
    hi = np.max(np.array(ahis), axis=0)
    nx, ny, nz = (hi - lo).tolist()
    if nx * ny * nz > MAX_DENSE_VOXELS:
        raise NotImplementedError(
            f"{path}: active bbox {nx}x{ny}x{nz} exceeds the dense budget — "
            "repack to .npy"
        )
    out = np.empty((nz, ny, nx, ncomp), np.float32)
    out[:] = np.asarray(background, np.float32)
    for o, span, val in tiles:
        x0, y0, z0 = (np.array(o) - lo).tolist()
        out[max(z0, 0) : z0 + span, max(y0, 0) : y0 + span,
            max(x0, 0) : x0 + span] = val
    for lf in leaves:
        o = np.asarray(lf["origin"])
        blk = lf["values"].reshape(
            LEAF_DIM, LEAF_DIM, LEAF_DIM, ncomp
        ).transpose(2, 1, 0, 3)  # -> (z, y, x, c)
        # clip the leaf block to the cropped bbox
        b0 = np.maximum(lo - o, 0)  # (x, y, z) start inside the block
        b1 = np.minimum(hi - o, LEAF_DIM)
        if np.any(b0 >= b1):
            continue
        d0 = np.maximum(o - lo, 0)
        out[
            d0[2] : d0[2] + (b1[2] - b0[2]),
            d0[1] : d0[1] + (b1[1] - b0[1]),
            d0[0] : d0[0] + (b1[0] - b0[0]),
        ] = blk[b0[2] : b1[2], b0[1] : b1[1], b0[0] : b1[0]]
    return out, lo


# ---------------------------------------------------------------------------
# public API


def read_vdb_grid(path: str, grid_name: str = "density"):
    """Read one grid as a dense array over its active bounding box.
    Returns (data, info): data is (nz, ny, nx) f32 for scalar grids or
    (nz, ny, nx, 3) for vec3 grids; info = {'voxel_size', 'translate',
    'grids'} from the file transform (for VdbGrid.cpp:241-243's
    normalize_size=false spacing semantics)."""
    with open(path, "rb") as f:
        data = f.read()
    r = _R(data)
    file_version, compression, has_offsets = _parse_header(r, path)
    _read_metadata(r)
    if not has_offsets:
        raise NotImplementedError(f"{path}: streamed .vdb without grid offsets")
    grid_count = r.u32()
    names = []
    total = len(data)
    for _ in range(grid_count):
        gname, gtype, half, gpos, blk, end = _read_descriptor(
            r, file_version, total
        )
        names.append(gname)
        if gname == grid_name:
            arr, voxel_size, translate, index_min = _read_grid(
                data, gpos, gtype, half, file_version, compression, path
            )
            if arr.shape[-1] == 1:
                arr = arr[..., 0]
            return arr, {
                "voxel_size": voxel_size,
                "translate": translate,
                "index_min": index_min,
                "grids": names,
            }
        # archive layout interleaves [descriptor][grid data]: the next
        # descriptor starts at this grid's endPos
        r.o = end
    raise KeyError(f"{path}: grid '{grid_name}' not found (has {names})")
