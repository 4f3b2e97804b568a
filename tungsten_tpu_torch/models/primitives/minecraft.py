"""minecraft_map primitive — staged TPU port of the reference mc-loader
(primitives/mc-loader/TraceableMinecraftMap.cpp, MapLoader.hpp, NBT.hpp).

Round-4 scope (SURVEY §7 staging): the exact world decode (NBT + Anvil
regions, byte-compatible with MapLoader) and geometry into the wavefront —
exposed block faces become quads in the shared triangle soup/BVH, so every
integrator, light and medium feature works on minecraft scenes unchanged.
Materials use a built-in block palette (constant-albedo lambert + emissive
blocks); resource-pack texture resolution (ResourcePackLoader.cpp) and the
MultiQuadLight many-light sampler (MultiQuadLight.cpp) are the round-5
stage and are documented as absent.

Block ids are the reference's packed form: legacy id << 4 | data nibble
(MapLoader.hpp:55-58).

The port's own copy of tungsten_tpu/models/primitives/minecraft.py: the same numpy code, so it
yields the same arrays; the port imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np

# legacy block id -> (albedo rgb, emission rgb) for the common vanilla
# blocks; anything absent renders with the missing-block gray the way the
# reference uses a magenta "missing" bsdf (TraceableMinecraftMap.cpp:73-78).
_A = {
    1: (0.50, 0.50, 0.50),    # stone
    2: (0.35, 0.55, 0.25),    # grass
    3: (0.45, 0.32, 0.22),    # dirt
    4: (0.45, 0.45, 0.45),    # cobblestone
    5: (0.65, 0.52, 0.32),    # planks
    7: (0.20, 0.20, 0.20),    # bedrock
    8: (0.25, 0.35, 0.80),    # water (flowing)
    9: (0.25, 0.35, 0.80),    # water
    12: (0.86, 0.82, 0.64),   # sand
    13: (0.55, 0.52, 0.50),   # gravel
    14: (0.58, 0.52, 0.35),   # gold ore
    15: (0.56, 0.50, 0.46),   # iron ore
    16: (0.42, 0.42, 0.42),   # coal ore
    17: (0.42, 0.33, 0.20),   # log
    18: (0.20, 0.45, 0.15),   # leaves
    20: (0.85, 0.90, 0.95),   # glass
    24: (0.84, 0.80, 0.62),   # sandstone
    35: (0.90, 0.90, 0.90),   # wool
    41: (0.98, 0.85, 0.35),   # gold block
    42: (0.88, 0.88, 0.90),   # iron block
    43: (0.60, 0.60, 0.60),   # double slab
    44: (0.60, 0.60, 0.60),   # slab
    45: (0.60, 0.35, 0.30),   # bricks
    48: (0.38, 0.48, 0.38),   # mossy cobble
    49: (0.12, 0.10, 0.18),   # obsidian
    56: (0.55, 0.65, 0.70),   # diamond ore
    57: (0.55, 0.85, 0.85),   # diamond block
    58: (0.55, 0.45, 0.28),   # crafting table
    60: (0.40, 0.28, 0.18),   # farmland
    61: (0.40, 0.40, 0.40),   # furnace
    79: (0.70, 0.80, 0.95),   # ice
    80: (0.95, 0.97, 1.00),   # snow block
    82: (0.70, 0.72, 0.78),   # clay
    98: (0.48, 0.48, 0.48),   # stone bricks
    112: (0.30, 0.12, 0.14),  # nether brick
    121: (0.90, 0.88, 0.70),  # end stone
    155: (0.93, 0.91, 0.88),  # quartz block
    159: (0.78, 0.60, 0.50),  # stained clay
    172: (0.60, 0.38, 0.28),  # hardened clay
}
_E = {
    10: ((0.9, 0.35, 0.1), (6.0, 2.0, 0.4)),    # lava (flowing)
    11: ((0.9, 0.35, 0.1), (6.0, 2.0, 0.4)),    # lava
    50: ((0.8, 0.6, 0.3), (8.0, 5.5, 2.5)),     # torch
    51: ((0.9, 0.5, 0.2), (10.0, 5.0, 1.5)),    # fire
    62: ((0.5, 0.4, 0.3), (4.0, 2.5, 1.0)),     # lit furnace
    89: ((0.95, 0.75, 0.4), (9.0, 7.0, 3.5)),   # glowstone
    91: ((0.9, 0.6, 0.2), (6.0, 4.0, 1.5)),     # jack o'lantern
    124: ((0.9, 0.8, 0.5), (8.0, 7.0, 4.0)),    # lit redstone lamp
    138: ((0.7, 0.9, 0.9), (6.0, 8.0, 8.0)),    # beacon
    169: ((0.8, 0.95, 0.9), (7.0, 9.0, 8.5)),   # sea lantern
    198: ((0.9, 0.85, 0.7), (7.0, 6.5, 5.0)),   # end rod
}
_MISSING = (0.8, 0.2, 0.8)  # the reference's missing-block magenta

# face order: (axis, sign) -> (dz, dy, dx), matching +x/-x/+y/-y/+z/-z
_FACES = [
    (2, 1), (2, -1),  # +x, -x  (x is the minor grid axis)
    (1, 1), (1, -1),  # +y, -y
    (0, 1), (0, -1),  # +z, -z
]


def exposed_faces(grid: np.ndarray):
    """Face culling over a [z, y, x] block grid: returns per-face arrays
    (block_id (F,), axis (F,), sign (F,), cell zyx (F, 3)). A face is
    exposed when its neighbor is air (id 0) or outside the grid. Water in
    water and leaves in leaves stay culled (same-id interior faces)."""
    solid = grid != 0
    ids_l, axes_l, signs_l, cells_l = [], [], [], []
    for axis, sign in _FACES:
        shifted = np.zeros_like(solid)
        sl_src = [slice(None)] * 3
        sl_dst = [slice(None)] * 3
        if sign > 0:
            sl_dst[axis] = slice(0, -1)
            sl_src[axis] = slice(1, None)
        else:
            sl_dst[axis] = slice(1, None)
            sl_src[axis] = slice(0, -1)
        shifted[tuple(sl_dst)] = solid[tuple(sl_src)]
        exposed = solid & ~shifted
        zz, yy, xx = np.nonzero(exposed)
        ids_l.append(grid[zz, yy, xx])
        axes_l.append(np.full(len(zz), axis, np.int8))
        signs_l.append(np.full(len(zz), sign, np.int8))
        cells_l.append(np.stack([zz, yy, xx], -1).astype(np.int32))
    return (np.concatenate(ids_l), np.concatenate(axes_l),
            np.concatenate(signs_l), np.concatenate(cells_l))


def faces_to_quads(ids, axes, signs, cells, origin):
    """Exposed faces -> quad corner soup (world units = 1 block).
    Returns (pos (4F, 3) float32, indices (2F, 3) int32, face_ids (2F,))."""
    f = len(ids)
    # world-space cell corner: x = origin.x + cx, y = cy, z = origin.z + cz
    base = np.stack([
        origin[0] + cells[:, 2].astype(np.float64),
        cells[:, 1].astype(np.float64),
        origin[1] + cells[:, 0].astype(np.float64),
    ], -1)
    # world axis of the face: grid axis 2 -> x, 1 -> y, 0 -> z
    axis_w = np.choose(axes, [2, 1, 0])
    u_w = np.choose(axes, [0, 2, 1])  # first in-plane world axis
    v_w = np.choose(axes, [1, 0, 2])  # second
    eye = np.eye(3)
    n = eye[axis_w] * signs[:, None]
    pos0 = base + np.where(signs[:, None] > 0, eye[axis_w], 0.0)
    eu = eye[u_w]
    ev = eye[v_w]
    corners = np.stack([pos0, pos0 + eu, pos0 + eu + ev, pos0 + ev], 1)
    pos = corners.reshape(-1, 3).astype(np.float32)
    i0 = np.arange(f, dtype=np.int32) * 4
    # wind both triangles so the geometric normal = n (outward)
    flip = np.einsum("fi,fi->f", np.cross(eu, ev), n) < 0
    a, b, c, d = i0, i0 + 1, i0 + 2, i0 + 3
    t1 = np.where(flip[None, :], np.stack([a, d, b]), np.stack([a, b, d])).T
    t2 = np.where(flip[None, :], np.stack([b, d, c]), np.stack([b, c, d])).T
    indices = np.concatenate([t1, t2]).astype(np.int32)
    face_ids = np.concatenate([ids, ids]).astype(np.uint16)
    # per-corner uv (corner order pos0, +eu, +eu+ev, +ev); v flipped so the
    # texture's top row lands at the face's +v edge (BitmapTexture flips v)
    uv = np.tile(np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
                 (f, 1))
    return pos, indices, face_ids, uv


def load_minecraft_map(map_dir: str, with_faces=False):
    """World decode -> (pos, indices, face legacy ids). Raises if no region
    data is found (matching the reference's DBG + empty map).

    with_faces=True additionally returns per-TRIANGLE packed ids
    (id << 4 | data), face axes/signs, and per-vertex uv — the inputs the
    stage-2 resource-pack material builder needs."""
    from ...io.anvil import load_world

    regions = load_world(map_dir)
    if not regions:
        raise ValueError(f"no region data under '{map_dir}'")
    pos_l, idx_l, fid_l, pk_l, ax_l, sg_l, uv_l = [], [], [], [], [], [], []
    vbase = 0
    for (gx, gz), (grid, _biomes, _h) in sorted(regions.items()):
        ids, axes, signs, cells = exposed_faces(grid)
        if len(ids) == 0:
            continue
        pos, indices, fids, uv = faces_to_quads(
            ids, axes, signs, cells, origin=(gx * 256, gz * 256))
        pos_l.append(pos)
        idx_l.append(indices + vbase)
        fid_l.append(fids >> 4)  # legacy id (drop the data nibble)
        pk_l.append(fids)
        ax_l.append(np.concatenate([axes, axes]))
        sg_l.append(np.concatenate([signs, signs]))
        uv_l.append(uv)
        vbase += len(pos)
    out = (np.concatenate(pos_l), np.concatenate(idx_l),
           np.concatenate(fid_l))
    if with_faces:
        return out + (np.concatenate(pk_l), np.concatenate(ax_l),
                      np.concatenate(sg_l), np.concatenate(uv_l))
    return out


def block_materials(legacy_ids: np.ndarray):
    """Unique blocks -> bsdf/emission spec list + per-face material index.
    Returns (specs, mat_of_face (2F,), emission_of_spec)."""
    uniq = np.unique(legacy_ids)
    specs, emis = [], []
    remap = np.zeros(int(uniq.max()) + 1, np.int32)
    for j, bid in enumerate(uniq):
        b = int(bid)
        if b in _E:
            albedo, emission = _E[b]
        else:
            albedo, emission = _A.get(b, _MISSING), None
        specs.append({"name": f"__mc_block_{b}", "type": "lambert",
                      "albedo": list(albedo)})
        emis.append(list(emission) if emission else None)
        remap[b] = j
    return specs, remap[legacy_ids], emis
