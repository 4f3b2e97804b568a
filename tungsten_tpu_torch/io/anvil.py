"""Minecraft Anvil region (.mca) decoder -> dense block-id grids.

Byte-exact with the reference's MapLoader (mc-loader/MapLoader.hpp:35-172):
  - region header: 1024 x 4-byte big-endian chunk locations (sector offset
    << 8 | sector count), then 1024 timestamps (ignored);
  - chunk payload: 4-byte big-endian length + 1 compression byte (only 2 =
    zlib accepted, like the reference) + zlib stream of an NBT compound;
  - block id packing: blocks[idx] << 4 | Add nibble << 12 | Data nibble,
    idx = x + z*16 + y*256 within each 16^3 section at height Y*16;
  - each 512x512 region splits into four 256^3 quadrants handed to the
    caller keyed by (2*rx + qx, 2*rz + qz).

Grids are numpy uint16 indexed [z, y, x] (linear x + 256*y + 256*256*z, the
reference's layout).

The port's own copy of tungsten_tpu/io/anvil.py: the same numpy code, so it
yields the same arrays; the port imports nothing of the JAX package.
"""
from __future__ import annotations

import os
import re
import struct
import zlib

import numpy as np

from .nbt import parse_nbt

GRID = 256  # quadrant edge (x/z) and full height (y)


def decode_chunk(grid: np.ndarray, height: int, nbt_bytes: bytes,
                 chunk_x: int, chunk_z: int, biomes_out=None) -> int:
    """Decode one chunk NBT into grid[(chunk coords) % 16 quadrant-local]
    (MapLoader.hpp:35-78). Returns the updated max height."""
    root = parse_nbt(nbt_bytes)
    sections = root["Level"]["Sections"]
    lx, lz = (chunk_x % 16) * 16, (chunk_z % 16) * 16
    for i in range(len(sections)):
        sec = sections.subtag(i)
        blocks = sec["Blocks"]
        add = sec["Add"]
        data = sec["Data"]
        chunk_y = sec["Y"].as_int()

        bid = np.zeros(4096, np.uint16)
        if blocks:
            bid |= blocks.as_array().astype(np.uint16).__and__(0xFF) << 4
        for tag, shift in ((add, 12), (data, 0)):
            if tag:
                nib = tag.as_array().astype(np.uint16) & 0xFF
                lo = nib & 0xF
                hi = (nib >> 4) & 0xF
                full = np.empty(4096, np.uint16)
                full[0::2] = lo
                full[1::2] = hi
                bid |= full << shift

        sec_grid = bid.reshape(16, 16, 16)  # [y, z, x] (idx = x + z*16 + y*256)
        y0 = chunk_y * 16
        # grid is [z, y, x]
        grid[lz : lz + 16, y0 : y0 + 16, lx : lx + 16] = sec_grid.transpose(1, 0, 2)
        if bid.any():
            ys = np.nonzero(sec_grid.any(axis=(1, 2)))[0]
            height = max(height, y0 + int(ys[-1]) + 1)

    if biomes_out is not None:
        biomes = root["Level"]["Biomes"]
        if biomes:
            b = biomes.as_array().astype(np.uint8).reshape(16, 16)  # [z, x]
            biomes_out[lz : lz + 16, lx : lx + 16] = b
    return height


def load_region(path: str):
    """Decode one r.X.Z.mca file -> (grid (512z, 256y, 512x) uint16,
    biomes (512, 512) uint8, height). Unsupported-compression chunks are
    skipped with the reference's warning semantics."""
    raw = open(path, "rb").read()
    grid = np.zeros((512, GRID, 512), np.uint16)
    biomes = np.full((512, 512), 0xFF, np.uint8)
    height = 0
    for i in range(1024):
        cx, cz = i % 32, i // 32
        off = (raw[i * 4] << 16 | raw[i * 4 + 1] << 8 | raw[i * 4 + 2]) * 4096
        length = raw[i * 4 + 3] * 4096
        if off == 0 or length == 0:
            continue
        chunk_len = struct.unpack(">I", raw[off : off + 4])[0]
        comp = raw[off + 4]
        if comp != 2:
            continue
        try:
            nbt_bytes = zlib.decompress(raw[off + 5 : off + 5 + chunk_len])
        except zlib.error:
            continue
        # quadrant-local views: chunk (cx, cz) lives in quadrant
        # (cx // 16, cz // 16)
        qx, qz = cx // 16, cz // 16
        sub = grid[qz * 256 : qz * 256 + 256, :, qx * 256 : qx * 256 + 256]
        bsub = biomes[qz * 256 : qz * 256 + 256, qx * 256 : qx * 256 + 256]
        height = decode_chunk(sub, height, nbt_bytes, cx, cz, bsub)
    return grid, biomes, height


def load_world(map_dir: str):
    """Iterate <map_dir>/region/r.X.Z.mca (MapLoader::loadRegions) ->
    dict {(2x+qx, 2z+qz): (grid256 [z,y,x] uint16, biomes256, height)}."""
    region_dir = os.path.join(map_dir, "region")
    out = {}
    if not os.path.isdir(region_dir):
        return out
    pat = re.compile(r"^r\.(-?\d+)\.(-?\d+)\.mca$", re.IGNORECASE)
    for fname in sorted(os.listdir(region_dir)):
        m = pat.match(fname)
        if not m:
            continue
        rx, rz = int(m.group(1)), int(m.group(2))
        grid, biomes, height = load_region(os.path.join(region_dir, fname))
        for qz in range(2):
            for qx in range(2):
                sub = grid[qz * 256 : (qz + 1) * 256, :, qx * 256 : (qx + 1) * 256]
                bsub = biomes[qz * 256 : (qz + 1) * 256, qx * 256 : (qx + 1) * 256]
                if sub.any():
                    out[(rx * 2 + qx, rz * 2 + qz)] = (sub, bsub, height)
    return out


# ---------------------------------------------------------------------------
# writer (tests + tooling): synthesize a minimal world


def write_region(path: str, chunks: dict):
    """chunks: {(cx, cz): nbt_bytes} -> one .mca with zlib chunks."""
    header = bytearray(8192)
    body = bytearray()
    sector = 2
    for (cx, cz), nbt_bytes in chunks.items():
        comp = zlib.compress(nbt_bytes)
        payload = struct.pack(">I", len(comp)) + bytes([2]) + comp
        n_sect = (len(payload) + 4095) // 4096
        i = cx + cz * 32
        header[i * 4 : i * 4 + 4] = bytes(
            [(sector >> 16) & 0xFF, (sector >> 8) & 0xFF, sector & 0xFF, n_sect])
        body += payload + b"\0" * (n_sect * 4096 - len(payload))
        sector += n_sect
    with open(path, "wb") as f:
        f.write(bytes(header) + bytes(body))


def make_chunk_nbt(block_ids: np.ndarray, chunk_y: int = 0,
                   data_nibbles=None) -> bytes:
    """block_ids: (16, 16, 16) [y, z, x] uint8 -> chunk NBT with one section."""
    from .nbt import (NbtTag, write_nbt, TAG_BYTE_ARRAY, TAG_COMPOUND,
                      TAG_INT, TAG_LIST)

    ids = np.asarray(block_ids, np.uint8).reshape(4096)
    sec = {
        "Y": NbtTag("Y", TAG_INT, int(chunk_y)),
        "Blocks": NbtTag("Blocks", TAG_BYTE_ARRAY, ids.astype(np.int8)),
    }
    if data_nibbles is not None:
        d = np.asarray(data_nibbles, np.uint8).reshape(4096)
        packed = (d[0::2] & 0xF) | ((d[1::2] & 0xF) << 4)
        sec["Data"] = NbtTag("Data", TAG_BYTE_ARRAY, packed.astype(np.int8))
    root = NbtTag("", TAG_COMPOUND, {
        "Level": NbtTag("Level", TAG_COMPOUND, {
            "Sections": NbtTag("Sections", TAG_LIST, [
                NbtTag("", TAG_COMPOUND, sec)]),
        }),
    })
    return write_nbt(root)
