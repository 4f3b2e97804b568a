"""Minecraft NBT (Named Binary Tag) parser.

Binary-compatible with the reference's reader (mc-loader/NBT.hpp:16-205):
big-endian scalars, length-prefixed arrays/strings, homogeneous lists, and
TAG_End-terminated compounds. Values parse into plain Python/numpy objects;
`NbtTag` mirrors the reference's access surface (`tag["Level"]["Sections"]`,
`subtag(i)`, truthiness of missing tags).

The port's own copy of tungsten_tpu/io/nbt.py: the same numpy code, so it
yields the same arrays; the port imports nothing of the JAX package.
"""
from __future__ import annotations

import struct

import numpy as np

TAG_END = 0
TAG_BYTE = 1
TAG_SHORT = 2
TAG_INT = 3
TAG_LONG = 4
TAG_FLOAT = 5
TAG_DOUBLE = 6
TAG_BYTE_ARRAY = 7
TAG_STRING = 8
TAG_LIST = 9
TAG_COMPOUND = 10
TAG_INT_ARRAY = 11
TAG_LONG_ARRAY = 12  # post-1.12 worlds; not in the reference, read anyway

_SCALAR = {
    TAG_BYTE: (">b", 1),
    TAG_SHORT: (">h", 2),
    TAG_INT: (">i", 4),
    TAG_LONG: (">q", 8),
    TAG_FLOAT: (">f", 4),
    TAG_DOUBLE: (">d", 8),
}


class NbtTag:
    """One parsed tag. `value` is a scalar, str, numpy array, list of
    NbtTag, or dict name -> NbtTag (compound)."""

    __slots__ = ("name", "type", "value")

    def __init__(self, name, ttype, value):
        self.name = name
        self.type = ttype
        self.value = value

    def __bool__(self):
        return self.type != TAG_END

    def __len__(self):
        if isinstance(self.value, (list, dict, np.ndarray, str)):
            return len(self.value)
        return 0

    size = property(__len__)

    def __getitem__(self, key):
        if isinstance(key, str):
            if isinstance(self.value, dict) and key in self.value:
                return self.value[key]
            return _INVALID
        if isinstance(self.value, np.ndarray):
            return int(self.value[key])
        if isinstance(self.value, list):
            return self.value[key]
        return _INVALID

    def subtag(self, i):
        return self.value[i] if isinstance(self.value, list) else _INVALID

    def as_int(self):
        return int(self.value) if np.isscalar(self.value) else 0

    asInt = as_int

    def as_array(self):
        return self.value if isinstance(self.value, np.ndarray) else np.zeros(0, np.int8)


_INVALID = NbtTag("", TAG_END, None)


class _Cursor:
    __slots__ = ("buf", "pos")

    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def take(self, n):
        b = bytes(self.buf[self.pos : self.pos + n])
        if len(b) < n:
            raise ValueError("truncated NBT stream")
        self.pos += n
        return b


def _payload(c: _Cursor, ttype: int):
    if ttype in _SCALAR:
        fmt, n = _SCALAR[ttype]
        return struct.unpack(fmt, c.take(n))[0]
    if ttype == TAG_BYTE_ARRAY:
        n = struct.unpack(">i", c.take(4))[0]
        return np.frombuffer(c.take(max(n, 0)), np.int8)
    if ttype == TAG_INT_ARRAY:
        n = struct.unpack(">i", c.take(4))[0]
        return np.frombuffer(c.take(max(n, 0) * 4), ">i4").astype(np.int32)
    if ttype == TAG_LONG_ARRAY:
        n = struct.unpack(">i", c.take(4))[0]
        return np.frombuffer(c.take(max(n, 0) * 8), ">i8").astype(np.int64)
    if ttype == TAG_STRING:
        n = struct.unpack(">H", c.take(2))[0]
        return c.take(n).decode("utf-8", errors="replace")
    if ttype == TAG_LIST:
        etype = c.take(1)[0]
        n = struct.unpack(">i", c.take(4))[0]
        return [NbtTag("", etype, _payload(c, etype)) for _ in range(max(n, 0))]
    if ttype == TAG_COMPOUND:
        out = {}
        while True:
            t = c.take(1)[0]
            if t == TAG_END:
                return out
            nlen = struct.unpack(">H", c.take(2))[0]
            name = c.take(nlen).decode("utf-8", errors="replace")
            out[name] = NbtTag(name, t, _payload(c, t))
    raise ValueError(f"invalid NBT tag type {ttype}")


def parse_nbt(data: bytes) -> NbtTag:
    """Parse one named root tag from `data` (NBT.hpp:176-196)."""
    c = _Cursor(memoryview(data))
    ttype = c.take(1)[0]
    if ttype == TAG_END:
        return _INVALID
    nlen = struct.unpack(">H", c.take(2))[0]
    name = c.take(nlen).decode("utf-8", errors="replace")
    return NbtTag(name, ttype, _payload(c, ttype))


# ---------------------------------------------------------------------------
# writer (tests + tooling)


def write_nbt(tag: NbtTag) -> bytes:
    out = bytearray()
    out.append(tag.type)
    nb = tag.name.encode()
    out += struct.pack(">H", len(nb)) + nb
    _write_payload(out, tag)
    return bytes(out)


def _write_payload(out: bytearray, tag: NbtTag):
    t, v = tag.type, tag.value
    if t in _SCALAR:
        out += struct.pack(_SCALAR[t][0], v)
    elif t == TAG_BYTE_ARRAY:
        a = np.asarray(v, np.int8)
        out += struct.pack(">i", len(a)) + a.tobytes()
    elif t == TAG_INT_ARRAY:
        a = np.asarray(v, ">i4")
        out += struct.pack(">i", len(a)) + a.tobytes()
    elif t == TAG_LONG_ARRAY:
        a = np.asarray(v, ">i8")
        out += struct.pack(">i", len(a)) + a.tobytes()
    elif t == TAG_STRING:
        b = v.encode()
        out += struct.pack(">H", len(b)) + b
    elif t == TAG_LIST:
        et = v[0].type if v else TAG_END
        out.append(et)
        out += struct.pack(">i", len(v))
        for e in v:
            _write_payload(out, e)
    elif t == TAG_COMPOUND:
        for name, sub in v.items():
            out.append(sub.type)
            nb = name.encode()
            out += struct.pack(">H", len(nb)) + nb
            _write_payload(out, sub)
        out.append(TAG_END)
    else:
        raise ValueError(f"cannot write tag type {t}")
