"""Image IO: PFM and Radiance .hdr natively, .exr through OpenCV, LDR
through PIL.

Numpy port of tungsten_tpu/io/imageio.py. The JAX package reads .hdr and
.exr with OpenCV; here .hdr has its own RGBE reader and writer, which need no
package, and .exr loads only where `cv2` imports (it raises, naming the
package, where it does not). The reader decodes flat and new-style
run-length-encoded scanlines of a "-Y h +X w" image as OpenCV's rgbe.cpp
does: a pixel is (r, g, b) * 2^(e - 136) in float32, 0 where e = 0, with no
+0.5 on the mantissa (Radiance's own colr_color adds it), so it equals
`cv2.imread` bit for bit. Loaded images are float32 RGB in scanline order
(row 0 = top).
"""
from __future__ import annotations

import os

import numpy as np

_RGBE_FORMAT = b"FORMAT=32-bit_rle_rgbe"
_MIN_RUN = 4  # runs shorter than this are cheaper as literals


def load_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().strip()
        channels = 3 if header == b"PF" else 1
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
        img = data.reshape(h, w, channels)[::-1]  # PFM is bottom-up
    return np.ascontiguousarray(img, np.float32)


def save_pfm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if img.ndim == 3 else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")
        f.write(np.ascontiguousarray(img[::-1]).astype("<f4").tobytes())


def _rgbe_header(data: bytes, path: str):
    """(height, width, offset of the pixels): header lines up to the blank
    line (one of them the 32-bit_rle_rgbe FORMAT), then "-Y h +X w"."""
    pos, has_format = 0, False
    while True:
        end = data.find(b"\n", pos)
        if end < 0:
            raise IOError(f"{path}: truncated Radiance header")
        line = data[pos:end]
        pos = end + 1
        if not line:
            break
        has_format |= line == _RGBE_FORMAT
    if not has_format:
        raise IOError(f"{path}: no {_RGBE_FORMAT.decode()} line in the header")
    end = data.find(b"\n", pos)
    size = data[pos:end].split()
    if len(size) != 4 or size[0] != b"-Y" or size[2] != b"+X":
        raise IOError(f"{path}: image orientation {data[pos:end]!r} is not '-Y h +X w'")
    return int(size[1]), int(size[3]), end + 1


def _rle_scanline(data, pos, w, path):
    """One new-style RLE scanline: four channel planes of (count, bytes)
    packets. Returns ((w, 4) uint8, position after it)."""
    out = np.empty((4, w), np.uint8)
    for c in range(4):
        x = 0
        while x < w:
            n = data[pos]
            pos += 1
            if n > 128:  # a run of n - 128 copies of one byte
                n -= 128
                if n > w - x:
                    raise IOError(f"{path}: bad run in an RLE scanline")
                out[c, x:x + n] = data[pos]
                pos += 1
            else:  # n literal bytes
                if n == 0 or n > w - x:
                    raise IOError(f"{path}: bad literal count in an RLE scanline")
                out[c, x:x + n] = np.frombuffer(data, np.uint8, n, pos)
                pos += n
            x += n
    return out.T, pos


def load_hdr(path: str) -> np.ndarray:
    """Radiance RGBE (.hdr) -> float32 RGB (H, W, 3), as cv2.imread reads it."""
    with open(path, "rb") as f:
        data = f.read()
    h, w, pos = _rgbe_header(data, path)
    rgbe = np.empty((h * w, 4), np.uint8)
    row = 0
    if 8 <= w <= 0x7FFF:  # OpenCV's RGBE_ReadPixels_RLE: RLE lines until a flat one
        while row < h:
            head = data[pos:pos + 4]
            if len(head) < 4:
                raise IOError(f"{path}: truncated pixels")
            if head[0] != 2 or head[1] != 2 or head[2] & 0x80:
                break  # not run-length encoded: the rest of the image is flat
            if (head[2] << 8 | head[3]) != w:
                raise IOError(f"{path}: wrong scanline width in an RLE scanline")
            rgbe[row * w:(row + 1) * w], pos = _rle_scanline(data, pos + 4, w, path)
            row += 1
    rest = (h - row) * w
    if rest:
        if len(data) - pos < 4 * rest:
            raise IOError(f"{path}: truncated pixels")
        rgbe[row * w:] = np.frombuffer(data, np.uint8, 4 * rest, pos).reshape(rest, 4)
    e = rgbe[:, 3].astype(np.int32)
    scale = np.ldexp(np.float32(1.0), e - 136).astype(np.float32)
    rgb = rgbe[:, :3].astype(np.float32) * scale[:, None]
    rgb[e == 0] = 0.0
    return rgb.reshape(h, w, 3)


def _float_to_rgbe(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) float -> (H, W, 4) uint8, OpenCV's float2rgbe (negative
    values clamped to 0)."""
    rgb = np.clip(np.asarray(img, np.float32), 0.0, None)
    v = rgb.max(axis=-1)
    live = v >= 1e-32
    mant, e = np.frexp(v)
    scale = (mant.astype(np.float64) * 256.0 / np.where(live, v, 1.0)).astype(np.float32)
    out = np.zeros(rgb.shape[:2] + (4,), np.uint8)
    out[..., :3] = np.where(live[..., None], rgb * scale[..., None], 0.0).astype(np.uint8)
    out[..., 3] = np.where(live, e + 128, 0).astype(np.uint8)
    return out


def _rle_plane(b: np.ndarray) -> bytes:
    """One channel plane of a scanline as new-style RLE packets: runs of
    _MIN_RUN or more equal bytes as (128 + n, byte), the rest as literals
    of at most 128 bytes."""
    w = b.shape[0]
    starts = np.flatnonzero(np.concatenate([[True], b[1:] != b[:-1]]))
    lens = np.diff(np.append(starts, w))
    out = bytearray()
    lit = 0  # start of the pending literal bytes
    for s, n in zip(starts.tolist(), lens.tolist()):
        if n < _MIN_RUN:
            continue
        for a in range(lit, s, 128):
            m = min(128, s - a)
            out.append(m)
            out += b[a:a + m].tobytes()
        for a in range(s, s + n, 127):
            out += bytes((128 + min(127, s + n - a), int(b[s])))
        lit = s + n
    for a in range(lit, w, 128):
        m = min(128, w - a)
        out.append(m)
        out += b[a:a + m].tobytes()
    return bytes(out)


def save_hdr(path: str, img: np.ndarray) -> None:
    """float RGB (H, W, 3) -> Radiance RGBE, new-style RLE scanlines where
    the width allows them (8 to 32767 pixels), else flat."""
    rgbe = _float_to_rgbe(img)
    h, w = rgbe.shape[:2]
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\n" + _RGBE_FORMAT + b"\n\n" + f"-Y {h} +X {w}\n".encode())
        if not 8 <= w <= 0x7FFF:
            f.write(rgbe.tobytes())
            return
        head = bytes((2, 2, w >> 8, w & 0xFF))
        for y in range(h):
            f.write(head + b"".join(_rle_plane(rgbe[y, :, c]) for c in range(4)))


def _cv2(ext):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{ext} images need OpenCV (the 'cv2' package), which does not "
                          f"import here: {e}") from e
    return cv2


def load_image(path: str, gamma_correct: bool = True) -> np.ndarray:
    """Load a PFM, .hdr, .exr (with cv2) or, with PIL, an LDR image as
    float32 RGB (H, W, 3), linear radiometry."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pfm":
        img = load_pfm(path)
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        return img
    if ext == ".hdr":
        return load_hdr(path)
    if ext == ".exr":
        os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
        cv2 = _cv2(ext)
        img = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR)
        if img is None:
            raise IOError(f"failed to load image: {path}")
        img = np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 else img[..., ::-1]
        return np.ascontiguousarray(img, np.float32)
    from PIL import Image

    with Image.open(path) as im:
        img = np.asarray(im.convert("RGB"), np.float32) / 255.0
    if gamma_correct:
        # BitmapTexture linearizes LDR input with gamma 2.2
        img = img**2.2
    return img


def save_image(path: str, img: np.ndarray) -> None:
    """Save float32 RGB. LDR formats expect tonemapped [0, 1] values and use
    the reference's quantization (floor to int, Integrator.cpp:writeBuffers)."""
    ext = os.path.splitext(path)[1].lower()
    img = np.asarray(img, np.float32)
    if ext == ".pfm":
        save_pfm(path, img)
    elif ext == ".hdr":
        save_hdr(path, img)
    elif ext == ".exr":
        os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
        if not _cv2(ext).imwrite(path, np.ascontiguousarray(img[..., ::-1])):
            raise IOError(f"failed to save image: {path}")
    else:
        from PIL import Image

        u8 = np.clip((img * 255.0).astype(np.int32), 0, 255).astype(np.uint8)
        Image.fromarray(u8, "RGB").save(path)
