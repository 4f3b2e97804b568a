"""Image IO: PFM natively, LDR through PIL when it is installed.

Numpy copy of the subset of tungsten_tpu/io/imageio.py the slice needs.
Radiance .hdr/.exr loading (OpenCV in the JAX package) is not ported.
Loaded images are float32 RGB in scanline order (row 0 = top).
"""
from __future__ import annotations

import os

import numpy as np


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


def load_image(path: str, gamma_correct: bool = True) -> np.ndarray:
    """Load a PFM (or, with PIL, an LDR image) as float32 RGB (H, W, 3)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pfm":
        img = load_pfm(path)
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        return img
    if ext in (".hdr", ".exr"):
        raise NotImplementedError(f"{ext} image loading is not ported (use .pfm)")
    from PIL import Image

    with Image.open(path) as im:
        img = np.asarray(im.convert("RGB"), np.float32) / 255.0
    if gamma_correct:
        # BitmapTexture linearizes LDR input with gamma 2.2
        img = img**2.2
    return img
