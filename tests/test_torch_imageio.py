"""The port's image IO against the JAX package's.

The JAX package reads .hdr through OpenCV (`cv2.imread`, BGR -> RGB); the
port has its own Radiance RGBE reader. Both read the same files, written
here by `cv2.imwrite` (new-style RLE scanlines) and by the port's writer
(RLE, and flat where the width is outside RLE's 8 to 32767), and must give
the same float32 bits. The port's writer keeps each value within RGBE's
precision (8 bits of mantissa under a shared exponent). .exr needs cv2 in
the port: where it does not import, loading raises and names it.
"""
import builtins
import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")


def _image(rng, h, w):
    """A float image with what RGBE must carry: a wide dynamic range,
    runs of equal pixels, black and sub-threshold pixels."""
    img = (rng.random((h, w, 3)) ** 4 * 80.0).astype(np.float32)
    img[h // 3] = [1.25, 0.5, 3.0]  # a run across a scanline
    img[h // 2, : w // 2] = 0.0
    img[-1, -1] = 1e-38  # below RGBE's smallest value: reads back as 0
    img[0, 0] = [6.0e4, 1.0, 1e-3]
    return img


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _jax_load(path):
    from tungsten_tpu.io.imageio import load_image

    return load_image(path)


@pytest.mark.parametrize("shape", [(37, 53), (64, 128), (5, 300), (4, 7), (3, 40000)])
def test_hdr_written_by_cv2_reads_bit_for_bit(tmp_path, rng, shape):
    from tungsten_tpu_torch.io.imageio import load_image

    img = _image(rng, *shape)
    path = str(tmp_path / "cv2.hdr")
    assert cv2.imwrite(path, np.ascontiguousarray(img[..., ::-1]))
    got = load_image(path)
    want = _jax_load(path)
    assert got.dtype == np.float32 and got.shape == shape + (3,)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("shape", [(37, 53), (16, 256), (6, 5), (4, 7), (2, 33000)])
def test_hdr_written_by_the_port_reads_bit_for_bit(tmp_path, rng, shape):
    from tungsten_tpu_torch.io.imageio import load_image, save_hdr

    img = _image(rng, *shape)
    path = str(tmp_path / "port.hdr")
    save_hdr(path, img)
    got = load_image(path)
    np.testing.assert_array_equal(_bits(got), _bits(_jax_load(path)))
    # 8 bits of mantissa under the pixel's largest channel's exponent
    peak = img.max(axis=-1, keepdims=True)
    assert (np.abs(got - img) <= peak * 2.0**-7 + 1e-30).all()
    assert got[-1, -1].max() == 0.0


def test_save_image_hdr_runs_are_encoded(tmp_path):
    """save_image writes .hdr with the RGBE writer; an image of runs takes
    a fraction of its flat size (4 bytes a pixel) and reads back exactly."""
    from tungsten_tpu_torch.io.imageio import load_image, save_image

    img = np.ones((32, 64, 3), np.float32) * np.float32(2.5)
    img[:, 40:] = [0.125, 0.25, 0.375]  # both colours exact in RGBE
    save_image(str(tmp_path / "a.hdr"), img)
    assert os.path.getsize(tmp_path / "a.hdr") < 32 * 64 * 4 / 4
    np.testing.assert_array_equal(load_image(str(tmp_path / "a.hdr")), img)


def test_hdr_refuses_other_orientations(tmp_path):
    from tungsten_tpu_torch.io.imageio import load_image

    path = tmp_path / "flip.hdr"
    path.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+Y 2 +X 2\n" + bytes(16))
    with pytest.raises(IOError, match="orientation"):
        load_image(str(path))


def test_exr_without_cv2_raises_naming_it(tmp_path, monkeypatch):
    from tungsten_tpu_torch.io.imageio import load_image, save_image

    path = str(tmp_path / "x.exr")
    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(ImportError, match="cv2"):
        load_image(path)
    with pytest.raises(ImportError, match="cv2"):
        save_image(path, np.zeros((2, 2, 3), np.float32))

