"""Host-side 4x4 transform utilities (numpy, scene-build time).

Copy of tungsten_tpu/math/transform.py: the port imports nothing from the JAX package.

Mirrors the JSON transform semantics of the reference renderer
(src/core/io/JsonPtr.cpp:108-186 and src/core/math/Mat4f.cpp): a transform is
either a 16-element row-major matrix or an object with optional
position / scale / rotation / look_at / up / x_axis / y_axis / z_axis fields.
The basis construction (Gram-Schmidt priority order, handedness fix), the
YXZ Euler rotation convention, and scale-before-rotation composition are
reproduced exactly so that Tungsten scene files load with identical geometry.

Matrices are numpy float32, row-major, acting on column vectors:
world = M @ [p, 1].
"""
from __future__ import annotations

import numpy as np

Mat4 = np.ndarray  # (4, 4) float32


def _as_vec3(v, default=None) -> np.ndarray:
    """JSON number-or-array -> vec3 (scalars broadcast, like Tungsten's Vec3f)."""
    if v is None:
        return None if default is None else np.array(default, np.float64)
    a = np.asarray(v, np.float64)
    if a.ndim == 0:
        a = np.repeat(a, 3)
    if a.shape != (3,):
        raise ValueError(f"expected scalar or 3-vector, got shape {a.shape}")
    return a


def translate(v) -> Mat4:
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = _as_vec3(v)
    return m


def scale(s) -> Mat4:
    m = np.eye(4, dtype=np.float64)
    m[[0, 1, 2], [0, 1, 2]] = _as_vec3(s)
    return m


def rot_yxz(rot_deg) -> Mat4:
    """Tungsten's Euler convention (Mat4f::rotYXZ, src/core/math/Mat4f.cpp:119)."""
    r = _as_vec3(rot_deg) * np.pi / 180.0
    c = np.cos(r)
    s = np.sin(r)
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = [
        [c[1] * c[2] - s[1] * s[0] * s[2], -c[1] * s[2] - s[1] * s[0] * c[2], -s[1] * c[0]],
        [c[0] * s[2], c[0] * c[2], -s[0]],
        [s[1] * c[2] + c[1] * s[0] * s[2], -s[1] * s[2] + c[1] * s[0] * c[2], c[1] * c[0]],
    ]
    return m


def rot_xyz(rot_deg) -> Mat4:
    """Mat4f::rotXYZ (src/core/math/Mat4f.cpp:103)."""
    r = _as_vec3(rot_deg) * np.pi / 180.0
    c = np.cos(r)
    s = np.sin(r)
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = [
        [c[1] * c[2], -c[0] * s[2] + s[0] * s[1] * c[2], s[0] * s[2] + c[0] * s[1] * c[2]],
        [c[1] * s[2], c[0] * c[2] + s[0] * s[1] * s[2], -s[0] * c[2] + c[0] * s[1] * s[2]],
        [-s[1], s[0] * c[1], c[0] * c[1]],
    ]
    return m


def _random_ortho(a: np.ndarray) -> np.ndarray:
    res = np.array([0.0, 1.0, 0.0]) if abs(a[0]) > abs(a[1]) else np.array([1.0, 0.0, 0.0])
    c = np.cross(a, res)
    return c / np.linalg.norm(c)


def _gram_schmidt(a, b, c):
    """In priority order a > b > c (JsonPtr.cpp:90-106)."""
    a = a / np.linalg.norm(a)
    b = b - a * a.dot(b)
    if b.dot(b) < 1e-5:
        b = _random_ortho(a)
    else:
        b = b / np.linalg.norm(b)
    c = c - a * a.dot(c)
    c = c - b * b.dot(c)
    if c.dot(c) < 1e-5:
        c = np.cross(a, b)
    else:
        c = c / np.linalg.norm(c)
    return a, b, c


def mat4_from_json(obj) -> Mat4:
    """Parse a Tungsten JSON transform (JsonPtr::get(Mat4f), JsonPtr.cpp:108-186)."""
    if obj is None:
        return np.eye(4, dtype=np.float32)
    if isinstance(obj, (list, tuple)):
        a = np.asarray(obj, np.float64)
        if a.size != 16:
            raise ValueError("matrix transform must have 16 elements")
        return a.reshape(4, 4).astype(np.float32)
    if not isinstance(obj, dict):
        raise ValueError(f"bad transform: {obj!r}")

    x = np.array([1.0, 0.0, 0.0])
    y = np.array([0.0, 1.0, 0.0])
    z = np.array([0.0, 0.0, 1.0])
    pos = _as_vec3(obj.get("position"), default=[0.0, 0.0, 0.0])

    explicit_x = explicit_y = explicit_z = False
    if "look_at" in obj:
        z = _as_vec3(obj["look_at"]) - pos
        explicit_z = True
    if "up" in obj:
        y = _as_vec3(obj["up"])
        explicit_y = True
    if "x_axis" in obj:
        x = _as_vec3(obj["x_axis"])
        explicit_x = True
    if "y_axis" in obj:
        y = _as_vec3(obj["y_axis"])
        explicit_y = True
    if "z_axis" in obj:
        z = _as_vec3(obj["z_axis"])
        explicit_z = True

    case = (4 if explicit_z else 0) + (2 if explicit_y else 0) + (1 if explicit_x else 0)
    if case == 0:
        z, y, x = _gram_schmidt(z, y, x)
    elif case == 1:
        x, z, y = _gram_schmidt(x, z, y)
    elif case == 2:
        y, z, x = _gram_schmidt(y, z, x)
    elif case == 3:
        y, x, z = _gram_schmidt(y, x, z)
    elif case == 5:
        z, x, y = _gram_schmidt(z, x, y)
    else:  # 4, 6, 7
        z, y, x = _gram_schmidt(z, y, x)

    if np.dot(np.cross(x, y), z) < 0.0:
        if not explicit_x:
            x = -x
        elif not explicit_y:
            y = -y
        else:
            z = -z

    if "scale" in obj:
        s = _as_vec3(obj["scale"])
        x = x * s[0]
        y = y * s[1]
        z = z * s[2]

    if "rotation" in obj:
        r = rot_yxz(obj["rotation"])[:3, :3]
        x = r @ x
        y = r @ y
        z = r @ z

    m = np.eye(4, dtype=np.float64)
    m[:3, 0] = x
    m[:3, 1] = y
    m[:3, 2] = z
    m[:3, 3] = pos
    return m.astype(np.float32)


def transform_point(m: Mat4, p: np.ndarray) -> np.ndarray:
    """Apply to points (..., 3); includes translation."""
    p = np.asarray(p, np.float64)
    return (p @ m[:3, :3].astype(np.float64).T) + m[:3, 3].astype(np.float64)


def transform_vector(m: Mat4, v: np.ndarray) -> np.ndarray:
    """Apply to directions (..., 3); no translation."""
    v = np.asarray(v, np.float64)
    return v @ m[:3, :3].astype(np.float64).T


def transform_normal(m: Mat4, n: np.ndarray) -> np.ndarray:
    """Apply inverse-transpose (normal matrix); not normalized."""
    inv = np.linalg.inv(m[:3, :3].astype(np.float64))
    return np.asarray(n, np.float64) @ inv


def right(m: Mat4) -> np.ndarray:
    return np.asarray(m[:3, 0])


def up(m: Mat4) -> np.ndarray:
    return np.asarray(m[:3, 1])


def fwd(m: Mat4) -> np.ndarray:
    return np.asarray(m[:3, 2])
