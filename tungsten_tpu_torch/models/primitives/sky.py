"""Hosek-Wilkie skydome baked to an equirect HDR image at flatten time.

The reference's Skydome (src/core/primitives/Skydome.cpp:270-318) evaluates
the Hosek-Wilkie 2012 spectral skylight model in its "alienworld" variant
(ArHosekSkyModel.cpp:402-516) on a 512x256 lat-long grid at prepareForRender
and wraps the result in a BitmapTexture — i.e. the skydome IS an env light
with a baked emission map. This module reproduces that bake exactly:

  - the fitted coefficient tables (datasets / datasetsRad from
    ArHosekSkyModelData_Spectral.h, 3-clause BSD, (c) Hosek & Wilkie) and
    the CIE 1931 color matching tables are vendored in data/hosek.npz
    (tools/extract_hosek.py) — the same category of public dataset as the
    Sobol direction numbers and the Palik complex-IOR constants;
  - CookConfiguration / CookRadianceConfiguration (quintic Bezier over
    cbrt-elevation, bilinear over turbidity x albedo,
    ArHosekSkyModel.cpp:147-289);
  - the alienworld blackbody emission-correction factors
    (ArHosekSkyModel.cpp:402-516): per-band ratio of a `temperature`-K
    blackbody to the fitted solar spectrum, sky factors scaled by
    `intensity` over the mean visible-band ratio;
  - 10-sample spectral integration against the CIE weights
    (Spectral.cpp:370-392 spectralXyzWeights) and the reference's
    xyzToRgb matrix (Spectral.hpp:21-27).

The evaluation is a flatten-time bake — plain numpy, vectorized over the
512x256 grid; the result feeds the standard env-light alias table.

The port's own copy of tungsten_tpu/models/primitives/sky.py: the same numpy code, so it
yields the same arrays; the port imports nothing of the JAX package. Its
tables are the port's own byte copy, data/hosek.npz beside this module.
"""
from __future__ import annotations

import os

import numpy as np

_DATA = None


def _data():
    global _DATA
    if _DATA is None:
        _DATA = np.load(os.path.join(os.path.dirname(__file__), "data", "hosek.npz"))
    return _DATA


# Spectral.hpp:21-27 xyzToRgb (sRGB primaries, reference's exact constants)
_XYZ_TO_RGB = np.array(
    [[3.240479, -1.537150, -0.498535],
     [-0.969256, 1.875991, 0.041556],
     [0.055648, -0.204043, 1.057311]]
)

_CIE_MIN, _CIE_MAX, _CIE_SAMPLES = 360.0, 830.0, 471


def _spectral_xyz_weights(samples=10):
    """Spectral.cpp:370-392: bin the 471-sample CIE tables onto `samples`
    evenly spaced wavelengths 360..830 nm; normalize by the trapezoid
    integral of Y. Returns (lambdas (S,), weights (S, 3))."""
    cie = _data()["cie"]  # (3, 471)
    delta = (_CIE_MAX - _CIE_MIN) / (samples - 1)
    lambdas = _CIE_MIN + np.arange(samples) * delta
    weights = np.zeros((samples, 3))
    i = np.arange(_CIE_SAMPLES)
    x = (i / delta).astype(np.int64)
    u = i / delta - x
    entries = cie.T  # (471, 3)
    np.add.at(weights, x, (1.0 - u)[:, None] * entries)
    # the final CIE sample lands exactly on the last bin (u = 0); the C code
    # writes u*entry past the array end there — skip the zero contribution
    hi_ok = x + 1 < samples
    np.add.at(weights, np.minimum(x + 1, samples - 1),
              (u * hi_ok)[:, None] * entries)
    ref = np.sum((cie[1, :-1] + cie[1, 1:]) * 0.5)
    return lambdas, weights / ref


def _bezier5(ctrl, t):
    """Quintic Bezier over the 6 elevation control points (axis 0 of ctrl),
    the interpolation used by both Cook functions."""
    s = 1.0 - t
    b = np.array([s**5, 5 * s**4 * t, 10 * s**3 * t**2,
                  10 * s**2 * t**3, 5 * s * t**4, t**5])
    return np.tensordot(b, ctrl, axes=(0, 0))


def _cook(table, turbidity, albedo, elevation):
    """ArHosekSkyModel_CookConfiguration / CookRadianceConfiguration for all
    11 bands at once. table: (11, 2 alb, 10 turb, 6 ctrl, ...) -> (11, ...)."""
    t = np.power(max(elevation, 0.0) / (np.pi / 2.0), 1.0 / 3.0)
    it = int(turbidity)
    rem = turbidity - it

    def at(turb_i):
        ctrl_first = np.moveaxis(table[:, :, turb_i], 2, 0)  # (6, 11, 2, ...)
        v = _bezier5(ctrl_first, t)  # (11, 2, ...)
        return v[:, 0] * (1.0 - albedo) + v[:, 1] * albedo

    lo = at(it - 1)
    if it == 10:
        return lo
    return lo * (1.0 - rem) + at(it) * rem


def _blackbody(temp, lam_m):
    """art_blackbody_dd_value (ArHosekSkyModel.cpp:363-376): Planck's law
    with the model's c1/c2 constants (c1 = 3.74177e-16, c2 = 0.0143878)."""
    c1, c2 = 3.74177e-16, 0.0143878
    return (c1 / lam_m**5) / (np.exp(c2 / (lam_m * temp)) - 1.0)


_BLACKBODY_SCALE = 3.19992e-10  # blackbody_scaling_factor (= 3.19992*10E-11)


def _alienworld_state(elevation, intensity, temperature, turbidity, albedo):
    """arhosekskymodelstate_alienworld_alloc_init: cooked per-band configs
    (11, 9), zenith radiances (11,), and sky emission-correction factors."""
    d = _data()
    turbidity = float(np.clip(turbidity, 1.0, 10.0))
    configs = _cook(d["configs"], turbidity, albedo, elevation)  # (11, 9)
    radiances = _cook(d["radiances"], turbidity, albedo, elevation)  # (11,)
    owl = (320.0 + 40.0 * np.arange(11)) * 1e-9
    nsr = _blackbody(temperature, owl) * _BLACKBODY_SCALE
    ecf_sun = nsr / d["solar"]
    ratio = ecf_sun[2:11].mean()  # visible-band average
    ecf_sky = intensity * ecf_sun / ratio
    return configs, radiances * ecf_sky


def _radiance_internal(configs, theta, gamma):
    """ArHosekSkyModel_GetRadianceInternal (ArHosekSkyModel.cpp:291-304) for
    all bands: configs (11, 9), theta/gamma (...) -> (11, ...)."""
    c = configs.reshape((11, 9) + (1,) * theta.ndim)
    cos_g = np.cos(gamma)[None]
    cos_t = np.cos(theta)[None]
    exp_m = np.exp(c[:, 4] * gamma[None])
    ray_m = cos_g * cos_g
    mie_m = (1.0 + cos_g * cos_g) / np.power(
        1.0 + c[:, 8] * c[:, 8] - 2.0 * c[:, 8] * cos_g, 1.5)
    zenith = np.sqrt(np.maximum(cos_t, 0.0))
    return (1.0 + c[:, 0] * np.exp(c[:, 1] / (cos_t + 0.01))) * (
        c[:, 2] + c[:, 3] * exp_m + c[:, 5] * ray_m + c[:, 6] * mie_m
        + c[:, 7] * zenith)


def bake_skydome(
    sun_dir, turbidity=3.0, intensity=2.0, temperature=5777.0, gamma_scale=1.0,
    width=512, height=256,
):
    """Evaluate the sky on the reference's lat-long grid (Skydome.cpp:274-299:
    theta = (y+0.5)*pi/H over the upper half, phi = (x+0.5)*2pi/W, v-flipped
    mapping directionToUV = (atan2(z,x)/2pi + 0.5, acos(-y)/pi)); rows at and
    below the horizon repeat the last sky row. Returns (H, W, 3) float32."""
    sun = np.asarray(sun_dir, np.float64)
    sun = sun / max(np.linalg.norm(sun), 1e-9)
    elevation = np.arcsin(np.clip(sun[1], -1.0, 1.0))

    configs, band_scale = _alienworld_state(
        elevation, float(intensity), float(temperature), float(turbidity),
        albedo=0.2)  # Skydome.cpp:303-304: ground albedo fixed at 0.2

    lambdas, weights = _spectral_xyz_weights(10)
    # arhosekskymodel_radiance band lerp (ArHosekSkyModel.cpp:519-552):
    # per-sample (low band, interp); out-of-table samples contribute 0
    lo_band = ((lambdas - 320.0) / 40.0).astype(np.int64)
    interp = (lambdas - 320.0) / 40.0 - lo_band
    in_lo = (lo_band >= 0) & (lo_band < 11)
    in_hi = (lo_band + 1 >= 0) & (lo_band + 1 < 11)
    w_lo = np.where(in_lo, 1.0 - interp, 0.0)
    w_hi = np.where(in_lo & in_hi, interp, 0.0)
    lo_c = np.clip(lo_band, 0, 10)
    hi_c = np.clip(lo_band + 1, 0, 10)

    ys = np.arange(height // 2)
    xs = np.arange(width)
    theta = (ys + 0.5) * np.pi / height  # zenith angle of the texel row
    phi = (xs + 0.5) * 2.0 * np.pi / width - np.pi
    # direction for uv (u, v): matches Skydome::uvToDirection; texel row r
    # maps (through the BitmapTexture v-flip) to v = 1-(r+0.5)/H, i.e.
    # direction y = +cos(theta_r): row 0 is the zenith
    dirs = np.zeros((height // 2, width, 3))
    st = np.sin(theta)[:, None]
    dirs[..., 0] = np.cos(phi)[None, :] * st
    dirs[..., 1] = np.cos(theta)[:, None]
    dirs[..., 2] = np.sin(phi)[None, :] * st
    cos_gamma = np.clip(dirs @ sun, -1.0, 1.0)
    gamma = np.clip(np.arccos(cos_gamma) * gamma_scale, 0.0, np.pi)
    th = np.broadcast_to(theta[:, None], gamma.shape)

    bands = _radiance_internal(configs, th, gamma) * band_scale.reshape(
        (11,) + (1,) * gamma.ndim)  # (11, H/2, W)
    # spectral sum: sum_i weights[i] * (w_lo[i]*bands[lo] + w_hi[i]*bands[hi])
    per_band_w = np.zeros((11, 3))
    np.add.at(per_band_w, lo_c, (w_lo[:, None] * weights) * in_lo[:, None])
    np.add.at(per_band_w, hi_c, (w_hi[:, None] * weights))
    xyz = np.tensordot(per_band_w, bands, axes=(0, 0))  # (3, H/2, W)
    rgb = np.moveaxis(np.tensordot(_XYZ_TO_RGB, xyz, axes=(1, 0)), 0, -1)

    img = np.zeros((height, width, 3), np.float32)
    img[: height // 2] = rgb.astype(np.float32)
    # horizon extension: 2 rows just below the horizon repeat the last sky
    # row (Skydome.cpp:310-311); the rest of the lower hemisphere is black
    img[height // 2 : height // 2 + 2] = img[height // 2 - 1][None]
    return img
