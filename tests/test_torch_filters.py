"""The tabulated reconstruction filters of the port against the JAX package
(tests/test_filters.py's cases, on both packages).

  * `tables` equal the JAX package's bit for bit (the same numpy build);
  * `sample_offset_1d` / `sample_offset` and `eval_approx` match on the same
    inputs at rtol 1e-6 (f32 arithmetic in both);
  * the signed splat kernel integrates to 1, the samples reproduce the
    positive per-bin mass, the negative lobes are there;
  * `filter_offset` dispatches every name as the JAX package does, an
    unknown name as tent, and stays within each filter's support.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tungsten_tpu.models.cameras import rfilter as jrf
from tungsten_tpu.models.cameras.pinhole import filter_offset as jfilter_offset
from tungsten_tpu_torch.models.cameras import rfilter
from tungsten_tpu_torch.models.cameras.pinhole import filter_offset

NAMES = ["mitchell_netravali", "catmull_rom", "lanczos", "gaussian"]


@pytest.mark.parametrize("name", NAMES)
def test_tables_equal_jax(name):
    for mine, theirs in zip(rfilter.tables(name), jrf.tables(name)):
        np.testing.assert_array_equal(mine, theirs)
    assert rfilter.RES == jrf.RES and rfilter.WIDTH == jrf.WIDTH
    assert rfilter.is_tabulated(name) and not rfilter.is_tabulated("tent")


@pytest.mark.parametrize("name", NAMES)
def test_sample_and_eval_match_jax(name, rng):
    u = rng.uniform(size=(4096, 2)).astype(np.float32)
    u[:8, 0] = [0.0, 0.25, 0.5, 0.5 - 1e-7, 0.75, 1.0 - 1e-7, 0.125, 0.875]
    got = rfilter.sample_offset(name, torch.as_tensor(u)).numpy()
    want = np.asarray(jrf.sample_offset(name, jnp.asarray(u)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    x = np.concatenate([np.linspace(-2.5, 2.5, 2001), rng.uniform(-2.2, 2.2, 2048)]).astype(
        np.float32)
    np.testing.assert_allclose(rfilter.eval_approx(name, torch.as_tensor(x)).numpy(),
                               np.asarray(jrf.eval_approx(name, jnp.asarray(x))), rtol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_signed_kernel_integrates_to_one(name):
    xs = torch.linspace(-2.0, 2.0, 8001)
    assert abs(float(torch.trapezoid(rfilter.eval_approx(name, xs), xs)) - 1.0) < 5e-3


@pytest.mark.parametrize("name", NAMES)
def test_sample_matches_positive_density(name):
    """Inverse-CDF samples reproduce the per-bin positive mass (the
    running-max cdf increments; the negative-lobe bins get none)."""
    _, cdf, bin_size = rfilter.tables(name)
    u = (np.arange(200_000) + 0.5) / 200_000
    x = rfilter.sample_offset_1d(name, torch.as_tensor(u, dtype=torch.float32)).numpy()
    assert np.all(np.abs(x) <= 2.0 + bin_size + 1e-5)
    assert abs(np.mean(x)) < 5e-3
    hist, _ = np.histogram(np.abs(x), bins=np.arange(rfilter.RES + 1) * bin_size)
    want = np.diff(np.minimum(np.maximum.accumulate(cdf)[: rfilter.RES], 1.0))
    got = hist[1: rfilter.RES] / len(x)
    big = want > 0.01
    np.testing.assert_allclose(got[big], want[big], rtol=0.08)


def test_negative_lobes():
    x = torch.linspace(1.05, 1.95, 64)
    for name in ("mitchell_netravali", "catmull_rom", "lanczos"):
        assert float(rfilter.eval_approx(name, x).min()) < 0.0


@pytest.mark.parametrize("name", ["dirac", "box", "tent", "gaussian", "mitchell_netravali",
                                  "catmull_rom", "lanczos", "no_such_filter"])
def test_filter_offset_dispatch(name, rng):
    """Every name gives the JAX package's displacement; an unknown one is
    tent's (the JAX package's fallback), within each filter's support."""
    u2 = rng.uniform(size=(512, 2)).astype(np.float32)
    off = filter_offset(name, torch.as_tensor(u2)).numpy()
    assert off.shape == (512, 2)
    np.testing.assert_allclose(off, np.asarray(jfilter_offset(name, jnp.asarray(u2))),
                               rtol=1e-6, atol=1e-6)
    lim = {"dirac": 1e-6, "box": 0.51, "tent": 1.01, "no_such_filter": 1.01}.get(name, 2.01)
    assert np.abs(off).max() <= lim
    if name == "no_such_filter":
        np.testing.assert_array_equal(off, filter_offset("tent", torch.as_tensor(u2)).numpy())
