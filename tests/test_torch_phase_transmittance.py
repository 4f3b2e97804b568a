"""The port's phase functions and transmittance models against the JAX
package's, per call, and the medium table's transmittance layout.

Inputs are made from a seed with numpy and go through both packages. XLA on
the CPU contracts multiply-adds into fused ones and evaluates pow / log /
exp with its own approximations, so the bars are per call, not bits:
  * phase eval / pdf: rtol 1e-5; a sampled direction: atol 2e-5 (the cube
    root of the Rayleigh sampler and the frame products round differently);
  * the transmittance cases: rtol 1e-5, atol 1e-6 (relative to values in
    [0, ~10]);
  * the free-flight tau samples: rtol 1e-4, atol 1e-5 (erlang's 10 Newton
    steps and davis_weinstein's 42 bisection halvings carry one rounding
    of the cdf each step).
Every type runs on both start_on_surface values, and both with `present`
None and with the scene's own set (which only skips absent formulas).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tungsten_tpu.models import phase as jphase
from tungsten_tpu.models.transmittance import transmittance as jtr
from tungsten_tpu_torch.models.phase import phase as tphase
from tungsten_tpu_torch.models.transmittance import transmittance as ttr

N = 512


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.mark.parametrize("ptype", [0, 1, 2])
def test_phase_functions_match_jax(ptype):
    """eval, pdf and sample of one phase type, g spread over (-0.9, 0.9)
    with a quarter of the lanes below the |g| < 1e-4 isotropic switch."""
    rng = np.random.default_rng(10 + ptype)
    wi, wo = _unit(rng, N), _unit(rng, N)
    g = rng.uniform(-0.9, 0.9, N).astype(np.float32)
    g[: N // 4] = rng.uniform(-5e-5, 5e-5, N // 4)
    u2 = rng.uniform(size=(N, 2)).astype(np.float32)
    pt = np.full(N, ptype, np.int32)
    want = np.asarray(jphase.phase_eval(jnp.asarray(pt), jnp.asarray(g), jnp.asarray(wi),
                                        jnp.asarray(wo)))
    got = tphase.phase_eval(_t(pt, torch.int64), _t(g), _t(wi), _t(wo)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    got_pdf = tphase.phase_pdf(_t(pt, torch.int64), _t(g), _t(wi), _t(wo)).numpy()
    np.testing.assert_array_equal(got_pdf, got)
    jw, jp = jphase.phase_sample(jnp.asarray(pt), jnp.asarray(g), jnp.asarray(wi),
                                 jnp.asarray(u2))
    tw, tp = tphase.phase_sample(_t(pt, torch.int64), _t(g), _t(wi), _t(u2))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=2e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=2e-4)
    np.testing.assert_allclose(np.linalg.norm(tw.numpy(), axis=1), 1.0, atol=1e-5)
    assert tphase.phase_id(["isotropic", "henyey_greenstein", "rayleigh"][ptype]) == ptype


# each model's parameter rows: [a, b, c] (interpolated: its 8-slot layout)
def _params(ttype, rng):
    p = np.ones((N, 8), np.float32)
    if ttype == ttr.T_DOUBLE_EXPONENTIAL:
        p[:, 0], p[:, 1] = rng.uniform(0.2, 1.0, N), rng.uniform(1.5, 3.0, N)
    elif ttype in (ttr.T_QUADRATIC, ttr.T_LINEAR):
        p[:, 0] = rng.uniform(0.5, 3.0, N)
    elif ttype == ttr.T_ERLANG:
        p[:, 0] = rng.uniform(0.5, 2.0, N)
    elif ttype == ttr.T_DAVIS:
        p[:, 0] = rng.uniform(0.5, 4.0, N)
    elif ttype == ttr.T_PULSE:
        p[:, 0], p[:, 1], p[:, 2] = 0.2, rng.uniform(1.0, 2.0, N), rng.integers(1, 8, N)
    elif ttype == ttr.T_DAVIS_WEINSTEIN:
        p[:, 0], p[:, 1], p[:, 2] = rng.uniform(0.5, 1.0, N), rng.uniform(0.5, 2.0, N), 4.0
    elif ttype == ttr.T_INTERPOLATED:
        p[:, 0] = rng.uniform(0.1, 0.9, N)
        p[:, 1] = rng.choice([0, 1, 2, 3, 4, 5], N)
        p[:, 2] = rng.choice([0, 1, 2, 3, 4, 5], N)
        p[:, 3], p[:, 5] = rng.uniform(0.5, 2.0, N), rng.uniform(0.5, 2.0, N)
        p[:, 4], p[:, 6] = rng.uniform(1.5, 3.0, N), rng.uniform(1.5, 3.0, N)
    return p


@pytest.mark.parametrize("ttype", list(range(9)))
def test_transmittance_models_match_jax(ttype):
    """trans_eval (all four endpoint cases), trans_surface_prob,
    trans_medium_pdf, _sigma_bar_full and trans_sample of one model, on both
    start_on_surface values, with and without `present`."""
    rng = np.random.default_rng(20 + ttype)
    tt = np.full(N, ttype, np.int32)
    params = _params(ttype, rng)
    tau = rng.uniform(0.0, 3.0, (N, 3)).astype(np.float32)
    tau[:8] = 0.0
    s_on = rng.uniform(size=N) < 0.5
    e_on = rng.uniform(size=N) < 0.5
    u, ub = (rng.uniform(size=N).astype(np.float32) for _ in range(2))
    J = dict(ttype=jnp.asarray(tt), params=jnp.asarray(params))
    T = dict(ttype=_t(tt, torch.int64), params=_t(params))
    for present in (None, (ttype,)):
        jp = None if present is None else present
        got = ttr.trans_eval(T["ttype"], T["params"], _t(tau), _t(s_on, torch.bool),
                             _t(e_on, torch.bool), present=present).numpy()
        want = np.asarray(jtr.trans_eval(J["ttype"], J["params"], jnp.asarray(tau),
                                         jnp.asarray(s_on), jnp.asarray(e_on), present=jp))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg="eval")
        for fn in ("trans_surface_prob", "trans_medium_pdf"):
            got = getattr(ttr, fn)(T["ttype"], T["params"], _t(tau), _t(s_on, torch.bool),
                                   present=present).numpy()
            want = np.asarray(getattr(jtr, fn)(J["ttype"], J["params"], jnp.asarray(tau),
                                               jnp.asarray(s_on), present=jp))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=fn)
        got = ttr._sigma_bar_full(T["ttype"], T["params"], present).numpy()
        want = np.asarray(jtr._sigma_bar_full(J["ttype"], J["params"], jp))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        for start in (True, False):
            flag = np.full(N, start)
            got = ttr.trans_sample(T["ttype"], T["params"], _t(u), _t(ub),
                                   _t(flag, torch.bool), present=present).numpy()
            want = np.asarray(jtr.trans_sample(J["ttype"], J["params"], jnp.asarray(u),
                                               jnp.asarray(ub), jnp.asarray(flag),
                                               present=jp))
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                       err_msg=f"sample start_on_surface={start}")


def test_mixed_types_and_present_restriction():
    """A lane table of every model at once gives per lane what the model's
    own table gives: the where-chains pick each lane's formula, and the
    `present` restriction skips only what no lane reads."""
    rng = np.random.default_rng(3)
    tt = rng.integers(0, 9, N).astype(np.int32)
    params = np.stack([_params(int(t), rng)[i] for i, t in enumerate(tt)])
    tau = rng.uniform(0.0, 2.0, (N, 3)).astype(np.float32)
    s_on = _t(rng.uniform(size=N) < 0.5, torch.bool)
    every = ttr.trans_eval(_t(tt, torch.int64), _t(params), _t(tau), s_on, s_on).numpy()
    some = ttr.trans_eval(_t(tt, torch.int64), _t(params), _t(tau), s_on, s_on,
                          present=tuple(sorted(set(tt.tolist())))).numpy()
    np.testing.assert_array_equal(every, some)
    want = np.asarray(jtr.trans_eval(jnp.asarray(tt), jnp.asarray(params), jnp.asarray(tau),
                                     jnp.asarray(s_on.numpy()), jnp.asarray(s_on.numpy())))
    np.testing.assert_allclose(every, want, rtol=1e-5, atol=1e-6)
    for name, t in ttr._NAMES.items():
        assert ttr.trans_id(name) == jtr.trans_id(name) == t
    with pytest.raises(NotImplementedError, match="not implemented yet"):
        ttr.trans_id("gaussian")


def _media_specs():
    return [
        {"type": "homogeneous", "sigma_a": 0.2, "sigma_s": [0.5, 0.6, 0.7],
         "transmittance": {"type": "interpolated", "ratio": 0.3,
                           "tr_a": {"type": "davis", "alpha": 1.5},
                           "tr_b": "double_exponential"}},
        {"type": "homogeneous", "sigma_s": 1.0, "density": 2.0,
         "transmittance": {"type": "pulse", "min": 0.1, "max": 1.7, "num_pulses": 5},
         "phase_function": "rayleigh", "max_bounces": 3},
        {"type": "homogeneous", "sigma_a": 0.4,
         "transmittance": {"type": "davis_weinstein", "h": 1.4, "c": 0.8}},
        {"type": "homogeneous", "sigma_s": 0.3,
         "transmittance": "interpolated",
         "phase_function": {"type": "henyey_greenstein", "g": -0.3}},
    ]


def test_interpolated_layout_and_pack_refusals():
    """pack_media's transmittance rows equal the JAX pack's: the base rows
    [a, b, pulses], the interpolated layout [u, typeA, typeB, paA, pbA, paB,
    pbB, -] with its defaults (linear + erlang, ratio 0.5), h clamped into
    [0.5, 1]; pulse or interpolated children, an unknown medium type and an
    unknown model raise with the JAX package's messages."""
    from tungsten_tpu.models.media import pack_media as jpack
    from tungsten_tpu_torch.models.media.media import pack_media

    specs = _media_specs()
    jt, tt = jpack(specs), pack_media(specs, device=torch.device("cpu"))
    for k in ("trans_type", "trans_params", "phase_type", "phase_g", "max_bounce",
              "sigma_a", "sigma_s", "sigma_t", "absorption_only"):
        np.testing.assert_array_equal(getattr(tt, k).numpy(), np.asarray(getattr(jt, k)),
                                      err_msg=k)
    assert tt.trans_present == jt.trans_present == (6, 7, 8)
    np.testing.assert_array_equal(tt.trans_params[3, :7].numpy(),
                                  [0.5, ttr.T_LINEAR, ttr.T_ERLANG, 1.0, 1.0, 1.0, 1.0])
    for child in ("pulse", "interpolated"):
        bad = [{"transmittance": {"type": "interpolated", "tr_b": {"type": child}}}]
        with pytest.raises(NotImplementedError,
                           match="interpolated transmittance children limited to 2-param"):
            pack_media(bad, device=torch.device("cpu"))
        with pytest.raises(NotImplementedError):
            jpack(bad)
    with pytest.raises(NotImplementedError, match="medium type 'foam' not implemented yet"):
        pack_media([{"type": "foam"}], device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="transmittance model 'box'"):
        pack_media([{"transmittance": "box"}], device=torch.device("cpu"))
