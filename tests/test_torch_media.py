"""The port's participating media against the JAX package's, per call, and
the analytic checks of tests/test_media.py on the port's renders.

One medium table holds every kind: homogeneous (davis transmittance, HG),
exponential (erlang), atmosphere (its center from a `pivot`), voxel (a
gaussian grid, exact_linear; a dense grid with emission, exact_nearest)
and absorption-only homogeneous, exponential and voxel media. Lanes are
spread over those media and vacuum, with random rays, far distances (some
infinite), MediumStates (some past max_bounces) and uniforms, made from a
seed with numpy. medium_sample_distance (with and without
want_continued), medium_distance_pdf and medium_transmittance run in both
packages on the same inputs.

Bars. XLA on the CPU contracts multiply-adds and evaluates exp / log / erf /
erfinv with its own approximations, and the voxel media's cell walks sum
per-cell Gauss integrals whose rounding differs by an ulp per cell; a
sampled distance can therefore land on the other side of far_t (exited
flips) on a lane whose sample sits within rounding of it. So: the booleans
(exited, scattered) agree on >= 99.5% of lanes; on the lanes where they
agree, t and p within atol 2e-5 + rtol 1e-4, the weights, pdfs and
emission within rtol 1e-3 (atol 1e-6) on >= 99.5% of lanes (the weights
divide by pdfs that can be tiny); the transmittance and distance pdf
within rtol 1e-4, atol 1e-6. Vacuum lanes carry no meaningful pdf in either
package (the port skips their grid walks), so the pdf is compared on
in-medium lanes.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tungsten_tpu.models import media as jm
from tungsten_tpu_torch.models.media import media as tm
from test_torch_host import media_arrays

N = 2048


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _specs(tmp_path):
    rng = np.random.default_rng(1)
    dens = rng.uniform(0.0, 1.5, (8, 10, 12)).astype(np.float32)
    path = str(tmp_path / "vox.npz")
    np.savez(path, density=dens, emission=rng.uniform(0, 3, (8, 10, 12, 3)).astype(np.float32))
    blob = {"type": "gaussian", "resolution": 16, "sigma": 0.25,
            "transform": {"position": [0.3, -0.2, 0.1], "scale": 1.5}}
    return [
        {"type": "homogeneous", "sigma_a": 0.2, "sigma_s": [0.6, 0.8, 1.0],
         "transmittance": {"type": "davis", "alpha": 2.0},
         "phase_function": {"type": "henyey_greenstein", "g": 0.6}},
        {"type": "exponential", "sigma_a": 0.1, "sigma_s": 0.9, "falloff_scale": 0.8,
         "falloff_direction": [0.2, 1.0, 0.1], "unit_point": [0.0, -0.5, 0.0],
         "transmittance": {"type": "erlang", "rate": 1.5}},
        {"type": "atmosphere", "sigma_a": 0.3, "sigma_s": 1.2, "radius": 1.2,
         "falloff_scale": 1.5, "pivot": "dome"},
        {"type": "voxel", "sigma_a": 0.5, "sigma_s": [2.0, 2.5, 3.0], "grid": blob},
        {"type": "voxel", "sigma_a": 0.2, "sigma_s": 1.0,
         "grid": {"type": "dense", "file": path, "sampling_method": "exact_nearest",
                  "transform": {"position": [-0.2, -0.4, 0.0], "scale": 1.2}}},
        {"type": "homogeneous", "sigma_a": [0.4, 0.5, 0.6]},
        {"type": "exponential", "sigma_a": 0.7, "falloff_scale": 0.5},
        {"type": "voxel", "sigma_a": 1.3, "grid": blob, "max_bounces": 2},
    ]


def _origin(name):
    return np.array([0.1, 0.2, -0.3]) if name == "dome" else None


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    specs = _specs(tmp_path_factory.mktemp("media"))
    return (jm.pack_media(specs, prim_origin=_origin),
            tm.pack_media(specs, prim_origin=_origin, device=torch.device("cpu")), len(specs))


@pytest.fixture(scope="module")
def lanes(tables):
    k = tables[2]
    rng = np.random.default_rng(5)
    o = rng.uniform(-1.5, 1.5, (N, 3)).astype(np.float32)
    aim = rng.uniform(-0.5, 0.5, (N, 3)).astype(np.float32)
    d = aim - o + rng.normal(scale=0.3, size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    far = rng.uniform(0.2, 4.0, N).astype(np.float32)
    far[rng.uniform(size=N) < 0.25] = 3.0e38
    mid = rng.integers(-1, k, N).astype(np.int32)
    return dict(mid=mid, o=o, d=d.astype(np.float32), far=far,
                first=rng.uniform(size=N) < 0.6, bounce=rng.integers(0, 4, N).astype(np.int32),
                u=[rng.uniform(size=N).astype(np.float32) for _ in range(3)],
                s_on=rng.uniform(size=N) < 0.5, e_on=rng.uniform(size=N) < 0.5,
                t=rng.uniform(0.0, 3.0, N).astype(np.float32))


def test_medium_table_carries_across(tables):
    """The port's pack equals the JAX pack_media output field by field, and
    MediumTable.from_arrays(media_arrays(the JAX table)) equals the port's
    own pack: arrays exactly, statics equal, each grid's fields and statics
    equal."""
    jt, tt, _ = tables
    across = tm.MediumTable.from_arrays(media_arrays(jt), torch.device("cpu"))
    for table in (tt, across):
        for k, _ in tm.ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(table, k).numpy(), np.asarray(getattr(jt, k)),
                                          err_msg=k)
        for k in tm.STATIC_FIELDS:
            assert getattr(table, k) == getattr(jt, k), k
        assert len(table.vox_grids) == len(jt.vox_grids) == 3
        for g, jg in zip(table.vox_grids, jt.vox_grids):
            for k in g.FIELDS:
                np.testing.assert_array_equal(getattr(g, k).numpy(), np.asarray(getattr(jg, k)))
            for k in g.STATICS:
                assert getattr(g, k) == getattr(jg, k), k
    assert tt.has_hetero and tt.has_emissive_grid and tt.vox_owner == (3, 4, 7)
    np.testing.assert_array_equal(tt.atm_center[2].numpy(), np.float32([0.1, 0.2, -0.3]))


def _close_share(a, b, rtol, atol):
    ok = np.abs(a - b) <= atol + rtol * np.abs(b)
    return ok.reshape(len(a), -1).all(axis=1)


@pytest.mark.parametrize("want_continued", [False, True])
def test_medium_sample_distance_matches_jax(tables, lanes, want_continued):
    jt, tt, _ = tables
    L = lanes
    jms = jm.medium_sample_distance(
        jt, jnp.asarray(L["mid"]), jnp.asarray(L["o"]), jnp.asarray(L["d"]),
        jnp.asarray(L["far"]), jnp.asarray(L["first"]), jnp.asarray(L["bounce"]),
        *(jnp.asarray(u) for u in L["u"]), want_continued=want_continued)
    tms = tm.medium_sample_distance(
        tt, _t(L["mid"], torch.int64), _t(L["o"]), _t(L["d"]), _t(L["far"]),
        _t(L["first"], torch.bool), _t(L["bounce"], torch.int64), *(_t(u) for u in L["u"]),
        want_continued=want_continued)
    ex, sc = tms.exited.numpy(), tms.scattered.numpy()
    same = (ex == np.asarray(jms.exited)) & (sc == np.asarray(jms.scattered))
    assert same.mean() >= 0.995, f"{(~same).sum()} lanes flip"
    assert sc.mean() > 0.2 and ex.mean() > 0.2
    inm = same & (L["mid"] >= 0)
    for name, rtol, atol in (("t", 1e-4, 2e-5), ("p", 1e-4, 2e-5), ("weight", 1e-3, 1e-6),
                             ("emission", 1e-3, 1e-6), ("pdf", 1e-3, 1e-6)):
        got = getattr(tms, name).numpy()
        want = np.asarray(getattr(jms, name))
        lanes_ = inm if name == "pdf" else same
        ok = _close_share(got[lanes_], want[lanes_], rtol, atol)
        assert ok.mean() >= 0.995, f"{name}: {(~ok).sum()} lanes off"
    assert (tms.emission.numpy() > 0).any()
    if want_continued:
        for name in ("continued_t", "continued_weight"):
            got = getattr(tms, name).numpy()[same]
            want = np.asarray(getattr(jms, name))[same]
            ok = _close_share(got, want, 1e-3, 2e-5)
            assert ok.mean() >= 0.995, f"{name}: {(~ok).sum()} lanes off"
    else:
        assert tms.continued_t is None and tms.continued_weight is None
    w = tms.weight.numpy()
    assert np.isfinite(w).all() and (w >= 0).all()


def test_medium_distance_pdf_and_transmittance_match_jax(tables, lanes):
    jt, tt, _ = tables
    L = lanes
    args_j = (jnp.asarray(L["mid"]),)
    args_t = (_t(L["mid"], torch.int64),)
    got = tm.medium_distance_pdf(tt, *args_t, _t(L["o"]), _t(L["d"]), _t(L["t"]),
                                 _t(L["s_on"], torch.bool), _t(L["e_on"], torch.bool)).numpy()
    want = np.asarray(jm.medium_distance_pdf(jt, *args_j, jnp.asarray(L["o"]),
                                             jnp.asarray(L["d"]), jnp.asarray(L["t"]),
                                             jnp.asarray(L["s_on"]), jnp.asarray(L["e_on"])))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert (got[L["mid"] < 0] == 1.0).all()
    for with_ray in (True, False):
        ray_t = (_t(L["o"]), _t(L["d"])) if with_ray else ()
        ray_j = (jnp.asarray(L["o"]), jnp.asarray(L["d"])) if with_ray else ()
        got = tm.medium_transmittance(tt, *args_t, _t(L["far"]), _t(L["s_on"], torch.bool),
                                      _t(L["e_on"], torch.bool), *ray_t).numpy()
        want = np.asarray(jm.medium_transmittance(jt, *args_j, jnp.asarray(L["far"]),
                                                  jnp.asarray(L["s_on"]),
                                                  jnp.asarray(L["e_on"]), *ray_j))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
        assert (got[L["mid"] < 0] == 1.0).all()


def test_homogeneous_only_table(lanes):
    """A table without heterogeneous media takes the closed-form branch
    (has_hetero False) in both packages."""
    specs = [{"sigma_a": 0.3, "sigma_s": 0.9, "transmittance": "quadratic"},
             {"sigma_a": 0.5, "transmittance": {"type": "linear", "max_t": 2.0}}]
    jt, tt = jm.pack_media(specs), tm.pack_media(specs, device=torch.device("cpu"))
    assert not tt.has_hetero
    L = lanes
    mid = np.clip(L["mid"], -1, 1)
    jms = jm.medium_sample_distance(
        jt, jnp.asarray(mid), jnp.asarray(L["o"]), jnp.asarray(L["d"]), jnp.asarray(L["far"]),
        jnp.asarray(L["first"]), jnp.asarray(L["bounce"]), *(jnp.asarray(u) for u in L["u"]))
    tms = tm.medium_sample_distance(
        tt, _t(mid, torch.int64), _t(L["o"]), _t(L["d"]), _t(L["far"]),
        _t(L["first"], torch.bool), _t(L["bounce"], torch.int64), *(_t(u) for u in L["u"]))
    np.testing.assert_array_equal(tms.exited.numpy(), np.asarray(jms.exited))
    np.testing.assert_allclose(tms.t.numpy(), np.asarray(jms.t), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tms.weight.numpy(), np.asarray(jms.weight), rtol=1e-4,
                               atol=1e-6)


# ---- the analytic checks of tests/test_media.py, on the port's renders ----

def _medium_scene(sigma_a, trans=None, dist=2.0, kind=None):
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import parse_scene

    medium = {"name": "fog", "type": "homogeneous", "sigma_a": sigma_a, "sigma_s": 0.0,
              "phase_function": {"type": "isotropic"}}
    if trans:
        medium["transmittance"] = trans
    if kind:
        medium.update(kind)
    doc = parse_scene({
        "media": [medium],
        "bsdfs": [{"name": "black", "albedo": 0, "type": "lambert"}],
        "primitives": [{"type": "quad", "transform": {"position": [0, 0, 0], "scale": 8.0},
                        "emission": [4.0] * 3, "bsdf": "black"}],
        "camera": {"type": "pinhole", "tonemap": "linear", "resolution": [24, 24],
                   "reconstruction_filter": "tent", "fov": 20, "medium": "fog",
                   "transform": {"position": [0, dist, 0], "look_at": [0, 0, 0],
                                 "up": [0, 0, 1]}},
        "integrator": {"type": "path_tracer", "max_bounces": 16},
        "renderer": {"spp": 8, "scene_bvh": False}}, path="/tmp/medium.json")
    return flatten_scene(doc, torch.device("cpu"))


def _center_mean(img):
    return img[9:15, 9:15].mean()


ANALYTIC = [
    ("exponential", None, None, np.exp(-0.7 * 2.0)),
    ("davis", {"type": "davis", "alpha": 2.0}, None, (1 + 1.4 / 2.0) ** -2.0),
    ("quadratic", {"type": "quadratic", "max_t": 3.0}, None,
     1 - 2 * (1.4 / 3) + (1.4 / 3) ** 2),
    ("erlang", {"type": "erlang", "rate": 1.0}, None, 0.5 * np.exp(-1.4) * (2 + 1.4)),
    ("double_exponential", {"type": "double_exponential", "sigma_a": 0.5, "sigma_b": 2.0},
     None, 0.5 * (np.exp(-0.5 * 1.4) + np.exp(-2.0 * 1.4))),
    ("davis_weinstein", {"type": "davis_weinstein", "h": 0.75, "c": 1.0}, None,
     (1.0 + np.sqrt(1.4)) ** (-np.sqrt(1.4))),
    ("interpolated", {"type": "interpolated", "ratio": 0.5,
                      "tr_a": {"type": "linear", "max_t": 3.0},
                      "tr_b": {"type": "erlang", "rate": 1.0}}, None,
     (1.0 / (0.5 * 3.0 + 0.5 * 2.0))
     * (0.5 * (1 - 1.4 / 3) * 3.0 + 0.5 * (0.5 * np.exp(-1.4) * (2 + 1.4)) * 2.0)),
    # ExponentialMedium: tau = sigma_a (1 - e^{-k d}) / k
    ("exponential medium", None, {"type": "exponential", "falloff_scale": 0.5,
                                  "falloff_direction": [0, 1, 0], "unit_point": [0, 0, 0]},
     np.exp(-0.7 * (1 - np.exp(-0.5 * 2.0)) / 0.5)),
]


@pytest.mark.parametrize("name,trans,kind,expected_tr", ANALYTIC, ids=[a[0] for a in ANALYTIC])
def test_absorption_matches_analytic(name, trans, kind, expected_tr):
    """Pure absorption between the camera and an emitter 2 units away: the
    pixel is E * T_ss(tau) (tests/test_media.py's bars: 1%, 1.5% for the
    non-exponential models)."""
    from tungsten_tpu_torch.renderer.render import render_flat

    img = render_flat(_medium_scene(0.7, trans, kind=kind), spp=8, seed=3)
    expected = 4.0 * expected_tr
    tol = 0.01 if trans is None else 0.015
    assert abs(_center_mean(img) - expected) / expected < tol, (_center_mean(img), expected)


def test_atmosphere_medium_absorption():
    """AtmosphericMedium: a vertical ray through the center line has tau =
    sigma_a e^{s^2 R^2} sqrt(pi) / (2 s) erf(2 s) (1%)."""
    from scipy.special import erf

    from tungsten_tpu_torch.renderer.render import render_flat

    img = render_flat(_medium_scene(0.7, kind={"type": "atmosphere", "radius": 1.5,
                                               "falloff_scale": 1.2, "center": [0, 0, 0]}),
                      spp=8, seed=3)
    s = 1.2 / 1.5
    integral = np.exp(s * s * 1.5 * 1.5) * np.sqrt(np.pi) / (2 * s) * erf(2 * s)
    expected = 4.0 * np.exp(-0.7 * integral)
    assert abs(_center_mean(img) - expected) / expected < 0.01


@pytest.mark.parametrize("variant", ["fog", "cloud", "haze", "forward"])
def test_flatten_media_matches_jax(monkeypatch, tmp_path, variant):
    """small-media's variants flattened by both packages (numpy BVH build):
    the per-triangle media (the analytic sphere's row after the triangles),
    has_media and camera_medium, and the medium table field by field; the
    JAX FlatScene carried across with from_arrays gives the same."""
    import tungsten_tpu.accel.bvh as jbvh
    import tungsten_tpu_torch.accel.bvh as tbvh
    from tungsten_tpu.scene.flatten import flatten_scene as jflatten
    from tungsten_tpu.scene.load import load_scene as jload
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.scene.flatten import flatten_scene, from_arrays
    from tungsten_tpu_torch.scene.load import load_scene
    from test_torch_host import jax_arrays

    monkeypatch.setattr(jbvh, "_NATIVE", False)
    monkeypatch.setattr(tbvh, "_NATIVE", False)
    monkeypatch.setattr(jbvh, "_CACHE_DIR", str(tmp_path / "bvh_cache"))
    path = synth.write_scene(str(tmp_path / variant), "small-media", variant)
    js = jflatten(jload(path))
    cpu = torch.device("cpu")
    for scene in (flatten_scene(load_scene(path), cpu), from_arrays(jax_arrays(js), js.meta, cpu)):
        for k in ("tri_med_int", "tri_med_ext", "tri_med_override"):
            np.testing.assert_array_equal(getattr(scene, k).numpy(), np.asarray(getattr(js, k)),
                                          err_msg=k)
        assert scene.meta.has_media and scene.meta.camera_medium == js.meta.camera_medium
        for k, _ in tm.ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(scene.media, k).numpy(),
                                          np.asarray(getattr(js.media, k)), err_msg=k)
        for k in tm.STATIC_FIELDS:
            assert getattr(scene.media, k) == getattr(js.media, k), k
    assert int(np.asarray(js.tri_med_override).sum()) > 0 or variant in ("fog", "forward")
    if variant == "haze":  # the sphere's row: interior atmo, exterior haze
        assert scene.tri_med_int[-1] == 1 and scene.tri_med_ext[-1] == 0
        np.testing.assert_array_equal(scene.media.atm_center[1].numpy(),
                                      np.float32([-1.8, 0.8, 1.2]))
