"""The fiber BCSDFs (hair, lambertian_fiber, rough_wire) and the fiber
shading frame against the JAX package, and against themselves.

Both packages flatten one quad scene whose material list holds the three
fiber types in several variants (hair from a melanin mixture and from an
explicit sigma_a, with other roughnesses and scale angles; rough_wire from
a named conductor and from eta / k) beside a lambert: the packed rows and
hair's azimuthal tables must be equal. Then, on the same seeded numpy inputs
(wi and wo over the whole sphere), each type's eval, pdf and sample through
the port's dispatch against the JAX dispatch: >= 99.5% of the elements
within rtol 1e-4 and >= 99.99% within rtol 1e-2 (atol 1e-6 both); `valid`
on >= 99.9% of the lanes and `lobe` equal. The bars are looser than
test_torch_bsdfs.py's rtol 1e-5 for two reasons of the model. M's small-v
form sums terms of size 1 / v before its exp (hair's smooth variant: 1 / v
~ 160), so one ulp of an arcsin or a cos there is ~1.5e-5 of the result,
more at the peak of M where sample lands: the smooth variant's sampled
pdfs hold rtol 1e-4 on ~99.2% of its lanes (99.7-99.8% of all hair lanes,
three seeds), every one rtol 1e-3; and hair looks its tables up at the
rounded cos(theta_d) row and the phi bin, so a lane whose angle rounds
across a row or bin edge reads the neighbour's entry (~1e-4 of the eval /
pdf lanes, up to 1e-2 off). The sample cases run on N_SAMPLE lanes, as
test_torch_wrappers.py runs the coats'.

Then the port's own physics, as tests/test_hair.py and tests/test_fiber.py
hold the JAX package's (pdf normalization, sample against eval / pdf,
bounded energy, absorption, rotation invariance, rough_wire's azimuthal
histogram); the fiber shading frame (`path_tracer._shading_frame`: b = the
fiber tangent, t = b x n) lane by lane against the JAX package's; and RJ-MLT's
BSDF inversion, which refuses every fiber lane as the JAX package's does.
"""
import json
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_bsdfs import _unit
from test_torch_lockstep_area import one_torch_thread  # noqa: F401

N = 4000  # lanes per eval / pdf case
N_SAMPLE = 16000  # lanes per sample case (see the module docstring)


def _close(got, want, mask=None):
    """The module docstring's bars, on the elements of the `mask` lanes."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if mask is not None:
        got, want = got[mask], want[mask]
    for rtol, share in ((1e-4, 0.995), (1e-2, 0.9999)):
        within = np.isclose(got, want, rtol=rtol, atol=1e-6).mean()
        assert within >= share, f"{within:.5f} of elements within rtol {rtol}"

SPECS = {
    "lambert": {"type": "lambert", "albedo": 0.8},
    "hair": {"type": "hair", "melanin_concentration": 1.3, "melanin_ratio": 0.5,
             "roughness": 0.3},
    "hair#sigma": {"type": "hair", "sigma_a": [0.1, 0.2, 0.3], "roughness": 0.25,
                   "scale_angle": 3.0},
    "hair#smooth": {"type": "hair", "melanin_concentration": 0.4, "melanin_ratio": 0.9,
                    "roughness": 0.05},
    "lambertian_fiber": {"type": "lambertian_fiber", "albedo": [0.8, 0.6, 0.4]},
    "rough_wire#au": {"type": "rough_wire", "material": "Au", "roughness": 0.2},
    "rough_wire#eta": {"type": "rough_wire", "eta": [0.2, 0.9, 1.1], "k": [3.9, 2.4, 2.1],
                       "roughness": 0.4},
}
NAMES = list(SPECS)
FIBERS = ("hair", "lambertian_fiber", "rough_wire")


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """Both packages' flatten of one quad scene with the material list above."""
    import tungsten_tpu.accel.bvh as jbvh
    from tungsten_tpu.scene.flatten import flatten_scene as jflatten
    from tungsten_tpu.scene.load import load_scene as jload
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    d = tmp_path_factory.mktemp("fibers")
    doc = {
        "bsdfs": [dict(spec, name=name) for name, spec in SPECS.items()],
        "primitives": [{"type": "quad", "bsdf": "lambert"}],
        "camera": {"resolution": [8, 8],
                   "transform": {"position": [0, 2, 0], "look_at": [0, 0, 0], "up": [0, 0, 1]}},
    }
    with open(d / "scene.json", "w") as f:
        json.dump(doc, f)
    mp = pytest.MonkeyPatch()
    mp.setattr(jbvh, "_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    js = jflatten(jload(str(d / "scene.json")))
    mp.undo()
    return js, flatten_scene(load_scene(str(d / "scene.json")), torch.device("cpu"))


def _inputs(rng, js, ts, names, n):
    """Seeded lanes over the materials `names`: (mat ids, uv, wi, wo, u2,
    u1) as numpy, and both packages' gathered rows."""
    from tungsten_tpu.models.bsdfs.dispatch import _gather
    from tungsten_tpu_torch.models.bsdfs import dispatch as td

    ids = np.array([NAMES.index(k) for k in names])
    mat = ids[rng.integers(0, len(ids), n)].astype(np.int32)
    uv = rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    wi, wo = _unit(rng, n), _unit(rng, n)
    u2 = rng.random((n, 2)).astype(np.float32)
    u1 = rng.random(n).astype(np.float32)
    jpre = _gather((js.materials, js.textures), jnp.asarray(mat), jnp.asarray(uv))
    tpre = td.gather(ts.materials, ts.textures, torch.as_tensor(mat.astype(np.int64)),
                     torch.as_tensor(uv))
    return (mat, uv, wi, wo, u2, u1), jpre, tpre


def test_packed_tables_equal(tables):
    """The material rows (type ids 18-20, lobes, params with hair's table
    index, beta_r and scale angle) and hair's three tables per hair
    material are the JAX package's."""
    js, ts = tables
    np.testing.assert_array_equal(ts.materials.gpack2.numpy(), np.asarray(js.materials.gpack2))
    assert ts.materials.present == tuple(js.materials.present) == (0, 18, 19, 20)
    for k in ("hair_tables", "hair_cdf", "hair_sums"):
        np.testing.assert_array_equal(getattr(ts.materials, k).numpy(),
                                      np.asarray(getattr(js.materials, k)), err_msg=k)
    assert ts.materials.hair_tables.shape == (3, 3, 64, 64, 3)


def test_hair_needs_its_tables():
    """A table whose rows hold a hair material but no hair tables is
    refused; without hair the tables are None."""
    from tungsten_tpu_torch.models.bsdfs import dispatch as td
    from tungsten_tpu_torch.models.textures.textures import TextureBuilder

    tb = TextureBuilder()
    packed = td.pack_materials([SPECS["hair"], SPECS["lambert"]], tb)
    gpack2 = td.build_gpack2(packed, tb.build_arrays()["tpack"])
    cpu = torch.device("cpu")
    with pytest.raises(KeyError, match="hair"):
        td.MaterialTable.from_arrays(gpack2, (), cpu)
    mats = td.MaterialTable.from_arrays(gpack2, (), cpu, hair=packed["hair"])
    assert mats.hair_cdf.shape == (1, 3, 64, 65) and mats.hair_sums.shape == (1, 3, 64)
    tb = TextureBuilder()
    plain = td.pack_materials([SPECS["lambert"]], tb)
    assert plain["hair"] == {}
    mats = td.MaterialTable.from_arrays(td.build_gpack2(plain, tb.build_arrays()["tpack"]),
                                        (), cpu)
    assert mats.hair_tables is None


@pytest.mark.parametrize("kind", ["eval", "pdf", "sample"])
@pytest.mark.parametrize("bsdf", FIBERS)
def test_fiber_matches_jax(tables, rng, bsdf, kind):
    from tungsten_tpu.models.bsdfs import bsdf_eval, bsdf_pdf, bsdf_sample
    from tungsten_tpu_torch.models.bsdfs import dispatch as td

    js, ts = tables
    names = [k for k in NAMES if k.split("#")[0] == bsdf]
    n = N_SAMPLE if kind == "sample" else N
    (mat, uv, wi, wo, u2, u1), jpre, tpre = _inputs(rng, js, ts, names, n)
    ctx = (js.materials, js.textures)
    J, T = jnp.asarray, torch.as_tensor
    if kind == "eval":
        want = bsdf_eval(ctx, J(mat), J(uv), J(wi), J(wo), pre=jpre)
        _close(td.bsdf_eval(ts.materials, tpre, T(uv), T(wi), T(wo), textures=ts.textures), want)
        assert (np.asarray(want).max(-1) > 0).mean() > 0.5
    elif kind == "pdf":
        want = bsdf_pdf(ctx, J(mat), J(uv), J(wi), J(wo), pre=jpre)
        _close(td.bsdf_pdf(ts.materials, tpre, T(uv), T(wi), T(wo), textures=ts.textures), want)
        assert (np.asarray(want) > 0).mean() > 0.5
    else:
        want = bsdf_sample(ctx, J(mat), J(uv), J(wi), J(u2), J(u1), pre=jpre)
        got = td.bsdf_sample(ts.materials, tpre, T(uv), T(wi), T(u2), T(u1),
                             textures=ts.textures)
        ok = np.asarray(want.valid)
        assert (got.valid.numpy() == ok).mean() >= 0.999
        np.testing.assert_array_equal(got.lobe.numpy(), np.asarray(want.lobe))
        both = ok & got.valid.numpy()
        _close(got.wo, want.wo, mask=both)
        _close(got.pdf, want.pdf, mask=both)
        _close(got.weight, want.weight, mask=both)
        assert ok.mean() > 0.9


def _ctx(sigma=(0.1, 0.2, 0.3), roughness=0.25, scale_deg=2.0):
    """A one-material hair context, as tests/test_hair.py's _hair_ctx: (ctx,
    params (1, 16))."""
    from tungsten_tpu_torch.models.bsdfs import hair

    beta_r = max(np.pi / 2 * roughness, 0.04)
    tab, cdf, sums = hair.precompute_azimuthal(np.asarray(sigma), beta_r)
    params = torch.zeros((1, 16))
    params[0, 0] = float(np.deg2rad(scale_deg))
    params[0, 1] = beta_r
    mats = types.SimpleNamespace(hair_tables=torch.as_tensor(tab[None]),
                                 hair_cdf=torch.as_tensor(cdf[None]),
                                 hair_sums=torch.as_tensor(sums[None]))
    return (mats, None), params


def _dirs(n, seed):
    return torch.as_tensor(_unit(np.random.default_rng(seed), n))


def _fixed_dir(n, v):
    v = torch.tensor(v, dtype=torch.float32)
    return (v / v.norm()).expand(n, 3)


def test_hair_tables_match_jax():
    from tungsten_tpu.models.bsdfs import hair as jhair
    from tungsten_tpu_torch.models.bsdfs import hair

    for sigma, beta in (((0.1, 0.2, 0.3), 0.39), ((0.0, 0.0, 0.0), 0.04), ((2.0, 1.0, 0.5), 0.8)):
        for a, b in zip(hair.precompute_azimuthal(sigma, beta),
                        jhair.precompute_azimuthal(sigma, beta)):
            np.testing.assert_array_equal(a, b)


def test_hair_pdf_normalizes():
    """The sphere integral of the pdf for a fixed wi is ~1."""
    from tungsten_tpu_torch.models.bsdfs import hair

    ctx, params = _ctx()
    n = 200_000
    p = hair.pdf(ctx, params.expand(n, 16), None, None,
                 _fixed_dir(n, [0.3, 0.4, np.sqrt(0.75)]), _dirs(n, 3)).numpy()
    assert np.isfinite(p).all() and (p >= 0).all()
    assert abs(p.mean() * 4.0 * np.pi - 1.0) < 0.05


def test_hair_sample_matches_pdf_and_eval():
    from tungsten_tpu_torch.models.bsdfs import hair

    ctx, params = _ctx()
    n = 4096
    g = torch.Generator().manual_seed(4)
    wi, pr = _dirs(n, 4), params.expand(n, 16)
    bs = hair.sample(ctx, pr, None, None, wi, torch.rand((n, 2), generator=g),
                     torch.rand(n, generator=g))
    ok = bs.valid.numpy()
    assert ok.mean() > 0.95
    p = hair.pdf(ctx, pr, None, None, wi, bs.wo).numpy()
    np.testing.assert_allclose(bs.pdf.numpy()[ok], p[ok], rtol=1e-4)
    f = hair.eval(ctx, pr, None, None, wi, bs.wo).numpy()
    np.testing.assert_allclose(bs.weight.numpy()[ok], (f / np.maximum(p[:, None], 1e-20))[ok],
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(bs.wo.norm(dim=-1).numpy()[ok], 1.0, atol=1e-4)


def test_hair_energy_bounded_and_absorption_darkens():
    """Without absorption R + TT + TRT scatter at most the incident energy
    (and not nothing); sigma_a 2 darkens it."""
    from tungsten_tpu_torch.models.bsdfs import hair

    n = 200_000
    wo = _dirs(n, 5)
    ctx0, params = _ctx(sigma=(0.0, 0.0, 0.0))
    ctx1, _ = _ctx(sigma=(2.0, 2.0, 2.0))
    wi = _fixed_dir(n, [0.0, 0.2, np.sqrt(0.96)])
    f0 = hair.eval(ctx0, params.expand(n, 16), None, None, wi, wo).numpy()
    integral = f0.mean(0) * 4.0 * np.pi
    assert np.all(integral < 1.05) and np.all(integral > 0.3), integral
    f1 = hair.eval(ctx1, params.expand(n, 16), None, None, wi, wo).numpy()
    assert f1.mean() < f0.mean() * 0.8


def _zeros(n):
    return torch.zeros((n, 16))


def test_lambertian_fiber_furnace_sample_and_rotation():
    """The Lambertian cylinder conserves energy (the sphere integral of eval
    is the albedo), its sample's weight is eval / pdf, and eval depends only
    on the azimuth difference of wo and wi."""
    from tungsten_tpu_torch.models.bsdfs import lambertian_fiber as lf

    n = 400_000
    f = lf.eval(None, _zeros(n), torch.ones((n, 3)), None, _fixed_dir(n, [0.2, 0.5, 0.6]),
                _dirs(n, 10)).numpy()
    np.testing.assert_allclose(f.mean(0) * 4.0 * np.pi, 1.0, atol=0.02)

    n = 8192
    g = torch.Generator().manual_seed(11)
    wi, albedo = _dirs(n, 11), torch.full((n, 3), 0.7)
    bs = lf.sample(None, _zeros(n), albedo, None, wi, torch.rand((n, 2), generator=g),
                   torch.rand(n, generator=g))
    ok = bs.valid.numpy()
    assert ok.mean() > 0.95
    p = lf.pdf(None, _zeros(n), albedo, None, wi, bs.wo).numpy()
    np.testing.assert_allclose(bs.pdf.numpy()[ok], p[ok], rtol=1e-4)
    f = lf.eval(None, _zeros(n), albedo, None, wi, bs.wo).numpy()
    np.testing.assert_allclose(bs.weight.numpy()[ok], (f / np.maximum(p[:, None], 1e-20))[ok],
                               rtol=1e-3, atol=1e-5)

    a = 1.234
    rot = torch.tensor([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
                       dtype=torch.float32)
    wi, wo, ones = _dirs(256, 12), _dirs(256, 13), torch.ones((256, 3))
    np.testing.assert_allclose(lf.eval(None, _zeros(256), ones, None, wi @ rot.T, wo @ rot.T),
                               lf.eval(None, _zeros(256), ones, None, wi, wo), rtol=1e-4,
                               atol=1e-6)


def _wire_params(n, roughness=0.3):
    p = torch.zeros((n, 16))
    p[:, 0:3] = torch.tensor([0.200438, 0.924033, 1.10221])  # Cu
    p[:, 3:6] = torch.tensor([3.91295, 2.45285, 2.14219])
    p[:, 6] = (roughness * np.pi / 2) ** 2
    return p


def test_rough_wire_pdf_sample_and_energy():
    from tungsten_tpu_torch.models.bsdfs import rough_wire as rw

    n = 400_000
    p = rw.pdf(None, _wire_params(n), None, None, _fixed_dir(n, [0.1, 0.3, 0.9]),
               _dirs(n, 13)).numpy()
    assert np.isfinite(p).all() and (p >= 0).all()
    assert abs(p.mean() * 4.0 * np.pi - 1.0) < 0.05

    n = 8192
    g = torch.Generator().manual_seed(14)
    params, ones, wi = _wire_params(n, 0.4), torch.ones((n, 3)), _dirs(n, 14)
    bs = rw.sample(None, params, ones, None, wi, torch.rand((n, 2), generator=g),
                   torch.rand(n, generator=g))
    ok = bs.valid.numpy()
    assert ok.mean() > 0.9
    p = rw.pdf(None, params, ones, None, wi, bs.wo).numpy()
    np.testing.assert_allclose(bs.pdf.numpy()[ok], p[ok], rtol=2e-3)
    f = rw.eval(None, params, ones, None, wi, bs.wo).numpy()
    np.testing.assert_allclose(bs.weight.numpy()[ok], (f / np.maximum(p[:, None], 1e-20))[ok],
                               rtol=2e-3, atol=1e-5)

    n = 200_000
    f = rw.eval(None, _wire_params(n), torch.ones((n, 3)), None,
                _fixed_dir(n, [0.3, -0.1, 0.8]), _dirs(n, 16)).numpy()
    integral = f.mean(0) * 4.0 * np.pi
    assert np.all(integral < 1.02) and np.all(integral > 0.2), integral


def test_rough_wire_azimuth_histogram_matches_N():  # noqa: N802 (the reference's N)
    """The sampled azimuthal deflection follows N(cos phi) = 0.25 cos(phi/2)."""
    from tungsten_tpu_torch.models.bsdfs import rough_wire as rw

    n = 400_000
    g = torch.Generator().manual_seed(15)
    wi = _fixed_dir(n, [0.0, 0.2, np.sqrt(0.96)])
    bs = rw.sample(None, _wire_params(n, 0.2), torch.ones((n, 3)), None, wi,
                   torch.rand((n, 2), generator=g), torch.rand(n, generator=g))
    wo, wiv = bs.wo.numpy(), wi.numpy()
    phi = np.arctan2(wo[:, 0], wo[:, 2]) - np.arctan2(wiv[:, 0], wiv[:, 2])
    phi = (phi + np.pi) % (2 * np.pi) - np.pi
    hist, edges = np.histogram(phi, bins=32, range=(-np.pi, np.pi), density=True)
    centers = 0.5 * (edges[:-1] + edges[1:])
    np.testing.assert_allclose(hist, 0.25 * np.cos(centers / 2), rtol=0.06, atol=0.004)


def test_fiber_shading_frame_matches_jax_per_lane(rng):
    """_shading_frame on fiber rows (b = the tangent, t = b x n, n = t x b),
    on rows without a tangent (the usual frame), with the two-sided flip,
    and with triangle ids past the table (clamped), against the JAX
    package's lane by lane; and a scene without curves ignores tri_tan."""
    from tungsten_tpu.integrators.path_tracer import _shading_frame as jframe
    from tungsten_tpu_torch.integrators.path_tracer import _shading_frame

    n, rows = 8192, 64
    tan = _unit(rng, rows)
    tan[rng.random(rows) < 0.25] = 0.0  # rows that are not fibers
    ns = _unit(rng, n)
    tri = rng.integers(-3, rows + 3, n)
    flip = rng.random(n) < 0.3

    def scene(has, t):
        return types.SimpleNamespace(meta=types.SimpleNamespace(has_fiber_tan=has), tri_tan=t)

    frames = {}
    for has in (True, False):
        want = jframe(scene(has, jnp.asarray(tan)), jnp.asarray(np.clip(tri, 0, None)),
                      jnp.asarray(ns), jnp.asarray(flip))
        got = _shading_frame(scene(has, torch.as_tensor(tan)), torch.as_tensor(tri),
                             torch.as_tensor(ns), torch.as_tensor(flip))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
        frames[has] = [a.numpy() for a in got]
    fiber = (np.linalg.norm(tan, axis=-1) > 0)[np.clip(tri, 0, rows - 1)]
    assert fiber.mean() > 0.5
    t_ax, b_ax, n_ax = frames[True]
    np.testing.assert_allclose(b_ax[fiber], tan[np.clip(tri, 0, rows - 1)][fiber], atol=1e-6)
    np.testing.assert_array_equal(t_ax[~fiber], frames[False][0][~fiber])
    assert np.abs(np.einsum("ij,ij->i", t_ax, n_ax)).max() < 1e-5


def test_rjmlt_inversion_refuses_the_fibers(tables, rng):
    """The fibers have no inverter (invert.py:16): RJ-MLT's inversion
    reports ok = False on every fiber lane, as the JAX package's does, and
    inverts the lambert lanes."""
    from tungsten_tpu.models.bsdfs.invert import bsdf_invert as jinvert
    from tungsten_tpu_torch.models.bsdfs.invert import bsdf_invert

    js, ts = tables
    (mat, uv, wi, wo, _, _), _, _ = _inputs(rng, js, ts, NAMES, N)
    wi[:, 2], wo[:, 2] = np.abs(wi[:, 2]), np.abs(wo[:, 2])
    ok = bsdf_invert((ts.materials, ts.textures), torch.as_tensor(mat.astype(np.int64)),
                     torch.as_tensor(uv), torch.as_tensor(wi), torch.as_tensor(wo))[2].numpy()
    jok = np.asarray(jinvert((js.materials, js.textures), jnp.asarray(mat), jnp.asarray(uv),
                             jnp.asarray(wi), jnp.asarray(wo))[2])
    fiber = mat != NAMES.index("lambert")
    assert not ok[fiber].any() and not jok[fiber].any()
    assert ok[~fiber].all() and jok[~fiber].all()
