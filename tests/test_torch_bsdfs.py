"""The port's BSDF families against the JAX package, and against themselves.

Both packages flatten one scene whose material list holds every BSDF type
the port carries, several variants of each (textured roughness from a
checker and from a bitmap, reflection-only dielectrics, absorbing plastic,
the three microfacet distributions): the packed rows must be equal. Then,
on the same seeded numpy inputs (wi and wo over the whole sphere, uv
spanning the textures), each type's eval, pdf and sample through the port's
dispatch against the JAX dispatch, with nonspecular_only False and True.
The bars are test_torch_shading.py's: >= 99.9% of the elements within rtol
1e-5 (eval, pdf) or 1e-4 (sample: a one-ulp difference in cos(theta_m) is
conditioned at ~1 / sin^2(theta_m)), every element within rtol 1e-3;
`valid` and `lobe` equal.

Then bsdf_eta_sq, compute_diffuse_fresnel (equal as a float),
resolve_roughness on the textured slots, and the port's own sample against
its eval / pdf and its pdf's normalization, as tests/test_bsdfs.py holds the
JAX package's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

RTOL, ATOL = 1e-5, 1e-6
RTOL_ALL, ATOL_ALL = 1e-3, 1e-5
N = 4000

CHECKER_ROUGH = {"type": "checker", "on_color": 0.05, "off_color": 0.45, "res_u": 6, "res_v": 3}
# name -> spec; the name's prefix up to "#" is the BSDF type
SPECS = {
    "lambert": {"type": "lambert", "albedo": 0.8},
    "null": {"type": "null"},
    "mirror": {"type": "mirror", "albedo": [0.9, 0.8, 0.7]},
    "conductor#au": {"type": "conductor", "material": "Au"},
    "conductor#eta_k": {"type": "conductor", "eta": [0.2, 0.9, 1.1], "k": [3.9, 2.4, 2.1],
                        "albedo": 0.9},
    "dielectric": {"type": "dielectric", "ior": 1.5},
    "dielectric#reflect_only": {"type": "dielectric", "ior": 1.33, "enable_refraction": False},
    "rough_dielectric#ggx": {"type": "rough_dielectric", "ior": 1.5, "distribution": "ggx",
                             "roughness": 0.25},
    "rough_dielectric#checker": {"type": "rough_dielectric", "ior": 1.7,
                                 "distribution": "beckmann", "roughness": CHECKER_ROUGH},
    "rough_dielectric#phong_reflect_only": {
        "type": "rough_dielectric", "ior": 1.4, "distribution": "phong", "roughness": 0.3,
        "enable_refraction": False},
    "plastic": {"type": "plastic", "ior": 1.5, "albedo": [0.6, 0.3, 0.2]},
    "plastic#absorbing": {"type": "plastic", "ior": 1.6, "albedo": 0.7, "thickness": 2.0,
                          "sigma_a": [0.1, 0.2, 0.5]},
    "rough_plastic#ggx": {"type": "rough_plastic", "ior": 1.5, "albedo": 0.5,
                          "distribution": "ggx", "roughness": 0.2},
    "rough_plastic#bitmap": {"type": "rough_plastic", "ior": 1.45, "distribution": "beckmann",
                             "albedo": {"type": "checker", "on_color": [0.8, 0.2, 0.1],
                                        "off_color": [0.1, 0.3, 0.7]},
                             "roughness": "rough.pfm"},
    "rough_conductor#cu": {"type": "rough_conductor", "material": "Cu",
                           "distribution": "beckmann", "roughness": 0.1},
    "rough_conductor#checker": {"type": "rough_conductor", "material": "Au",
                                "distribution": "ggx", "roughness": CHECKER_ROUGH},
}
NAMES = list(SPECS)
TYPES = sorted({n.split("#")[0] for n in NAMES})
TEXTURED = ("rough_conductor", "rough_dielectric", "rough_plastic")


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """Both packages' flatten of one quad scene with the material list
    above; the port's tables carried from its own flatten."""
    import json

    import tungsten_tpu.accel.bvh as jbvh
    from tungsten_tpu.scene.flatten import flatten_scene as jflatten
    from tungsten_tpu.scene.load import load_scene as jload
    from tungsten_tpu_torch.io.imageio import save_pfm
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    d = tmp_path_factory.mktemp("bsdfs")
    r = np.random.default_rng(3)
    save_pfm(str(d / "rough.pfm"), r.uniform(0.05, 0.6, (8, 16, 3)).astype(np.float32))
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
    ts = flatten_scene(load_scene(str(d / "scene.json")), torch.device("cpu"))
    return js, ts


def _close(got, want, rtol=RTOL, mask=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if mask is not None:
        got, want = got[mask], want[mask]
    np.testing.assert_allclose(got, want, rtol=RTOL_ALL, atol=ATOL_ALL)
    within = np.isclose(got, want, rtol=rtol, atol=ATOL)
    assert within.mean() >= 0.999, f"{within.mean():.5f} of elements within rtol {rtol}"


def _inputs(rng, js, ts, names):
    """Seeded lanes over the materials `names`: (mat ids, uv, wi, wo, u2,
    u1) as numpy, and both packages' gathered rows."""
    from tungsten_tpu.models.bsdfs.dispatch import _gather
    from tungsten_tpu_torch.models.bsdfs import dispatch as td

    ids = np.array([NAMES.index(n) for n in names])
    mat = ids[rng.integers(0, len(ids), N)].astype(np.int32)
    uv = rng.uniform(-0.5, 1.5, (N, 2)).astype(np.float32)
    wi, wo = _unit(rng, N), _unit(rng, N)
    u2 = rng.random((N, 2)).astype(np.float32)
    u1 = rng.random(N).astype(np.float32)
    jpre = _gather((js.materials, js.textures), jnp.asarray(mat), jnp.asarray(uv))
    tpre = td.gather(ts.materials, ts.textures, torch.as_tensor(mat.astype(np.int64)),
                     torch.as_tensor(uv))
    return (mat, uv, wi, wo, u2, u1), jpre, tpre


def test_packed_tables_equal(tables):
    """The flattened material rows (type ids, lobes, params, albedo texture
    headers) and the roughness texture kinds are the JAX package's."""
    js, ts = tables
    np.testing.assert_array_equal(ts.materials.gpack2.numpy(), np.asarray(js.materials.gpack2))
    np.testing.assert_array_equal(ts.textures.tpack.numpy(), np.asarray(js.textures.tpack))
    assert ts.materials.rough_kinds == tuple(js.materials.rough_kinds) == (1, 2)
    assert ts.materials.present == tuple(js.materials.present) == (0, 1, 2, 3, 7, 8, 9, 10, 11)


@pytest.mark.parametrize("nonspecular_only", [False, True])
@pytest.mark.parametrize("kind", ["eval", "pdf", "sample"])
@pytest.mark.parametrize("bsdf", TYPES)
def test_bsdf_matches_jax(tables, rng, bsdf, kind, nonspecular_only):
    from tungsten_tpu.models.bsdfs import bsdf_eval, bsdf_pdf, bsdf_sample
    from tungsten_tpu_torch.models.bsdfs import dispatch as td

    js, ts = tables
    names = [n for n in NAMES if n.split("#")[0] == bsdf]
    (mat, uv, wi, wo, u2, u1), jpre, tpre = _inputs(rng, js, ts, names)
    for a, b in zip(tpre, jpre):
        _close(a, b)
    ctx = (js.materials, js.textures)
    J, T = jnp.asarray, torch.as_tensor
    kw = dict(nonspecular_only=nonspecular_only)
    if kind == "eval":
        want = bsdf_eval(ctx, J(mat), J(uv), J(wi), J(wo), pre=jpre, **kw)
        _close(td.bsdf_eval(ts.materials, tpre, T(uv), T(wi), T(wo), textures=ts.textures, **kw),
               want)
    elif kind == "pdf":
        want = bsdf_pdf(ctx, J(mat), J(uv), J(wi), J(wo), pre=jpre, **kw)
        _close(td.bsdf_pdf(ts.materials, tpre, T(uv), T(wi), T(wo), textures=ts.textures, **kw),
               want)
    else:
        want = bsdf_sample(ctx, J(mat), J(uv), J(wi), J(u2), J(u1), pre=jpre, **kw)
        got = td.bsdf_sample(ts.materials, tpre, T(uv), T(wi), T(u2), T(u1),
                             textures=ts.textures, **kw)
        ok = np.asarray(want.valid)
        np.testing.assert_array_equal(got.valid.numpy(), ok)
        np.testing.assert_array_equal(got.lobe.numpy(), np.asarray(want.lobe))
        if ok.any():  # an invalid sample's wo and pdf are never read
            _close(got.wo, want.wo, rtol=1e-4, mask=ok)
            _close(got.pdf, want.pdf, rtol=1e-4, mask=ok)
        _close(got.weight, want.weight, rtol=1e-4)
        if bsdf == "null" or (nonspecular_only and bsdf in ("mirror", "conductor",
                                                             "dielectric")):
            assert not ok.any()  # nothing to sample: no lobes, or dirac ones only
        else:
            assert ok.mean() > 0.2


def test_bsdf_eta_sq_matches_jax(tables, rng):
    """sqr(eta) of the event: eta^2 on refraction through the dielectrics,
    1 on reflection and for every other type."""
    from tungsten_tpu.models.bsdfs.dispatch import bsdf_eta_sq as jeta_sq
    from tungsten_tpu_torch.models.bsdfs.dispatch import bsdf_eta_sq

    js, ts = tables
    (mat, uv, wi, wo, _, _), _, tpre = _inputs(rng, js, ts, NAMES)
    want = np.asarray(jeta_sq((js.materials, js.textures), jnp.asarray(mat), jnp.asarray(uv),
                              jnp.asarray(wi), jnp.asarray(wo)))
    got = bsdf_eta_sq(ts.materials, tpre, torch.as_tensor(wi), torch.as_tensor(wo))
    _close(got, want)
    is_dielectric = np.isin(mat, [NAMES.index(n) for n in NAMES if "dielectric" in n])
    refract = (wi[:, 2] * wo[:, 2] < 0) & is_dielectric
    assert (want[refract] != 1.0).all() and (want[~refract] == 1.0).all()


@pytest.mark.parametrize("ior", [1.5, 1.33, 2.4, 0.8])
def test_compute_diffuse_fresnel_equal(ior):
    from tungsten_tpu.models.bsdfs.plastic import compute_diffuse_fresnel as jdf
    from tungsten_tpu_torch.models.bsdfs.plastic import compute_diffuse_fresnel

    got = compute_diffuse_fresnel(ior)
    assert isinstance(got, float) and got == jdf(ior)


@pytest.mark.parametrize("bsdf", TEXTURED)
def test_textured_roughness_matches_jax(tables, rng, bsdf):
    """resolve_roughness of a textured slot evaluates the texture's first
    channel at uv (and so varies over uv); a scalar slot passes through."""
    from tungsten_tpu.models.bsdfs.common import resolve_roughness as jresolve
    from tungsten_tpu_torch.models.bsdfs.common import resolve_roughness

    js, ts = tables
    textured = [n for n in NAMES if n.split("#")[0] == bsdf and not isinstance(
        SPECS[n]["roughness"], float)]
    assert textured
    slot = {"rough_conductor": 6, "rough_dielectric": 1, "rough_plastic": 6}[bsdf]
    (mat, uv, _, _, _, _), jpre, tpre = _inputs(rng, js, ts, NAMES)
    want = np.asarray(jresolve((js.materials, js.textures), jpre[0][..., slot],
                               jnp.asarray(uv)))
    got = resolve_roughness((ts.materials, ts.textures), tpre[0][..., slot],
                            torch.as_tensor(uv))
    _close(got, want)
    sel = np.isin(mat, [NAMES.index(n) for n in textured])
    assert np.asarray(tpre[0][..., slot])[sel].max() < -1.0  # texture ids, -(id + 2)
    assert 0.04 < want[sel].min() and want[sel].max() < 0.61 and want[sel].std() > 0.05


def _port_table(name):
    """The port's tables of one material, as the flatten builds them."""
    from tungsten_tpu_torch.models.bsdfs import dispatch as td
    from tungsten_tpu_torch.models.textures.textures import TextureBuilder, TextureTable

    tb = TextureBuilder()
    packed = td.pack_materials([SPECS[name]], tb)
    rough = tb.kinds_of(tb.rough_ids)
    tex = tb.build_arrays()
    cpu = torch.device("cpu")
    return (td.MaterialTable.from_arrays(td.build_gpack2(packed, tex["tpack"]), rough, cpu),
            TextureTable.from_arrays(tex["tpack"], tex["data"], tex["data4"], cpu))


def _fixed(n, z=0.6):
    return torch.tensor([np.sqrt(1 - z * z), 0.0, z], dtype=torch.float32).expand(n, 3)


CONSISTENT = [n for n in NAMES if "bitmap" not in n and n.split("#")[0] != "null"]


@pytest.mark.parametrize("name", CONSISTENT)
def test_sample_agrees_with_eval_and_pdf(name):
    """tests/test_bsdfs.py:97 for the port: a non-dirac sample's weight is
    eval / pdf at its direction; E[weight] <= 1 per channel (no energy
    gain); most samples are valid."""
    from tungsten_tpu_torch.models.bsdfs import dispatch as td
    from tungsten_tpu_torch.models.bsdfs.common import Lobes

    mats, texs = _port_table(name)
    n = 1 << 14
    g = torch.Generator().manual_seed(7)
    u2, u1 = torch.rand((n, 2), generator=g), torch.rand(n, generator=g)
    wi = _fixed(n)
    uv = torch.full((n, 2), 0.3)
    pre = td.gather(mats, texs, torch.zeros(n, dtype=torch.int64), uv)
    bs = td.bsdf_sample(mats, pre, uv, wi, u2, u1, textures=texs)
    valid = bs.valid.numpy()
    assert valid.mean() > 0.5, f"{name}: too many invalid samples"
    sel = valid & ((bs.lobe.numpy() & Lobes.SPECULAR) == 0)
    if sel.sum() > 100:
        f = td.bsdf_eval(mats, pre, uv, wi, bs.wo, textures=texs).numpy()
        p = td.bsdf_pdf(mats, pre, uv, wi, bs.wo, textures=texs).numpy()
        w = bs.weight.numpy()
        recon = f[sel] / np.maximum(p[sel, None], 1e-20)
        err = np.abs(recon - w[sel]) / np.maximum(np.abs(w[sel]), 1e-3)
        bad = (err > 0.02).any(axis=-1).mean()
        assert bad < 0.02, f"{name}: weight != eval / pdf on {bad:.1%} of lanes"
    w = np.where(valid[:, None], bs.weight.numpy(), 0.0)
    assert (w.mean(0) <= 1.02).all(), f"{name}: energy gain {w.mean(0)}"


@pytest.mark.parametrize("name", ["plastic", "plastic#absorbing", "rough_plastic#ggx",
                                  "rough_conductor#checker", "rough_dielectric#ggx",
                                  "rough_dielectric#checker"])
def test_pdf_normalization(name):
    """tests/test_bsdfs.py:142 for the port: the pdf integrates (Monte Carlo
    over uniform directions) to the probability of the lobes it covers:
    the upper hemisphere for the reflective types, the whole sphere for the
    rough dielectrics."""
    from tungsten_tpu_torch.models.bsdfs import dispatch as td

    mats, texs = _port_table(name)
    n = 1 << 16
    wo = torch.as_tensor(_unit(np.random.default_rng(5), n))
    sphere = name.startswith("rough_dielectric")
    if not sphere:
        wo[:, 2] = wo[:, 2].abs()
    uv = torch.full((n, 2), 0.1)  # the checkers' rough (0.45) cell: a wide lobe
    pre = td.gather(mats, texs, torch.zeros(n, dtype=torch.int64), uv)
    p = td.bsdf_pdf(mats, pre, uv, _fixed(n), wo, textures=texs).numpy()
    assert np.isfinite(p).all() and (p >= 0).all()
    integral = p.mean() * (4.0 if sphere else 2.0) * np.pi
    assert 0.7 < integral < 1.1, f"{name}: pdf integrates to {integral}"


@pytest.mark.parametrize("bsdf", ["hair", "lambertian_fiber", "rough_wire", "velvet"])
def test_unported_types_raise_naming_themselves(bsdf):
    """A name no package knows raises at pack time, naming the type; the
    fibers, which joined the port with the curves, pack under the JAX
    package's type ids (18-20) with their lobes."""
    from tungsten_tpu.models.bsdfs import dispatch as jd
    from tungsten_tpu.models.textures import TextureBuilder as JTextureBuilder
    from tungsten_tpu_torch.models.bsdfs import dispatch as td
    from tungsten_tpu_torch.models.textures.textures import TextureBuilder

    if bsdf == "velvet":
        with pytest.raises(NotImplementedError, match=f"'{bsdf}' is not ported"):
            td.pack_materials([{"type": bsdf}], TextureBuilder())
        return
    mine = td.pack_materials([{"type": bsdf}], TextureBuilder())
    theirs = jd.pack_materials([{"type": bsdf}], JTextureBuilder())
    np.testing.assert_array_equal(mine["gpack"], np.asarray(theirs.gpack))
    np.testing.assert_array_equal(mine["lobes"], np.asarray(theirs.lobes))
    assert td.type_name(int(mine["gpack"][0, td.N_PARAMS])) == bsdf
