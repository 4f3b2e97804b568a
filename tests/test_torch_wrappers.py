"""The port's remaining surface BSDFs against the JAX package: the wrappers
(smooth_coat, rough_coat, mixed, transparency) with their one-level nesting,
and oren_nayar, phong, diffuse_transmission, thinsheet and forward.

Both packages flatten two scenes whose material lists hold every new type
(several variants each: textured coat roughness, ratio, alpha, thickness and
Oren-Nayar roughness from checkers, absorbing coats, thin-film interference,
substrates of several families). The first list has no `mixed`, so its
flatten carries `gpack3` (each row with its substrate's row beside it); the
second adds the mixed materials, so its flatten has none. The packed rows
must be equal. Then, on the same seeded numpy inputs, each type's eval, pdf
and sample through the port's dispatch against the JAX dispatch, with
nonspecular_only False and True, in three forms of the nesting: the
substrate row stashed from a `gpack3` gather (the regen tracer's form),
gathered by the nested call from `gpack3`, and gathered from `gpack2` (the
mixed scene). The bars are test_torch_bsdfs.py's: >= 99.9% of the elements
within rtol 1e-5 (eval, pdf) or 1e-4 (sample), every element within rtol
1e-3; `valid` and `lobe` equal.

Then the lobe masks (`lobes_for` through the nesting), the refusals of
coat-on-coat and deeper nesting as the JAX package raises them, and the
port's own sample against its eval / pdf and its pdf's normalization on
tests/test_bsdfs.py's SPECS for the new types.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_bsdfs import _close, _fixed, _unit
from test_torch_lockstep_area import one_torch_thread  # noqa: F401

N = 4000  # lanes per eval / pdf case, as test_torch_bsdfs.py
# lanes per sample case: 4x, since a wrapper's valid samples split over its
# variants, and a coat amplifies a one-ulp difference of its substrate's
# sample near the critical angle (on 64,000 lanes 0.016% of smooth_coat's
# sample elements lie outside rtol 1e-4: on 4,000, whose ~760 valid
# nonspecular samples hold ~2,300 elements, the 0.1% share is 2 elements)
N_SAMPLE = 16000

CHECKER = {"type": "checker", "on_color": 0.8, "off_color": 0.2, "res_u": 6, "res_v": 3}
ROUGH = {"type": "checker", "on_color": 0.05, "off_color": 0.45, "res_u": 5, "res_v": 4}
# substrates and bases, referenced by name (plain types, no wrapper)
BASES = {
    "sub_lambert": {"type": "lambert", "albedo": [0.7, 0.5, 0.3]},
    "sub_cu": {"type": "rough_conductor", "material": "Cu", "distribution": "beckmann",
               "roughness": 0.1},
    "sub_plastic": {"type": "rough_plastic", "ior": 1.5, "albedo": 0.5, "roughness": 0.2},
    "sub_glass": {"type": "dielectric", "ior": 1.5},
    "sub_phong": {"type": "phong", "albedo": 0.8, "exponent": 30, "diffuse_ratio": 0.3},
    "sub_mirror": {"type": "mirror"},
}
# name -> spec; the name's prefix up to "#" is the BSDF type
PLAIN = {
    "oren_nayar": {"type": "oren_nayar", "albedo": 0.8, "roughness": 0.4},
    "oren_nayar#checker": {"type": "oren_nayar", "albedo": [0.8, 0.6, 0.4],
                           "roughness": {"type": "checker", "on_color": 0.7,
                                         "off_color": 0.1}},
    "phong": {"type": "phong", "albedo": 0.8, "exponent": 30, "diffuse_ratio": 0.3},
    "phong#sharp": {"type": "phong", "albedo": [0.9, 0.7, 0.5], "exponent": 400,
                    "diffuse_ratio": 0.05},
    "diffuse_transmission": {"type": "diffuse_transmission", "albedo": 0.8,
                             "transmittance": 0.4},
    "thinsheet": {"type": "thinsheet", "ior": 1.5},
    "thinsheet#interference": {"type": "thinsheet", "ior": 1.33, "enable_interference": True,
                               "thickness": {"type": "checker", "on_color": 1.2,
                                             "off_color": 0.2}},
    "thinsheet#absorbing": {"type": "thinsheet", "ior": 1.6, "thickness": 0.8,
                            "sigma_a": [0.2, 0.5, 1.0]},
    "forward": {"type": "forward"},
    "smooth_coat#cu": {"type": "smooth_coat", "ior": 1.7, "thickness": 5,
                       "sigma_a": [0.1, 0.2, 0.5], "substrate": "sub_cu"},
    "smooth_coat#lambert": {"type": "smooth_coat", "ior": 1.5, "substrate": "sub_lambert"},
    "smooth_coat#glass": {"type": "smooth_coat", "ior": 1.3, "substrate": "sub_glass"},
    "rough_coat#lambert": {"type": "rough_coat", "ior": 1.3, "thickness": 1, "sigma_a": 0.0,
                           "roughness": 0.2, "distribution": "ggx",
                           "substrate": "sub_lambert"},
    "rough_coat#checker": {"type": "rough_coat", "ior": 1.5, "thickness": 2,
                           "sigma_a": [0.3, 0.1, 0.05], "roughness": ROUGH,
                           "distribution": "beckmann", "substrate": "sub_plastic"},
    "transparency": {"type": "transparency", "alpha": 0.3, "base": "sub_lambert"},
    "transparency#checker": {"type": "transparency", "alpha": CHECKER, "base": "sub_phong"},
    "transparency#mirror": {"type": "transparency", "alpha": 0.6, "base": "sub_mirror"},
}
MIXED = {
    "mixed": {"type": "mixed", "albedo": 1.0, "ratio": 0.4, "bsdf0": "sub_lambert",
              "bsdf1": "sub_phong"},
    "mixed#checker": {"type": "mixed", "albedo": [0.9, 0.8, 0.7], "ratio": CHECKER,
                      "bsdf0": "sub_cu", "bsdf1": "sub_lambert"},
    "mixed#specular": {"type": "mixed", "ratio": 0.5, "bsdf0": "sub_mirror",
                       "bsdf1": "sub_plastic"},
}
TABLES = {"gpack3": {**BASES, **PLAIN}, "gpack2": {**BASES, **PLAIN, **MIXED}}
NEW_TYPES = ("smooth_coat", "oren_nayar", "phong", "thinsheet", "transparency", "forward",
             "mixed", "diffuse_transmission", "rough_coat")
# the three forms of the nesting: (table, stash the substrate rows)
FORMS = {"gpack3_stashed": ("gpack3", True), "gpack3_gathered": ("gpack3", False),
         "gpack2": ("gpack2", False)}


def _flatten_both(d, specs, mp, cache):
    """The JAX and the port flatten of a quad scene with the material list
    `specs`."""
    import json

    import tungsten_tpu.accel.bvh as jbvh
    from tungsten_tpu.scene.flatten import flatten_scene as jflatten
    from tungsten_tpu.scene.load import load_scene as jload
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    doc = {
        "bsdfs": [dict(spec, name=name) for name, spec in specs.items()],
        "primitives": [{"type": "quad", "bsdf": "sub_lambert"}],
        "camera": {"resolution": [8, 8],
                   "transform": {"position": [0, 2, 0], "look_at": [0, 0, 0], "up": [0, 0, 1]}},
    }
    with open(d / "scene.json", "w") as f:
        json.dump(doc, f)
    mp.setattr(jbvh, "_CACHE_DIR", cache)
    js = jflatten(jload(str(d / "scene.json")))
    ts = flatten_scene(load_scene(str(d / "scene.json")), torch.device("cpu"))
    return js, ts


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """{table name: (JAX flatten, port flatten, material names)}."""
    mp = pytest.MonkeyPatch()
    cache = str(tmp_path_factory.mktemp("bvh_cache"))
    out = {}
    for key, specs in TABLES.items():
        js, ts = _flatten_both(tmp_path_factory.mktemp(key), specs, mp, cache)
        out[key] = (js, ts, list(specs))
    mp.undo()
    return out


def test_packed_tables_equal(tables):
    """The dispatch rows, the substrate rows (gpack3 where no mixed is
    present, none where one is), the texture table and has_forward are the
    JAX package's."""
    for key, (js, ts, names) in tables.items():
        np.testing.assert_array_equal(ts.materials.gpack2.numpy(),
                                      np.asarray(js.materials.gpack2))
        np.testing.assert_array_equal(ts.textures.tpack.numpy(), np.asarray(js.textures.tpack))
        assert ts.materials.present == tuple(js.materials.present)
        assert ts.meta.has_forward and js.meta.has_forward
        if key == "gpack3":
            np.testing.assert_array_equal(ts.materials.gpack3.numpy(),
                                          np.asarray(js.materials.gpack3))
        else:
            assert ts.materials.gpack3 is None and js.materials.gpack3 is None
    assert set(tables["gpack2"][1].materials.present) >= {4, 5, 6, 12, 13, 14, 15, 16, 17}


def test_lobes_through_the_nesting(tables):
    """lobes_for: a wrapper's mask is its own lobe or'ed with its
    substrates' (dispatch.py:150-160)."""
    from tungsten_tpu_torch.models.bsdfs.common import Lobes
    from tungsten_tpu_torch.models.bsdfs.dispatch import N_PARAMS

    js, ts, names = tables["gpack2"]
    lobes = dict(zip(names, ts.materials.gpack2[:, N_PARAMS + 2].long().tolist()))
    np.testing.assert_array_equal(ts.materials.gpack2[:, N_PARAMS + 2].numpy(),
                                  np.asarray(js.materials.lobes))
    assert lobes["smooth_coat#cu"] == Lobes.SPECULAR_R | Lobes.GLOSSY_R
    assert lobes["rough_coat#checker"] == Lobes.GLOSSY_R | lobes["sub_plastic"]
    assert lobes["transparency#checker"] == Lobes.FORWARD | Lobes.GLOSSY_R | Lobes.DIFFUSE_R
    assert lobes["mixed#specular"] == Lobes.SPECULAR_R | lobes["sub_plastic"]
    assert lobes["thinsheet"] == Lobes.SPECULAR_R | Lobes.FORWARD
    assert lobes["forward"] == Lobes.FORWARD


@pytest.mark.parametrize("chain", ["coat_on_coat", "mixed_of_coat", "three_levels"])
def test_nesting_refusals_match_jax(chain):
    """A coat or mixed over a wrapper raises at pack time in both packages,
    with the same message; a chain three levels deep (a transparency's
    base, which that check does not read, a mixed over a coat) raises the
    depth check's."""
    from tungsten_tpu.models.bsdfs.dispatch import pack_materials as jpack
    from tungsten_tpu.models.textures import TextureBuilder as JBuilder
    from tungsten_tpu.scene.load import parse_scene as jparse
    from tungsten_tpu_torch.models.bsdfs.dispatch import pack_materials
    from tungsten_tpu_torch.models.textures.textures import TextureBuilder
    from tungsten_tpu_torch.scene.load import parse_scene

    lam = {"type": "lambert"}
    coat = {"type": "smooth_coat", "substrate": lam}
    spec = {"coat_on_coat": {"type": "rough_coat", "substrate": coat},
            "mixed_of_coat": {"type": "mixed", "bsdf0": lam, "bsdf1": coat},
            "three_levels": {"type": "transparency",
                             "base": {"type": "mixed", "bsdf0": coat, "bsdf1": lam}}}[chain]
    raw = {"bsdfs": [dict(spec, name="m")], "primitives": [], "camera": {}}
    with pytest.raises(NotImplementedError) as want:
        jpack(jparse(raw, path="/tmp/x.json").bsdfs, JBuilder())
    with pytest.raises(NotImplementedError) as got:
        pack_materials(parse_scene(raw, path="/tmp/x.json").bsdfs, TextureBuilder())
    assert str(got.value) == str(want.value) == (
        "bsdf nesting deeper than one level" if chain == "three_levels"
        else "nested wrapper bsdfs (coat-on-coat)")


def _inputs(rng, js, ts, names, sel, n=N):
    """Seeded lanes over the materials `sel`: (mat ids, uv, wi, wo, u2, u1)
    as numpy, and both packages' gathered rows."""
    from tungsten_tpu.models.bsdfs.dispatch import _gather
    from tungsten_tpu_torch.models.bsdfs import dispatch as td

    ids = np.array([names.index(s) for s in sel])
    mat = ids[rng.integers(0, len(ids), n)].astype(np.int32)
    uv = rng.uniform(-0.5, 1.5, (n, 2)).astype(np.float32)
    wi, wo = _unit(rng, n), _unit(rng, n)
    u2 = rng.random((n, 2)).astype(np.float32)
    u1 = rng.random(n).astype(np.float32)
    jpre = _gather((js.materials, js.textures), jnp.asarray(mat), jnp.asarray(uv))
    tpre = td.gather(ts.materials, ts.textures, torch.as_tensor(mat.astype(np.int64)),
                     torch.as_tensor(uv))
    return (mat, uv, wi, wo, u2, u1), jpre, tpre


def _check_rows(tpre, jpre):
    """The gathered rows, and with gpack3 the substrate's, agree."""
    assert len(tpre) == len(jpre)
    for a, b in zip(tpre[:4], jpre[:4]):
        _close(a, b)
    if len(tpre) > 4:
        _check_rows(tpre[4], jpre[4])


CASES = [(t, f) for t in NEW_TYPES for f in FORMS if t != "mixed" or f == "gpack2"]


@pytest.mark.parametrize("nonspecular_only", [False, True])
@pytest.mark.parametrize("kind", ["eval", "pdf", "sample"])
@pytest.mark.parametrize("bsdf,form", CASES)
def test_bsdf_matches_jax(tables, rng, bsdf, form, kind, nonspecular_only):
    from tungsten_tpu.models.bsdfs import bsdf_eval, bsdf_pdf, bsdf_sample
    from tungsten_tpu_torch.models.bsdfs import dispatch as td

    key, stash = FORMS[form]
    js, ts, names = tables[key]
    sel = [n for n in names if n.split("#")[0] == bsdf]
    (mat, uv, wi, wo, u2, u1), jpre, tpre = _inputs(rng, js, ts, names, sel,
                                                    N_SAMPLE if kind == "sample" else N)
    _check_rows(tpre, jpre)
    assert (len(tpre) == 5) == (key == "gpack3")
    jmats, tmats = js.materials, ts.materials
    if stash:  # the regen tracer's form
        jmats, jpre = jmats.replace(sub_pre=jpre[4]), jpre[:4]
        tmats, tpre = td.stash_substrate(tmats, tpre)
        assert tmats.sub_pre is not None and len(tpre) == 4
    ctx = (jmats, js.textures)
    J, T = jnp.asarray, torch.as_tensor
    kw = dict(nonspecular_only=nonspecular_only)
    if kind == "eval":
        want = bsdf_eval(ctx, J(mat), J(uv), J(wi), J(wo), pre=jpre, **kw)
        _close(td.bsdf_eval(tmats, tpre, T(uv), T(wi), T(wo), textures=ts.textures, **kw), want)
    elif kind == "pdf":
        want = bsdf_pdf(ctx, J(mat), J(uv), J(wi), J(wo), pre=jpre, **kw)
        _close(td.bsdf_pdf(tmats, tpre, T(uv), T(wi), T(wo), textures=ts.textures, **kw), want)
    else:
        want = bsdf_sample(ctx, J(mat), J(uv), J(wi), J(u2), J(u1), pre=jpre, **kw)
        got = td.bsdf_sample(tmats, tpre, T(uv), T(wi), T(u2), T(u1), textures=ts.textures,
                             **kw)
        ok = np.asarray(want.valid)
        np.testing.assert_array_equal(got.valid.numpy(), ok)
        np.testing.assert_array_equal(got.lobe.numpy(), np.asarray(want.lobe))
        if ok.any():  # an invalid sample's wo and pdf are never read
            _close(got.wo, want.wo, rtol=1e-4, mask=ok)
            _close(got.pdf, want.pdf, rtol=1e-4, mask=ok)
        _close(got.weight, want.weight, rtol=1e-4)
        if bsdf == "forward" or (bsdf == "thinsheet" and nonspecular_only):
            assert not ok.any()  # a forward lobe or a dirac one only
        else:  # half the lanes come from below (wi.z < 0): no sample
            assert ok.mean() > 0.15


# tests/test_bsdfs.py's SPECS for the new types, nested references inline
SELF_SPECS = {
    "oren_nayar": {"type": "oren_nayar", "albedo": 0.8, "roughness": 0.4},
    "phong": {"type": "phong", "albedo": 0.8, "exponent": 30, "diffuse_ratio": 0.3},
    "diffuse_transmission": {"type": "diffuse_transmission", "albedo": 0.8,
                             "transmittance": 0.4},
    "smooth_coat": {
        "type": "smooth_coat", "ior": 1.7, "thickness": 5, "sigma_a": [0.1, 0.2, 0.5],
        "substrate": {"type": "rough_conductor", "albedo": 1.0, "material": "Cu",
                      "distribution": "beckmann", "roughness": 0.1}},
    "rough_coat": {
        "type": "rough_coat", "ior": 1.3, "thickness": 1, "sigma_a": 0.0, "roughness": 0.2,
        "distribution": "ggx", "substrate": {"type": "lambert", "albedo": 0.7}},
    "mixed": {
        "type": "mixed", "albedo": 1.0, "ratio": 0.4,
        "bsdf0": {"type": "lambert", "albedo": 0.9},
        "bsdf1": {"type": "oren_nayar", "albedo": 0.5, "roughness": 0.3}},
    "mixed_textured_ratio": {
        "type": "mixed", "albedo": 1.0,
        "ratio": {"type": "checker", "on_color": 0.8, "off_color": 0.2},
        "bsdf0": {"type": "lambert", "albedo": 0.9},
        "bsdf1": {"type": "oren_nayar", "albedo": 0.5, "roughness": 0.3}},
    "oren_nayar_textured_roughness": {
        "type": "oren_nayar", "albedo": 0.8,
        "roughness": {"type": "checker", "on_color": 0.7, "off_color": 0.1}},
}


def _port_table(spec):
    """The port's tables of one material and its inline substrates, as the
    flatten builds them (gpack3 where it would)."""
    from tungsten_tpu_torch.models.bsdfs import dispatch as td
    from tungsten_tpu_torch.models.textures.textures import TextureBuilder, TextureTable
    from tungsten_tpu_torch.scene.load import parse_scene

    doc = parse_scene({"bsdfs": [dict(spec, name="m")], "primitives": [], "camera": {}},
                      path="/tmp/x.json")
    tb = TextureBuilder()
    packed = td.pack_materials(doc.bsdfs, tb)
    rough = tb.kinds_of(tb.rough_ids)
    tex = tb.build_arrays()
    g2 = td.build_gpack2(packed, tex["tpack"])
    cpu = torch.device("cpu")
    return (td.MaterialTable.from_arrays(g2, rough, cpu, td.build_gpack3(packed, g2)),
            TextureTable.from_arrays(tex["tpack"], tex["data"], tex["data4"], cpu))


@pytest.mark.parametrize("name", sorted(SELF_SPECS))
def test_sample_agrees_with_eval_and_pdf(name):
    """tests/test_bsdfs.py:97 for the port: a non-dirac sample's weight is
    eval / pdf at its direction; E[weight] <= 1 per channel; most samples
    are valid."""
    from tungsten_tpu_torch.models.bsdfs import dispatch as td
    from tungsten_tpu_torch.models.bsdfs.common import Lobes

    mats, texs = _port_table(SELF_SPECS[name])
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
    assert sel.sum() > 100
    f = td.bsdf_eval(mats, pre, uv, wi, bs.wo, textures=texs).numpy()
    p = td.bsdf_pdf(mats, pre, uv, wi, bs.wo, textures=texs).numpy()
    w = bs.weight.numpy()
    recon = f[sel] / np.maximum(p[sel, None], 1e-20)
    err = np.abs(recon - w[sel]) / np.maximum(np.abs(w[sel]), 1e-3)
    bad = (err > 0.02).any(axis=-1).mean()
    assert bad < 0.02, f"{name}: weight != eval / pdf on {bad:.1%} of lanes"
    w = np.where(valid[:, None], w, 0.0)
    assert (w.mean(0) <= 1.02).all(), f"{name}: energy gain {w.mean(0)}"


@pytest.mark.parametrize("name", ["oren_nayar", "phong", "oren_nayar_textured_roughness",
                                  "mixed", "mixed_textured_ratio"])
def test_pdf_normalization(name):
    """tests/test_bsdfs.py:142 for the port: the pdf integrates over the
    upper hemisphere (Monte Carlo over uniform directions) to the
    probability of the lobes it covers."""
    from tungsten_tpu_torch.models.bsdfs import dispatch as td

    mats, texs = _port_table(SELF_SPECS[name])
    n = 1 << 16
    wo = torch.as_tensor(_unit(np.random.default_rng(5), n))
    wo[:, 2] = wo[:, 2].abs()
    uv = torch.full((n, 2), 0.3)
    pre = td.gather(mats, texs, torch.zeros(n, dtype=torch.int64), uv)
    p = td.bsdf_pdf(mats, pre, uv, _fixed(n), wo, textures=texs).numpy()
    assert np.isfinite(p).all() and (p >= 0).all()
    integral = p.mean() * 2.0 * np.pi
    assert 0.7 < integral < 1.1, f"{name}: pdf integrates to {integral}"


def test_textured_parameters_vary_over_uv():
    """The textured ratio, Oren-Nayar roughness, thinsheet thickness and
    transparency alpha are evaluated per hit: each result varies over uv
    (tests/test_bsdfs.py:168)."""
    from tungsten_tpu_torch.models.bsdfs import dispatch as td

    n = 256
    uv = torch.stack([torch.linspace(0.0, 1.0, n), torch.full((n,), 0.26)], -1)
    wi = _fixed(n)
    wo = torch.tensor([-0.3, 0.1, 0.95]).expand(n, 3) / np.sqrt(0.3**2 + 0.1**2 + 0.95**2)
    specs = {**SELF_SPECS, **{k: v for k, v in PLAIN.items() if "#" in k}}
    for name in ("mixed_textured_ratio", "oren_nayar_textured_roughness",
                 "thinsheet#interference", "transparency#checker"):
        spec = dict(specs[name])
        if spec["type"] == "transparency":
            spec["base"] = {"type": "lambert"}
        mats, texs = _port_table(spec)
        pre = td.gather(mats, texs, torch.zeros(n, dtype=torch.int64), uv)
        if spec["type"] in ("thinsheet", "transparency"):
            val = td.forward_transparency(mats, pre, uv, wi, texs)
        else:
            val = td.bsdf_eval(mats, pre, uv, wi, wo, textures=texs)
        assert torch.isfinite(val).all() and val.std() > 1e-3, name
