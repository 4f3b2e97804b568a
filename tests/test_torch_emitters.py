"""The port's lights and analytic emitters against the JAX package's, per call.

`small-lights` (tungsten_tpu_torch/synth.py: the `small` scene with an
emissive sphere, an emissive disk with a 30-degree cone, an emissive
cylinder, a constant env, a cap before the sky, the sky (the last env), a
cap after it given by its power, and a point light) is flattened by both
packages on the numpy BVH build: the light table, the SceneMeta light
fields, the cap, point and env tables must be equal (integers and statics
exactly, floats at rtol 1e-6). Every ported function then runs on the JAX
scene carried across with from_arrays and on the JAX scene, on the same
points, directions and random numbers made from a numpy seed: floats within
rtol 1e-5 (plus 1e-6 absolute) on >= 99.9% of the elements, samples
(directions, distances, pdfs of a sampled point) within rtol 1e-4, and
`valid`, the chosen lights and the escape winners equal. A sampled
direction goes through atan2 / acos / sin and cos of a random number, whose
last bits the two frameworks round differently, and a spherical cap's
sample and pdf divide by 1 - cos_max, which cancels (XLA's CPU backend
fuses d * d - r * r into one multiply-add): hence 1e-4 for samples and for
an analytic emitter's direct pdf. The light weights are held to 1e-4 too,
and so is what derives from them (the choice weight and pdfs), as
test_torch_lights.py holds the quad's: a sphere's weight is 2 pi (1 -
cos_t), which cancels, and a disk's is a quad's solid angle (2 pi minus four
arccos).

Then mirrors of the JAX package's own light tests, on the port:
tests/test_chooselight.py (the weights' semantics; point lights
superpose), tests/test_multi_infinite.py (two envs, two caps, the order of
caps and envs at escape, the unsampled winner's escape gate, the last env
masking an earlier one without NEE, two caps superposing) and the cap half
of tests/test_sky_cap.py (the cone gate and the pdf's integral; NEE against
escape-only transport). The renders of `small-lights` and of an unsampled
env against the JAX package's are in test_torch_emitters_render.py.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_host import jax_arrays
from test_torch_lockstep_area import one_torch_thread  # noqa: F401

RTOL, RTOL_SAMPLE, ATOL, BAR = 1e-5, 1e-4, 1e-6, 0.999
RTOL_W = 1e-4  # light weights and what derives from them (module docstring)
N = 4096


@pytest.fixture(scope="module")
def lights(tmp_path_factory):
    """(port scene, JAX scene carried across, JAX scene) of small-lights."""
    import tungsten_tpu.accel.bvh as jbvh
    import tungsten_tpu_torch.accel.bvh as tbvh
    from tungsten_tpu.scene.flatten import flatten_scene as jflatten
    from tungsten_tpu.scene.load import load_scene as jload
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.scene.flatten import flatten_scene, from_arrays
    from tungsten_tpu_torch.scene.load import load_scene

    mp = pytest.MonkeyPatch()
    mp.setattr(jbvh, "_NATIVE", False)
    mp.setattr(tbvh, "_NATIVE", False)
    mp.setattr(jbvh, "_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    path = synth.write_scene(str(tmp_path_factory.mktemp("small-lights")), "small-lights")
    js = jflatten(jload(path))
    cpu = torch.device("cpu")
    out = (flatten_scene(load_scene(path), cpu), from_arrays(jax_arrays(js), js.meta, cpu), js)
    mp.undo()
    return out


def _inputs(scene, seed=3):
    """Points on and around the geometry, unit directions, random numbers,
    random light rows."""
    rng = np.random.default_rng(seed)
    tri = rng.integers(0, scene.tris.v0.shape[0], N)
    b = rng.dirichlet(np.ones(3), N)
    v0, e1, e2 = (x.numpy()[tri] for x in (scene.tris.v0, scene.tris.e1, scene.tris.e2))
    p = v0 + e1 * b[:, 1:2] + e2 * b[:, 2:3] + rng.normal(0, 0.3, (N, 3))
    d = rng.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    return dict(p=f32(p), d=f32(d), u=f32(rng.random(N)), u_tri=f32(rng.random(N)),
                u2=f32(rng.random((N, 2))), li=rng.integers(0, scene.meta.n_lights, N),
                spec=rng.random(N) < 0.3)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _close(mine, ref, label, rtol=RTOL, where=None):
    """Within rtol + ATOL on >= BAR of the elements."""
    mine, ref = np.asarray(mine, np.float64), np.asarray(ref, np.float64)
    if where is not None:
        mine, ref = mine[where], ref[where]
    assert mine.shape == ref.shape, label
    ok = np.isclose(mine, ref, rtol=rtol, atol=ATOL)
    assert ok.mean() >= BAR, f"{label}: {ok.mean():.6f} within rtol {rtol}"


def _equal(mine, ref, label, where=None):
    mine, ref = np.asarray(mine), np.asarray(ref)
    if where is not None:
        mine, ref = mine[where], ref[where]
    np.testing.assert_array_equal(mine, ref, err_msg=label)


def _sample_close(mine, ref, label, where=None):
    """A LightSample: valid equal, and where valid its fields by the sample bar."""
    _equal(mine.valid.numpy(), ref.valid, f"{label} valid", where)
    ok = mine.valid.numpy() if where is None else mine.valid.numpy() & where
    for k in ("d", "dist", "pdf", "radiance"):
        _close(getattr(mine, k).numpy(), getattr(ref, k), f"{label} {k}", RTOL_SAMPLE, ok)


def test_light_table_matches_jax_flatten(lights):
    """The port's flatten gives the JAX light table, meta, caps, points and
    envs: light rows in the JAX order (sphere, disk, cylinder, the two envs,
    the two caps, the point)."""
    from tungsten_tpu_torch.models.primitives.lights import light_kinds
    from tungsten_tpu_torch.scene.flatten import LIGHT_FIELDS, LIGHT_STATICS, SceneMeta

    mine, theirs, js = lights
    for k, dt in LIGHT_FIELDS:
        x, y = getattr(mine.lights, k).numpy(), np.asarray(getattr(js.lights, k))
        assert x.shape == y.shape, k
        if np.issubdtype(dt, np.floating):
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(x, y, err_msg=k)
        np.testing.assert_array_equal(getattr(theirs.lights, k).numpy(), x, err_msg=k)
    for k in LIGHT_STATICS:
        assert getattr(mine.lights, k) == getattr(js.lights, k) == getattr(theirs.lights, k), k
    for f in dataclasses.fields(SceneMeta):
        assert getattr(mine.meta, f.name) == getattr(js.meta, f.name), f.name
    for name in ("tri_light", "shade_pack"):
        np.testing.assert_array_equal(getattr(mine, name).numpy(), np.asarray(getattr(js, name)))
    for table, keys in (("cap", ("dir", "cos_angle", "radiance")), ("point", ("pos", "intensity"))):
        for k in keys:
            np.testing.assert_allclose(getattr(getattr(mine, table), k).numpy(),
                                       np.asarray(getattr(getattr(js, table), k)), rtol=1e-6)
    assert len(mine.envs) == len(theirs.envs) == len(js.envs) == 2
    for e_m, e_t, e_j in zip(mine.envs, theirs.envs, js.envs):
        assert e_m.tex == e_t.tex == int(e_j.tex) and e_m.tex_kind == e_j.tex_kind
        np.testing.assert_allclose(e_m.rot.numpy(), np.asarray(e_j.rot), rtol=1e-6)
        assert e_m.dist.shape == tuple(e_j.dist.shape)
    assert mine.env.tex == mine.envs[-1].tex
    m = mine.meta
    assert light_kinds(mine) == ("sphere", "disk", "cylinder", "env", "env", "cap", "cap",
                                 "point")
    assert mine.lights.apx_kind == ("sphere", "disk", "none", "const", "const", "const",
                                    "const", "point")
    assert m.env_light_idx == (3, 4) and m.cap_light_idx == (5, 6) and m.esc_caps == (1,)
    assert m.point_light_index == 7 and m.has_cap and m.cap_after_env
    assert m.env_const == (True, False) and not m.env_is_constant
    # the disk's 30-degree cone; the analytic prims' shading rows carry their lights
    np.testing.assert_allclose(mine.lights.cone_cos.numpy()[1], np.cos(np.deg2rad(30.0)),
                               rtol=1e-6)
    n_tris = mine.tris.v0.shape[0]
    assert mine.tri_light[n_tris:].tolist() == [0, 1, 2]
    assert mine.lights.has_surface and mine.gbvh is not None


def test_frame_to_global_matches_jax():
    from tungsten_tpu.models.primitives import analytic as ja
    from tungsten_tpu_torch.models.primitives import analytic as ta

    rng = np.random.default_rng(4)
    axis = rng.normal(size=(N, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    axis[:8] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1, 0], [0, -1, 0], [1, 0, 0],
                [0.6, 0, -0.8], [0, 0.6, 0.8]]
    local = rng.normal(size=(N, 3)).astype(np.float32)
    axis = axis.astype(np.float32)
    _close(ta._frame_to_global(_t(axis), _t(local)).numpy(),
           ja._frame_to_global(_j(axis), _j(local)), "_frame_to_global")


def test_analytic_sample_direct_and_pdf_match_jax(lights):
    """sample_direct of the three emitters (every lane to each prim in turn,
    then a random prim a lane), and direct_pdf at the sampled points."""
    from tungsten_tpu.models.primitives import analytic as ja
    from tungsten_tpu_torch.models.primitives import analytic as ta

    _, theirs, js = lights
    x = _inputs(theirs)
    rng = np.random.default_rng(8)
    for label, k in [(f"prim {i}", np.full(N, i)) for i in range(js.ana.n)] + [
            ("mixed", rng.integers(0, js.ana.n, N))]:
        mine = ta.sample_direct(theirs.ana, _t(k), _t(x["p"]), _t(x["u2"]), _t(x["u_tri"]))
        ref = ja.sample_direct(js.ana, _j(k.astype(np.int32)), _j(x["p"]), _j(x["u2"]),
                               _j(x["u_tri"]))
        valid = mine[4].numpy()
        _equal(valid, ref[4], f"{label} valid")
        assert valid.mean() > 0.02, f"{label}: {valid.mean()} valid"  # the disk: its cone
        for i, name in enumerate(("d", "dist", "pdf", "uv")):
            _close(mine[i].numpy(), ref[i], f"{label} {name}", RTOL_SAMPLE, valid)
        hit = x["p"] + np.asarray(ref[0]) * np.asarray(ref[1])[:, None]
        pdf = ta.direct_pdf(theirs.ana, _t(k), _t(x["p"]), _t(hit.astype(np.float32)), mine[0])
        jpdf = ja.direct_pdf(js.ana, _j(k.astype(np.int32)), _j(x["p"]),
                             _j(hit.astype(np.float32)), ref[0])
        _close(pdf.numpy(), jpdf, f"{label} direct_pdf", RTOL_SAMPLE, valid)


def test_light_weights_and_choice_match_jax(lights):
    """_light_weights over every kind (sphere, disk with its cone gate, the
    cylinder's uniform share, const, point), choose_light, light_choice_pdf
    and infinite_winner_choice_pdf."""
    from tungsten_tpu.models.primitives import lights as JL
    from tungsten_tpu_torch.models.primitives import lights as TL

    _, theirs, js = lights
    x = _inputs(theirs)
    w, total = TL._light_weights(theirs, _t(x["p"]))
    jw, jtotal = JL._light_weights(js, _j(x["p"]))
    for i, kind in enumerate(theirs.lights.apx_kind):
        _close(w[i].numpy(), np.asarray(jw)[i], f"weight of light {i} ({kind})", RTOL_W)
    _close(total.numpy(), jtotal, "total", RTOL_W)
    disk = w[1].numpy()
    assert (disk == 0).mean() > 0.1 and (disk > 0).mean() > 0.1  # the cone gate bites
    li, cw = TL.choose_light(theirs, _t(x["u"]), _t(x["p"]))
    jli, jcw = JL.choose_light(js, _j(x["u"]), _j(x["p"]))
    # a random number within 1e-6 of a boundary of the cumulative weights may
    # pick the neighbour in the other framework's sum
    same = li.numpy() == np.asarray(jli)
    assert same.mean() >= BAR
    _close(cw.numpy(), jcw, "choice weight", RTOL_W, same)
    assert set(li.tolist()) == set(range(theirs.meta.n_lights))
    _close(TL.light_choice_pdf(theirs, _t(x["li"]), _t(x["p"])).numpy(),
           JL.light_choice_pdf(js, _j(x["li"].astype(np.int32)), _j(x["p"])), "choice pdf",
           RTOL_W)
    _close(TL.infinite_winner_choice_pdf(theirs, _t(x["d"]), _t(x["p"])).numpy(),
           JL.infinite_winner_choice_pdf(js, _j(x["d"]), _j(x["p"])), "winner choice pdf",
           RTOL_W)


def test_env_functions_match_jax(lights):
    """sample_env_direct per env slot (constant and bitmap), each env's
    direct pdf and the escape winner's radiance."""
    from tungsten_tpu.models.primitives import lights as JL
    from tungsten_tpu_torch.models.primitives import lights as TL

    _, theirs, js = lights
    x = _inputs(theirs)
    for li in theirs.meta.env_light_idx:
        mine = TL.sample_env_direct(theirs, _t(np.full(N, li)), _t(x["u2"]))
        ref = JL.sample_env_direct(js, _j(np.full(N, li, np.int32)), _j(x["u2"]))
        _sample_close(mine, ref, f"env light {li}")
    for s, (env, jenv, const) in enumerate(zip(theirs.envs, js.envs, js.meta.env_const)):
        _close(TL._env_direct_pdf_one(theirs, env, const, _t(x["d"])).numpy(),
               JL._env_direct_pdf_one(js, jenv, const, _j(x["d"])), f"env {s} pdf")
    _close(TL.env_radiance(theirs, _t(x["d"])).numpy(), JL.env_radiance(js, _j(x["d"])),
           "env radiance")


def test_cap_functions_match_jax(lights):
    from tungsten_tpu.models.primitives import lights as JL
    from tungsten_tpu_torch.models.primitives import lights as TL

    _, theirs, js = lights
    x = _inputs(theirs)
    for k in range(theirs.meta.n_caps):
        _equal(TL.cap_in_cone_k(theirs, _t(x["d"]), k).numpy(),
               JL.cap_in_cone_k(js, _j(x["d"]), k), f"cap {k} cone")
        _close(TL.cap_direct_pdf_k(theirs, _t(x["d"]), k).numpy(),
               JL.cap_direct_pdf_k(js, _j(x["d"]), k), f"cap {k} pdf")
    for li in theirs.meta.cap_light_idx:
        mine = TL.sample_cap_direct(theirs, _t(np.full(N, li)), _t(x["u2"]))
        ref = JL.sample_cap_direct(js, _j(np.full(N, li, np.int32)), _j(x["u2"]))
        _sample_close(mine, ref, f"cap light {li}")
        # the sampled directions lie in the cap's cone
        k = theirs.meta.cap_light_idx.index(li)
        assert bool(TL.cap_in_cone_k(theirs, mine.d * 0.9999 + theirs.cap.dir[k] * 1e-4,
                                     k).all())


def test_escape_functions_match_jax(lights):
    """infinite_radiance, the escape gate, the winner's pdf, escape_winner
    and chosen_infinite_eval over two envs and two caps (one masked)."""
    from tungsten_tpu.models.primitives import lights as JL
    from tungsten_tpu_torch.models.primitives import lights as TL

    _, theirs, js = lights
    x = _inputs(theirs)
    d, jd = _t(x["d"]), _j(x["d"])
    _close(TL.infinite_radiance(theirs, d).numpy(), JL.infinite_radiance(js, jd), "radiance")
    _equal(TL.infinite_needs_escape_add(theirs, d, _t(x["spec"])).numpy(),
           JL.infinite_needs_escape_add(js, jd, _j(x["spec"])), "escape gate")
    _close(TL.infinite_winner_pdf(theirs, d).numpy(), JL.infinite_winner_pdf(js, jd),
           "winner pdf")
    wl, e, pdf = TL.escape_winner(theirs, d)
    jwl, je, jpdf = JL.escape_winner(js, jd)
    _equal(wl.numpy(), jwl, "escape winner")
    assert set(wl.tolist()) == {4, 6}  # the sky, or the late cap inside its cone
    _close(e.numpy(), je, "winner radiance")
    _close(pdf.numpy(), jpdf, "winner direct pdf")
    m, e, pdf = TL.chosen_infinite_eval(theirs, _t(x["li"]), d)
    jm, je, jpdf = JL.chosen_infinite_eval(js, _j(x["li"].astype(np.int32)), jd)
    _equal(m.numpy(), jm, "chosen match")
    _close(e.numpy(), je, "chosen radiance")
    _close(pdf.numpy(), jpdf, "chosen pdf")


def test_area_analytic_and_point_sampling_match_jax(lights):
    """sample_area_direct over random light rows (compared where the row is a
    surface light: the analytic emitters), area_direct_pdf at analytic
    hits, and sample_point_direct."""
    from tungsten_tpu.models.primitives import lights as JL
    from tungsten_tpu_torch.models.primitives import lights as TL

    _, theirs, js = lights
    x = _inputs(theirs)
    li = x["li"]
    mine = TL.sample_area_direct(theirs, _t(li), _t(x["p"]), _t(x["u_tri"]), _t(x["u2"]))
    ref = JL.sample_area_direct(js, _j(li.astype(np.int32)), _j(x["p"]), _j(x["u_tri"]),
                                _j(x["u2"]))
    surface = theirs.lights.ana_prim.numpy()[li] >= 0
    assert surface.mean() > 0.2
    _sample_close(mine, ref, "area / analytic", surface)
    n_tris = theirs.tris.v0.shape[0]
    k = np.random.default_rng(5).integers(0, theirs.ana.n, N)
    tri = (n_tris + k).astype(np.int64)
    hit = x["p"] + x["d"] * 1.5
    _close(TL.area_direct_pdf(theirs, _t(tri), _t(x["p"]), _t(hit), _t(x["d"])).numpy(),
           JL.area_direct_pdf(js, _j(tri.astype(np.int32)), _j(x["p"]), _j(hit), _j(x["d"])),
           "area_direct_pdf at analytic hits", RTOL_SAMPLE)  # the sphere's cap pdf
    pt = np.full(N, theirs.meta.point_light_index)
    mine = TL.sample_point_direct(theirs, _t(pt), _t(x["p"]))
    ref = JL.sample_point_direct(js, _j(pt.astype(np.int32)), _j(x["p"]))
    _sample_close(mine, ref, "point")


# ---------------------------------------------------------------------------
# mirrors of tests/test_chooselight.py, test_multi_infinite.py, test_sky_cap.py
# ---------------------------------------------------------------------------

def _flatten(tmp_path, doc, name="scene"):
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    path = os.path.join(str(tmp_path), f"{name}.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return flatten_scene(load_scene(path), torch.device("cpu"))


def _render(scene, spp, seed=0):
    from tungsten_tpu_torch.renderer.render import render_flat

    return render_flat(scene, spp=spp, seed=seed)


def test_chooselight_weights_semantics(tmp_path):
    """test_chooselight.py::test_weights_match_reference_semantics: under the
    bright quad its weight dominates; above the downward-facing quads every
    weight is 0 and nothing is chosen."""
    from tungsten_tpu_torch.models.primitives import lights as TL

    def quad(pos, emission, scale):
        return {"type": "quad", "bsdf": "emit", "emission": emission,
                "transform": {"position": pos, "scale": scale, "rotation": [0, 0, 180]}}

    doc = {"bsdfs": [{"name": "white", "type": "lambert", "albedo": 0.7},
                     {"name": "emit", "type": "null", "albedo": 0.0}],
           "primitives": [{"type": "quad", "bsdf": "white",
                           "transform": {"position": [0, 0, 0], "scale": [12, 1, 12]}},
                          quad([0, 3, 0], 100.0, [1, 1, 1]),
                          *(quad(p, 0.05, [0.5, 1, 0.5])
                            for p in ([5, 3, 5], [-5, 3, 5], [5, 3, -5]))],
           "camera": {"type": "pinhole", "fov": 60, "resolution": [16, 12]},
           "integrator": {"type": "path_tracer", "max_bounces": 3}}
    scene = _flatten(tmp_path, doc)
    assert scene.lights.apx_kind == ("quad",) * 4
    p = torch.tensor([[0.0, 0.5, 0.0], [0.0, 10.0, 0.0]])
    w, total = TL._light_weights(scene, p)
    assert w[0, 0] > 100 * w[1, 0]
    assert torch.all(w[:, 1] == 0.0) and float(total[1]) == 0.0
    li, cw = TL.choose_light(scene, torch.tensor([0.5, 0.5]), p)
    assert int(li[0]) == 0 and float(cw[1]) == 0.0


def _point_doc(points):
    return {"bsdfs": [{"name": "white", "type": "lambert", "albedo": 0.7}],
            "primitives": [{"type": "quad", "bsdf": "white",
                            "transform": {"position": [0, 0, 0], "scale": [8, 1, 8]}}] + points,
            "camera": {"type": "pinhole", "tonemap": "linear", "fov": 60,
                       "resolution": [48, 32],
                       "transform": {"position": [0, 2.5, 5], "look_at": [0, 0, 0],
                                     "up": [0, 1, 0]}},
            "integrator": {"type": "path_tracer", "max_bounces": 2,
                           "enable_light_sampling": True},
            "renderer": {"spp": 32, "spp_step": 32}}


def test_multiple_point_lights_superpose(tmp_path):
    """test_chooselight.py::test_multiple_point_lights_superpose: N point
    lights render as the sum of single-light renders."""
    pa = {"type": "point", "power": 60.0, "transform": {"position": [-1.5, 2.0, 0.5]}}
    pb = {"type": "point", "power": [10.0, 140.0, 25.0],
          "transform": {"position": [2.0, 1.2, -1.0]}}
    img_a, img_b, img_ab = (_render(_flatten(tmp_path, _point_doc(ps), name), 32, seed=5)
                            for ps, name in (([pa], "a"), ([pb], "b"), ([pa, pb], "ab")))
    np.testing.assert_allclose(img_ab, img_a + img_b, rtol=0.2, atol=0.01)
    assert img_a.mean() > 1e-3 and img_b.mean() > 1e-3


def _inf_doc(infs, nee=True, spp=16, max_bounces=6):
    return {"bsdfs": [{"name": "white", "albedo": 0.7, "type": "lambert"}],
            "primitives": list(infs) + [
                {"name": "floor", "transform": {"scale": 4.0}, "type": "quad", "bsdf": "white"},
                {"name": "box", "transform": {"position": [0, 0.3, 0], "scale": 0.6},
                 "type": "cube", "bsdf": "white"}],
            "camera": {"tonemap": "linear", "resolution": [32, 24],
                       "reconstruction_filter": "box",
                       "transform": {"position": [2.2, 1.6, 2.2], "look_at": [0, 0.2, 0],
                                     "up": [0, 1, 0]},
                       "type": "pinhole", "fov": 40},
            "integrator": {"type": "path_tracer", "min_bounces": 0,
                           "max_bounces": max_bounces, "enable_light_sampling": nee,
                           "enable_two_sided_shading": True},
            "renderer": {"spp": spp, "scene_bvh": True}}


def _env(name, emission, sample=True):
    return {"name": name, "type": "infinite_sphere", "emission": emission, "sample": sample}


def _cap(name, rot_x, emission, angle=15.0, sample=True):
    return {"name": name, "type": "infinite_sphere_cap", "emission": emission,
            "transform": {"rotation": [rot_x, 0.0, 0.0]}, "cap_angle": angle, "sample": sample}


def _sphere_dirs(n=2048, seed=0):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return torch.as_tensor(d / np.linalg.norm(d, axis=1, keepdims=True), dtype=torch.float32)


def test_two_envs_flatten_and_escape(tmp_path):
    from tungsten_tpu_torch.models.primitives import lights as TL

    s = _flatten(tmp_path, _inf_doc([_env("a", 0.25), _env("b", 0.75)]))
    assert s.meta.n_envs == 2 and len(s.envs) == 2
    assert sum(1 for i in s.meta.env_light_idx if i >= 0) == 2
    d = _sphere_dirs()
    assert np.allclose(TL.infinite_radiance(s, d).numpy(), 0.75, atol=1e-5)
    wl, e, pdf = TL.escape_winner(s, d)
    assert bool((wl == s.meta.env_light_idx[1]).all())
    assert np.allclose(e.numpy(), 0.75, atol=1e-5)
    assert np.allclose(pdf.numpy(), 1.0 / (4.0 * np.pi), atol=1e-6)


def test_env_nee_samples_each_slot(tmp_path):
    from tungsten_tpu_torch.models.primitives import lights as TL

    s = _flatten(tmp_path, _inf_doc([_env("a", 0.25), _env("b", 0.75)]))
    li_a, li_b = s.meta.env_light_idx
    u2 = torch.tensor([[0.3, 0.6]]).expand(64, 2)
    ls_a = TL.sample_env_direct(s, torch.full((64,), li_a), u2)
    ls_b = TL.sample_env_direct(s, torch.full((64,), li_b), u2)
    assert np.allclose(ls_a.radiance.numpy(), 0.25, atol=1e-5)
    assert np.allclose(ls_b.radiance.numpy(), 0.75, atol=1e-5)


def test_cap_order_and_env_interleave(tmp_path):
    """env A, a cap, env B, a cap listed last: an escape sees the late cap
    inside its cone and env B elsewhere; the early cap never wins."""
    from tungsten_tpu_torch.models.primitives import lights as TL

    s = _flatten(tmp_path, _inf_doc([_env("a", 0.2), _cap("early", 40.0, 9.0),
                                     _env("b", 0.8), _cap("late", 0.0, 5.0, angle=20.0)]))
    assert s.meta.n_caps == 2 and s.meta.esc_caps == (1,)
    d = _sphere_dirs()
    rad = TL.infinite_radiance(s, d).numpy()
    in_late = TL.cap_in_cone_k(s, d, 1).numpy()
    assert in_late.any() and np.allclose(rad[in_late], 5.0, atol=1e-4)
    assert np.allclose(rad[~in_late], 0.8, atol=1e-4)
    wl = TL.escape_winner(s, d)[0].numpy()
    assert np.all(wl[in_late] == s.meta.cap_light_idx[1])
    assert np.all(wl[~in_late] == s.meta.env_light_idx[1])


def test_unsamplable_winner_escape_gate(tmp_path):
    """An unsampled last env: escape_winner reports -2 (it never matches a
    chosen light) and pdf 0, but its radiance reaches escaping rays, and
    the escape gate adds it on every lane."""
    from tungsten_tpu_torch.models.primitives import lights as TL

    s = _flatten(tmp_path, _inf_doc([_env("a", 0.3), _env("b", 0.7, sample=False)]))
    assert s.meta.env_light_idx[1] == -1 and s.meta.n_lights == 1
    d = _sphere_dirs(256)
    wl, _, pdf = TL.escape_winner(s, d)
    assert bool((wl == -2).all()) and bool((pdf == 0).all())
    assert np.allclose(TL.infinite_radiance(s, d).numpy(), 0.7, atol=1e-5)
    assert bool(TL.infinite_needs_escape_add(s, d, torch.zeros(256, dtype=torch.bool)).all())


def test_last_env_masks_earlier_without_nee(tmp_path):
    """With light sampling off an earlier env changes nothing: the last env
    masks it in every direction."""
    a = _render(_flatten(tmp_path, _inf_doc([_env("a", 0.4), _env("b", 0.6)], nee=False),
                         "ab"), 8)
    b = _render(_flatten(tmp_path, _inf_doc([_env("b", 0.6)], nee=False), "b"), 8)
    assert np.allclose(a, b, atol=1e-4), float(np.abs(a - b).max())


def test_two_caps_superpose(tmp_path):
    """Two samplable caps with disjoint cones: render(A + B) = render(A) +
    render(B) in expectation (5%)."""
    ca, cb = _cap("sunA", 30.0, 40.0), _cap("sunB", 70.0, 25.0)
    means = [float(_render(_flatten(tmp_path, _inf_doc(caps, spp=128), name), 128).mean())
             for caps, name in (([ca, cb], "ab"), ([ca], "a"), ([cb], "b"))]
    lhs, rhs = means[0], means[1] + means[2]
    assert abs(lhs - rhs) / max(rhs, 1e-9) < 0.05, (lhs, rhs)


def test_cap_cone_gating(tmp_path):
    """test_sky_cap.py::test_cap_cone_gating: a cap emits only inside its
    cone, and its pdf integrates to 1 over the sphere."""
    from tungsten_tpu_torch.models.primitives import lights as TL

    cap = {"name": "sun", "transform": {"rotation": [40.0, 10.0, 0.0]}, "emission": 50,
           "type": "infinite_sphere_cap", "sample": True, "cap_angle": 12}
    s = _flatten(tmp_path, _inf_doc([cap], max_bounces=8))
    d = _sphere_dirs(4096)
    rad = TL.infinite_radiance(s, d).numpy()
    in_cone = d.numpy() @ s.cap.dir[0].numpy() >= float(s.cap.cos_angle[0])
    assert np.all((rad.max(-1) > 0) == in_cone)
    integral = TL.cap_direct_pdf_k(s, d, 0).numpy().mean() * 4.0 * np.pi
    assert abs(integral - 1.0) < 0.15, integral


def test_cap_nee_matches_escape(tmp_path):
    """test_sky_cap.py::test_nee_matches_escape (the cap): a sampled cap's
    NEE estimator and an unsampled cap's escape-only estimator agree (8%)."""
    cap = {"name": "sun", "transform": {"rotation": [40.0, 10.0, 0.0]}, "emission": 50,
           "type": "infinite_sphere_cap", "cap_angle": 12}
    a, b = (_render(_flatten(tmp_path, _inf_doc([dict(cap, sample=smp)], max_bounces=8),
                             f"s{smp}"), 196).mean() for smp in (True, False))
    assert abs(float(a) / max(float(b), 1e-9) - 1.0) < 0.08, (a, b)
