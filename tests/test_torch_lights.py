"""The port's light table and light functions against the JAX package's.

`small-area` (the `small` scene plus an emissive quad and an emissive
64-triangle mesh, the sky kept) and `small-box` (a closed box lit by one
emissive quad, no env light) are flattened by both packages; the port's light
table must equal the JAX flatten's field by field (integers and statics
exactly, floats at rtol 1e-6). The light functions then run on the JAX scene
carried across with from_arrays, on the same points, directions and random
numbers made from a numpy seed: integers (the chosen light, validity) must be
equal, floats allclose(rtol 1e-5, atol 1e-6). The quad's light weight is
held to rtol 1e-4, and so is what derives from it (choice weight, choice
pdf): its solid angle is 2 pi minus a sum of four arccos, which cancels, and
an arccos near +-1 magnifies the rounding of its argument, which the two
frameworks' cross products round differently (2.5e-5 measured on 0.06% of
the points). A light choice whose random
number lands within 1e-6 of a boundary of the cumulative weights may differ
between the two frameworks' sums; such lanes are counted and must stay
under 0.1%. The sky's radiance at a direction is a bilinear bitmap lookup at
a uv that comes out of atan2 and acos; next to the sun blob the texture's
gradient magnifies the uv's rounding, so it is held to 1e-5 on >= 99.9% of
the lanes and to rtol 1e-3 on all.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_host import jax_arrays

RTOL, ATOL = 1e-5, 1e-6
RTOL_W = 1e-4  # quad solid-angle weights and what derives from them
N = 4096


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """{size: (port scene, JAX scene carried across, JAX scene)}."""
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
    cpu = torch.device("cpu")
    out = {}
    for size in ("small-area", "small-box"):
        path = synth.write_scene(str(tmp_path_factory.mktemp(size)), size)
        js = jflatten(jload(path))
        out[size] = (flatten_scene(load_scene(path), cpu),
                     from_arrays(jax_arrays(js), js.meta, cpu), js)
    mp.undo()
    return out


@pytest.mark.parametrize("size", ["small-area", "small-box"])
def test_light_table_matches_jax_flatten(scenes, size):
    from tungsten_tpu_torch.scene.flatten import LIGHT_FIELDS, LIGHT_STATICS, SceneMeta

    mine, theirs, js = scenes[size]
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
    for name in ("tri_light", "tri_ng", "tri_uv0", "tri_uv1", "tri_uv2", "shade_pack"):
        x, y = getattr(mine, name).numpy(), np.asarray(getattr(js, name))
        assert x.shape == y.shape, name
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=0, err_msg=name)
    # the light id rides in the last column of the packed shading row
    np.testing.assert_array_equal(mine.shade_pack[:, 19].numpy(), mine.tri_light.numpy())
    for f in dataclasses.fields(SceneMeta):
        assert getattr(mine.meta, f.name) == getattr(js.meta, f.name), f.name
    if size == "small-area":  # quad, mesh, env: in primitive order, the env last
        assert mine.meta.n_lights == 3 and mine.meta.env_light_idx == (2,)
        assert mine.lights.apx_kind == ("quad", "none", "const") and mine.lights.has_surface
        assert mine.lights.count.tolist() == [2, 64, 0] and mine.lights.max_count == 64
        assert set(mine.tri_light.unique().tolist()) == {-1, 0, 1}
    else:  # one quad, no env
        assert mine.meta.n_lights == 1 and not mine.meta.has_env
        assert mine.meta.env_light_idx == () and mine.meta.env_light_index == -1
        assert mine.lights.apx_kind == ("quad",)


def _inputs(scene, seed=11):
    """Shading points on and around the geometry, directions, random numbers."""
    rng = np.random.default_rng(seed)
    tri = rng.integers(0, scene.tris.v0.shape[0], N)
    b = rng.dirichlet(np.ones(3), N).astype(np.float32)
    v0, e1, e2 = (x.numpy()[tri] for x in (scene.tris.v0, scene.tris.e1, scene.tris.e2))
    p = v0 + e1 * b[:, 1:2] + e2 * b[:, 2:3] + rng.normal(0, 0.05, (N, 3))
    d = rng.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return dict(p=p.astype(np.float32), d=d.astype(np.float32), tri=tri.astype(np.int32),
                u=rng.random(N).astype(np.float32), u_tri=rng.random(N).astype(np.float32),
                u2=rng.random((N, 2)).astype(np.float32),
                t=rng.uniform(0.1, 5.0, N).astype(np.float32))


def _close(mine, ref, label, where=None, rtol=RTOL):
    mine, ref = np.asarray(mine), np.asarray(ref)
    if where is not None:
        mine, ref = mine[where], ref[where]
    np.testing.assert_allclose(mine, ref, rtol=rtol, atol=ATOL, err_msg=label)


def _close_most(mine, ref, label):
    """The bitmap-lookup bar: >= 99.9% of rows within (RTOL, ATOL), all within 1e-3."""
    mine, ref = np.asarray(mine), np.asarray(ref)
    ok = np.isclose(mine, ref, rtol=RTOL, atol=ATOL).reshape(len(mine), -1).all(-1)
    assert ok.mean() >= 0.999, f"{label}: {ok.mean():.4%} of lanes within rtol {RTOL}"
    np.testing.assert_allclose(mine, ref, rtol=1e-3, atol=ATOL, err_msg=label)


@pytest.mark.parametrize("size", ["small-area", "small-box"])
def test_light_choice_matches_jax(scenes, size):
    from tungsten_tpu.models.primitives import lights as JL
    from tungsten_tpu_torch.models.primitives import lights as TL

    _, scene, js = scenes[size]
    x = _inputs(scene)
    p_t, u_t = torch.as_tensor(x["p"]), torch.as_tensor(x["u"])
    if scene.meta.n_lights > 1:
        w_t, tot_t = TL._light_weights(scene, p_t)
        w_j, tot_j = JL._light_weights(js, jnp.asarray(x["p"]))
        _close(w_t, w_j, "_light_weights", rtol=RTOL_W)
        _close(tot_t, tot_j, "_light_weights total", rtol=RTOL_W)
        assert (np.asarray(w_j)[0] == 0).any() and (np.asarray(w_j)[0] > 0).any()  # behind / in front
    li_t, cw_t = TL.choose_light(scene, u_t, p_t)
    li_j, cw_j = JL.choose_light(js, jnp.asarray(x["u"]), jnp.asarray(x["p"]))
    same = li_t.numpy() == np.asarray(li_j)
    assert same.mean() >= 0.999, f"chosen light agrees on {same.mean():.4%}"
    assert len(np.unique(np.asarray(li_j))) == scene.meta.n_lights
    _close(cw_t, cw_j, "choice weight", same, rtol=RTOL_W)
    li = torch.as_tensor(np.asarray(li_j).astype(np.int64))
    _close(TL.light_choice_pdf(scene, li, p_t), JL.light_choice_pdf(js, li_j, jnp.asarray(x["p"])),
           "light_choice_pdf", rtol=RTOL_W)
    _close(TL.infinite_winner_choice_pdf(scene, torch.as_tensor(x["d"]), p_t),
           JL.infinite_winner_choice_pdf(js, jnp.asarray(x["d"]), jnp.asarray(x["p"])),
           "infinite_winner_choice_pdf", rtol=RTOL_W)


@pytest.mark.parametrize("size", ["small-area", "small-box"])
def test_area_sampling_matches_jax(scenes, size):
    from tungsten_tpu.models.primitives import lights as JL
    from tungsten_tpu_torch.models.primitives import lights as TL

    _, scene, js = scenes[size]
    x = _inputs(scene)
    n_area = scene.meta.n_lights - (1 if scene.meta.has_env else 0)
    li = (np.arange(N) % n_area).astype(np.int32)  # area lights only
    ls_t = TL.sample_area_direct(scene, torch.as_tensor(li.astype(np.int64)),
                                 *(torch.as_tensor(x[k]) for k in ("p", "u_tri", "u2")))
    ls_j = JL.sample_area_direct(js, jnp.asarray(li), *(jnp.asarray(x[k]) for k in ("p", "u_tri", "u2")))
    np.testing.assert_array_equal(ls_t.valid.numpy(), np.asarray(ls_j.valid))
    if size == "small-area":  # one-sided lights: some points lie behind them
        assert 0.05 < ls_t.valid.float().mean().item() < 0.95
    for k in ("d", "dist", "pdf", "radiance"):
        _close(getattr(ls_t, k), getattr(ls_j, k), f"sample_area_direct.{k}")
    # directPdf at hits on every triangle, emissive or not
    hit_p = x["p"] + x["d"] * x["t"][:, None]
    tri = np.where(np.arange(N) % 2 == 0, x["tri"],
                   scene.lights.tri_idx.numpy()[np.arange(N) % len(scene.lights.tri_idx)])
    pdf_t = TL.area_direct_pdf(scene, torch.as_tensor(tri.astype(np.int64)),
                               *(torch.as_tensor(a) for a in (x["p"], hit_p, x["d"])))
    pdf_j = JL.area_direct_pdf(js, jnp.asarray(tri.astype(np.int32)),
                               *(jnp.asarray(a) for a in (x["p"], hit_p, x["d"])))
    _close(pdf_t, pdf_j, "area_direct_pdf")
    assert (pdf_t == 0).any() and (pdf_t > 0).any()


@pytest.mark.parametrize("size", ["small-area", "small-box"])
def test_infinite_light_functions_match_jax(scenes, size):
    from tungsten_tpu.models.primitives import lights as JL
    from tungsten_tpu_torch.models.primitives import lights as TL

    _, scene, js = scenes[size]
    x = _inputs(scene)
    li = (np.arange(N) % scene.meta.n_lights).astype(np.int32)
    d_t, d_j = torch.as_tensor(x["d"]), jnp.asarray(x["d"])
    m_t, e_t, pdf_t = TL.chosen_infinite_eval(scene, torch.as_tensor(li.astype(np.int64)), d_t)
    m_j, e_j, pdf_j = JL.chosen_infinite_eval(js, jnp.asarray(li), d_j)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    assert bool(m_t.any()) == scene.meta.has_env
    _close_most(e_t, e_j, "chosen_infinite_eval radiance")
    _close(pdf_t, pdf_j, "chosen_infinite_eval pdf")
    spec = torch.as_tensor(np.arange(N) % 3 == 0)
    np.testing.assert_array_equal(
        TL.infinite_needs_escape_add(scene, d_t, spec).numpy(),
        np.asarray(JL.infinite_needs_escape_add(js, d_j, jnp.asarray(spec.numpy()))))
    _close_most(TL.infinite_radiance(scene, d_t), JL.infinite_radiance(js, d_j),
                "infinite_radiance")
    _close(TL.infinite_winner_pdf(scene, d_t), JL.infinite_winner_pdf(js, d_j), "infinite_winner_pdf")
    if scene.meta.has_env:
        ls_t = TL.sample_env_direct(scene, torch.as_tensor(li.astype(np.int64)),
                                    torch.as_tensor(x["u2"]))
        ls_j = JL.sample_env_direct(js, jnp.asarray(li), jnp.asarray(x["u2"]))
        np.testing.assert_array_equal(ls_t.valid.numpy(), np.asarray(ls_j.valid))
        for k in ("d", "pdf", "radiance"):
            _close(getattr(ls_t, k), getattr(ls_j, k), f"sample_env_direct.{k}")
