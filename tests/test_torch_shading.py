"""The torch port's shading functions against the JAX package.

Both packages read the same tables: the JAX FlatScene of the `small`
synthetic scene is carried into the port with `from_arrays`.

Tolerance: at least 99.9% of the elements within rtol 1e-5, atol 1e-6
(transcendentals come from a different library), and every element within
rtol 1e-3, atol 1e-5. The few elements between the two bars are where the
function itself amplifies a one-ulp difference: a bilinear lookup on the
sky's steep sun texels, sqrt(1 - cos^2) near the pole of a microfacet
sample, 1 / (wi . m) for grazing half vectors.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

RTOL, ATOL = 1e-5, 1e-6
RTOL_ALL, ATOL_ALL = 1e-3, 1e-5


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    import tungsten_tpu.accel.bvh as jbvh
    import tungsten_tpu_torch.accel.bvh as tbvh
    from tungsten_tpu.scene.flatten import flatten_scene as jflatten
    from tungsten_tpu.scene.load import load_scene as jload
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.scene.flatten import from_arrays
    from test_torch_host import jax_arrays

    mp = pytest.MonkeyPatch()
    # the numpy BVH build on both sides, and no stale JAX disk cache
    mp.setattr(jbvh, "_NATIVE", False)
    mp.setattr(tbvh, "_NATIVE", False)
    mp.setattr(jbvh, "_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    path = synth.write_scene(str(tmp_path_factory.mktemp("small")), "small")
    js = jflatten(jload(path))
    ts = from_arrays(jax_arrays(js), js.meta, torch.device("cpu"))
    yield js, ts
    mp.undo()


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL_ALL, atol=ATOL_ALL)
    within = np.isclose(got, want, rtol=rtol, atol=ATOL)
    assert within.mean() >= 0.999, f"{within.mean():.5f} of elements within rtol {rtol}"


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_camera_rays(scenes, rng):
    from tungsten_tpu.models.cameras import camera_rays_w as jcam
    from tungsten_tpu_torch.models.cameras.pinhole import camera_rays_w as tcam

    js, ts = scenes
    n = 3000
    px = rng.integers(0, js.meta.res_x, n).astype(np.int32)
    py = rng.integers(0, js.meta.res_y, n).astype(np.int32)
    u = rng.random((n, 2)).astype(np.float32)
    oj, dj, wj = jcam(js.camera, js.meta, jnp.asarray(px), jnp.asarray(py), jnp.asarray(u),
                      jnp.asarray(u))
    ot, dt, wt = tcam(ts.camera, ts.meta, torch.as_tensor(px.astype(np.int64)),
                      torch.as_tensor(py.astype(np.int64)), torch.as_tensor(u), torch.as_tensor(u))
    _close(ot, oj)
    _close(dt, dj)
    _close(wt, wj)


def test_eval_texture_every_table_entry(scenes, rng):
    from tungsten_tpu.models.textures import eval_texture as jtex
    from tungsten_tpu_torch.models.textures.textures import eval_texture as ttex

    js, ts = scenes
    n_tex = int(np.asarray(js.textures.tpack).shape[0])
    assert set(ts.textures.present) == {0, 1, 2}  # constant, checker, bitmap
    n = 4000
    tid = rng.integers(0, n_tex, n).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)  # wraps too
    want = jtex(js.textures, jnp.asarray(tid), jnp.asarray(uv))
    got = ttex(ts.textures, torch.as_tensor(tid.astype(np.int64)), torch.as_tensor(uv))
    _close(got, want)


@pytest.mark.parametrize("kind", ["eval", "pdf", "sample"])
def test_bsdf_dispatch(scenes, rng, kind):
    from tungsten_tpu.models.bsdfs import bsdf_eval, bsdf_pdf, bsdf_sample
    from tungsten_tpu.models.bsdfs.dispatch import _gather
    from tungsten_tpu_torch.models.bsdfs import dispatch as td

    js, ts = scenes
    assert ts.materials.present == (0, 3)  # lambert, rough_conductor: JAX type ids
    n = 4000
    n_mat = int(np.asarray(js.materials.gpack2).shape[0])
    mat = rng.integers(0, n_mat, n).astype(np.int32)
    uv = rng.random((n, 2)).astype(np.float32)
    wi = _unit(rng, n)
    wo = _unit(rng, n)
    u2 = rng.random((n, 2)).astype(np.float32)
    u1 = rng.random(n).astype(np.float32)
    ctx = (js.materials, js.textures)
    jpre = _gather(ctx, jnp.asarray(mat), jnp.asarray(uv))
    tpre = td.gather(ts.materials, ts.textures, torch.as_tensor(mat.astype(np.int64)),
                     torch.as_tensor(uv))
    for a, b in zip(tpre, jpre):
        _close(a, b)
    T = torch.as_tensor
    if kind == "eval":
        want = bsdf_eval(ctx, jnp.asarray(mat), jnp.asarray(uv), jnp.asarray(wi), jnp.asarray(wo),
                         nonspecular_only=True, pre=jpre)
        _close(td.bsdf_eval(ts.materials, tpre, T(uv), T(wi), T(wo)), want)
    elif kind == "pdf":
        want = bsdf_pdf(ctx, jnp.asarray(mat), jnp.asarray(uv), jnp.asarray(wi), jnp.asarray(wo),
                        pre=jpre)
        _close(td.bsdf_pdf(ts.materials, tpre, T(uv), T(wi), T(wo)), want)
    else:
        want = bsdf_sample(ctx, jnp.asarray(mat), jnp.asarray(uv), jnp.asarray(wi),
                           jnp.asarray(u2), jnp.asarray(u1), pre=jpre)
        got = td.bsdf_sample(ts.materials, tpre, T(uv), T(wi), T(u2), T(u1))
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(got.lobe.numpy(), np.asarray(want.lobe))
        # everything a sample returns is a function of the microfacet normal
        # m, and the JAX formulation (tan^2 = (1 - cos^2) / cos^2) conditions
        # it at ~1 / sin^2(theta_m), up to ~1e3 for roughness 0.1: a one-ulp
        # difference in cos(theta_m) (rsqrt in another library) becomes up
        # to ~6e-5 relative, so the 99.9% bar is rtol 1e-4 here
        ok = np.array(want.valid)  # an invalid sample's wo and pdf are never read
        _close(got.wo[ok], np.asarray(want.wo)[ok], rtol=1e-4)
        _close(got.pdf[ok], np.asarray(want.pdf)[ok], rtol=1e-4)
        _close(got.weight, want.weight, rtol=1e-4)


def test_env_light_functions(scenes, rng):
    from tungsten_tpu.models.primitives import lights as JL
    from tungsten_tpu_torch.models.primitives import lights as TL

    js, ts = scenes
    n = 4000
    d = _unit(rng, n)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    u2 = rng.random((n, 2)).astype(np.float32)
    dj, dt = jnp.asarray(d), torch.as_tensor(d)
    uvj, stj = JL.direction_to_uv(js.env, dj)
    uvt, stt = TL.direction_to_uv(ts.env, dt)
    _close(uvt, uvj)
    _close(stt, stj)
    _close(TL.env_direct_pdf(ts, dt), JL.env_direct_pdf(js, dj))
    _close(TL.infinite_radiance(ts, dt), JL.infinite_radiance(js, dj))
    _close(TL.infinite_winner_pdf(ts, dt), JL.infinite_winner_pdf(js, dj))
    _close(TL.infinite_winner_choice_pdf(ts, dt, torch.as_tensor(p)),
           JL.infinite_winner_choice_pdf(js, dj, jnp.asarray(p)))
    assert TL.any_infinite_sampled(ts.meta) == JL.any_infinite_sampled(js.meta)
    li = jnp.zeros((n,), jnp.int32)
    lsj = JL.sample_env_direct(js, li, jnp.asarray(u2))
    lst = TL.sample_env_direct(ts, torch.zeros(n, dtype=torch.int64), torch.as_tensor(u2))
    np.testing.assert_array_equal(lst.valid.numpy(), np.asarray(lsj.valid))
    for f in ("d", "dist", "pdf", "radiance"):
        _close(getattr(lst, f), getattr(lsj, f))


def test_choose_and_sample_light_env_only(scenes, rng):
    """In an env-only scene the choice is static (light 0, pdf 1) and the
    area sample is merged away: `is_env` is set on every lane, so the merged
    sample IS the env sample; the port gives the same light, sample, choice
    pdf, light kind flags and sampler position."""
    from tungsten_tpu.integrators.path_tracer import _choose_and_sample_light as jchoose
    from tungsten_tpu.models.primitives import lights as JL
    from tungsten_tpu.sampling.sampler import Sampler as JSampler
    from tungsten_tpu_torch.integrators.path_tracer import _choose_and_sample_light as tchoose
    from tungsten_tpu_torch.sampling.sampler import Sampler as TSampler

    js, ts = scenes
    n = 2048
    lane = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    jsmp = JSampler.create(jnp.asarray(np.array([5, 0], np.uint32)), jnp.asarray(lane))
    tsmp = TSampler.create((5, 0), torch.as_tensor(lane.astype(np.int64)))
    li, is_env, is_cap, is_point, lsj, cpj, jsmp = jchoose(js, jsmp, jnp.asarray(p))
    lit, is_env_t, is_cap_t, is_point_t, lst, cpt, tsmp = tchoose(ts, tsmp, torch.as_tensor(p))
    np.testing.assert_array_equal(lit.numpy(), np.asarray(li))
    for mine, ref in ((is_env_t, is_env), (is_cap_t, is_cap), (is_point_t, is_point)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    assert np.asarray(is_env).all() and not np.asarray(is_cap).any()
    assert not np.asarray(is_point).any() and (np.asarray(li) == 0).all()
    u_point = JSampler.create(jnp.asarray(np.array([5, 0], np.uint32)),
                              jnp.asarray(lane)).skip(1).next_2d()[0]
    lse = JL.sample_env_direct(js, li, u_point)
    for f in ("d", "dist", "pdf", "radiance", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(lsj, f)), np.asarray(getattr(lse, f)))
        _close(getattr(lst, f).to(torch.float32), np.asarray(getattr(lsj, f), np.float32))
    _close(cpt, cpj)
    assert int(tsmp.dim) == int(jsmp.dim) and tsmp.pending is None and jsmp.pending is None
