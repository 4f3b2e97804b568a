"""The port's analytic sphere / disk / cylinder prims against the JAX package.

Same inputs, made with numpy from a seed, go through the JAX module
(tungsten_tpu/models/primitives/analytic.py, plain XLA) and the port's
(plain torch). The host half (extract_params, build_table) is the same
numpy code: the tables agree exactly, up to the f32 cast. The intersection
and the normal run the same f32 operations in the same order, XLA on the
CPU may fuse or vectorise them (sqrt, atan2 and acos too), so floats are
held to rtol 1e-5 plus atol 1e-5 (uv, normals: unit scale) and t to rtol
1e-5 plus atol 1e-6; the prim index k and the backside flag agree exactly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tungsten_tpu_torch.models.primitives import analytic as A

FIELDS = [k for k, _ in A.FIELDS]


def _prims(rng):
    """A spread of prims: spheres, disks (one with an emission cone), capped
    and uncapped cylinders, with random positions, rotations and scales."""
    from tungsten_tpu_torch.math import transform as tf

    specs = []
    kinds = ["sphere", "disk", "cylinder", "cylinder", "sphere", "disk", "cylinder"]
    for i, kind in enumerate(kinds):
        prim = {"type": kind}
        if kind == "cylinder":
            prim["capped"] = i != 3
        if kind == "disk" and i == 5:
            prim["cone_angle"] = 40.0
        scale = rng.uniform(0.4, 1.2, 3).tolist() if kind != "sphere" else float(rng.uniform(0.3, 1.0))
        xf = {"position": rng.uniform(-3.0, 3.0, 3).tolist(), "scale": scale,
              "rotation": rng.uniform(-90.0, 90.0, 3).tolist()}
        specs.append((kind, tf.mat4_from_json(xf), prim))
    return specs


@pytest.fixture(scope="module")
def case():
    from tungsten_tpu.models.primitives import analytic as JA

    rng = np.random.default_rng(0xA7)
    specs = _prims(rng)
    jtab = JA.build_table([JA.extract_params(k, m, p) for k, m, p in specs])
    arrays = A.build_table([A.extract_params(k, m, p) for k, m, p in specs])
    tab = A.AnalyticTable.from_arrays(arrays, torch.device("cpu"))
    n = 4096
    o = rng.uniform(-5.0, 5.0, (n, 3))
    # half the rays aim at a prim (so every type is hit), half are random
    tgt = np.asarray(jtab.pos)[rng.integers(0, jtab.n, n)] + rng.normal(0, 0.4, (n, 3))
    d = np.where((np.arange(n) % 2 == 0)[:, None], tgt - o, rng.normal(size=(n, 3)))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tnear = np.full(n, 1e-4)
    tfar = np.full(n, 3.0e38)
    tfar[::7] = rng.uniform(0.5, 6.0, len(tfar[::7]))  # bounded segments
    tfar[3::11] = 0.0  # dead lanes
    rays = [np.ascontiguousarray(a, np.float32) for a in (o, d, tnear, tfar)]
    return dict(specs=specs, jtab=jtab, arrays=arrays, tab=tab, rays=rays)


def test_table_matches_jax(case):
    jtab, arrays, tab = case["jtab"], case["arrays"], case["tab"]
    assert tab.n == jtab.n == len(case["specs"])
    for k in FIELDS:
        a, b = arrays[k], np.asarray(getattr(jtab, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
        np.testing.assert_array_equal(getattr(tab, k).numpy(), b, err_msg=k)
    assert set(np.asarray(jtab.ptype).tolist()) == {A.SPHERE, A.DISK, A.CYLINDER}


def test_extract_params_and_frame_match_jax(case):
    from tungsten_tpu.models.primitives import analytic as JA

    for kind, m, prim in case["specs"]:
        mine, theirs = A.extract_params(kind, m, prim), JA.extract_params(kind, m, prim)
        assert mine.keys() == theirs.keys()
        for k in mine:
            np.testing.assert_array_equal(np.asarray(mine[k]), np.asarray(theirs[k]), err_msg=k)
    for n in (np.array([0.0, 1.0, 0.0]), np.array([0.6, 0.0, -0.8]), np.array([0.0, 0.0, 1.0])):
        for a, b in zip(A._tangent_frame(n), JA._tangent_frame(n)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        A.extract_params("cone", np.eye(4), {})


def test_intersect_matches_jax(case):
    from tungsten_tpu.models.primitives import analytic as JA

    rays = case["rays"]
    hj = JA.intersect_analytic(case["jtab"], *(jnp.asarray(a) for a in rays))
    ht = A.intersect_analytic(case["tab"], *(torch.as_tensor(a) for a in rays))
    kj, kt = np.asarray(hj.k), ht.k.numpy()
    np.testing.assert_array_equal(kt, kj)
    hit = kt >= 0
    assert 0.3 < hit.mean() < 0.9
    assert set(np.asarray(case["jtab"].ptype)[kt[hit]].tolist()) == {A.SPHERE, A.DISK, A.CYLINDER}
    np.testing.assert_allclose(ht.t.numpy(), np.asarray(hj.t), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ht.uv.numpy()[hit], np.asarray(hj.uv)[hit], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ht.ng.numpy()[hit], np.asarray(hj.ng)[hit], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ht.back.numpy(), np.asarray(hj.back))
    dead = rays[3] <= rays[2]
    assert (kt[dead] == -1).all() and (ht.t.numpy()[dead] == A.INF).all()


def test_normal_at_matches_jax(case):
    """At the hit points, and for triangle ids (k < 0) clamped like the JAX
    function does."""
    from tungsten_tpu.models.primitives import analytic as JA

    rays = case["rays"]
    ht = A.intersect_analytic(case["tab"], *(torch.as_tensor(a) for a in rays))
    hit = ht.k >= 0
    o, d = (torch.as_tensor(a) for a in rays[:2])
    p = (o + d * ht.t[:, None])[hit]
    k = ht.k[hit]
    nt = A.normal_at(case["tab"], k, p).numpy()
    nj = np.asarray(JA.normal_at(case["jtab"], jnp.asarray(k.numpy()), jnp.asarray(p.numpy())))
    np.testing.assert_allclose(nt, nj, rtol=1e-5, atol=1e-5)
    # the geometric normal at the hit is the one the intersection reports
    np.testing.assert_allclose(nt, ht.ng[hit].numpy(), rtol=0, atol=1e-3)
    neg = torch.full((8,), -5)
    pts = torch.as_tensor(rays[0][:8])
    np.testing.assert_allclose(
        A.normal_at(case["tab"], neg, pts).numpy(),
        np.asarray(JA.normal_at(case["jtab"], jnp.asarray(neg.numpy()), jnp.asarray(rays[0][:8]))),
        rtol=1e-5, atol=1e-5)


def test_occluded_analytic_matches_jax(case):
    """The shadow rays' any-hit test: a disk occludes from its front side
    only, spheres and cylinders from both."""
    from tungsten_tpu.models.primitives import analytic as JA

    rays = case["rays"]
    occ_j = np.asarray(JA.occluded_analytic(case["jtab"], *(jnp.asarray(a) for a in rays)))
    occ_t = A.occluded_analytic(case["tab"], *(torch.as_tensor(a) for a in rays)).numpy()
    np.testing.assert_array_equal(occ_t, occ_j)
    hit = A.intersect_analytic(case["tab"], *(torch.as_tensor(a) for a in rays)).k.numpy() >= 0
    assert 0.2 < occ_t.mean() < hit.mean()  # some disk hits come from behind
    assert not occ_t[~hit].any()


def test_hit_geom_matches_jax(tmp_path):
    """(ng, uv) at hits on triangles and on analytic prims (virtual ids
    >= T) of the small-analytic scene, in both packages."""
    from tungsten_tpu.models.primitives import analytic as JA
    from tungsten_tpu.scene.flatten import flatten_scene as jflatten
    from tungsten_tpu.scene.load import load_scene as jload
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.scene.flatten import from_arrays
    from test_torch_host import jax_arrays

    path = synth.write_scene(str(tmp_path), "small-analytic")
    js = jflatten(jload(path))
    scene = from_arrays(jax_arrays(js), js.meta, torch.device("cpu"))
    rng = np.random.default_rng(3)
    n, n_tris = 2048, scene.tris.v0.shape[0]
    prim = np.where(np.arange(n) % 3 == 0, n_tris + rng.integers(0, scene.ana.n, n),
                    rng.integers(0, n_tris, n)).astype(np.int32)
    p = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    u, v = (rng.uniform(0.0, 0.5, n).astype(np.float32) for _ in range(2))
    ng_j, uv_j = JA.hit_geom(js, *(jnp.asarray(a) for a in (prim, p, u, v)))
    ng_t, uv_t = A.hit_geom(scene, torch.as_tensor(prim.astype(np.int64)),
                            *(torch.as_tensor(a) for a in (p, u, v)))
    np.testing.assert_allclose(ng_t.numpy(), np.asarray(ng_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-5, atol=1e-5)
