"""End to end: the render's intersector dispatch on each of its routes.

`small-analytic` (the `small` scene plus an analytic sphere, disk and capped
cylinder) rendered by the JAX package on the CPU, as its own tests run it
(analytic prims first, then the binary BVH walk `intersect_bvh`), against
the port on each route of `_intersect_tris`, the packs dropped with
dataclasses.replace: all packs (the K3 twin), pbvh8 = None (K1's),
pbvh8 = gbvh = pbvh3 = None (K5's) and pbvh8 = gbvh = pbvh3 = pbvh = None
(K2's). Both packages use the numpy BVH
build. Bars, as test_torch_render.py's: per-channel means within 2e-3
relative, >= 98% of pixels within 1e-3 + 1e-3 * |ref| (a path whose hit
flips between two walks shades differently).

tests/data/torch_port_analytic_ref.json holds the JAX render's means for the
GPU check; the test checks that the file still matches. The module runs
with one torch thread (test_torch_lockstep_area.py `one_torch_thread` says
why).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tungsten_tpu_torch.ops import bvh, bvh8, gather_bvh, intersect_stream
from test_torch_lockstep_area import one_torch_thread  # noqa: F401

REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "torch_port_analytic_ref.json")
# route -> (packs dropped, the twin whose launches it moves)
ROUTES = {
    "K3": ((), lambda: bvh8.walk_twin.launches),
    "K1": (("pbvh8",), lambda: gather_bvh.walk_twin.launches),
    "K5": (("pbvh8", "gbvh", "pbvh3"), lambda: bvh.walk_packet_twin.launches["v2"]),
    "K2": (("pbvh8", "gbvh", "pbvh3", "pbvh"), lambda: intersect_stream.stream_twin.launches),
}


def _launches():
    return {r: count() for r, (_, count) in ROUTES.items()}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The JAX render, the JAX scene's arrays, and the port's flattened scene."""
    import tungsten_tpu.accel.bvh as jbvh
    import tungsten_tpu_torch.accel.bvh as tbvh
    from tungsten_tpu.renderer.render import DEFAULT_SEED, render_flat as jrender
    from tungsten_tpu.scene.flatten import flatten_scene as jflatten
    from tungsten_tpu.scene.load import load_scene as jload
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene
    from test_torch_host import jax_arrays

    mp = pytest.MonkeyPatch()
    mp.setattr(jbvh, "_NATIVE", False)
    mp.setattr(tbvh, "_NATIVE", False)
    mp.setattr(jbvh, "_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    path = synth.write_scene(str(tmp_path_factory.mktemp("sa")), "small-analytic")
    js = jflatten(jload(path))
    ref = np.asarray(jrender(js, seed=DEFAULT_SEED))
    scene = flatten_scene(load_scene(path), torch.device("cpu"))
    mp.undo()
    return dict(ref=ref, arrays=jax_arrays(js), meta=js.meta, scene=scene, seed=DEFAULT_SEED)


def _check_image(img, ref):
    assert img.shape == ref.shape == (48, 64, 3)
    assert np.isfinite(img).all() and (img >= 0).all()
    np.testing.assert_allclose(img.reshape(-1, 3).mean(0), ref.reshape(-1, 3).mean(0), rtol=2e-3)
    close = np.all(np.abs(img - ref) <= 1e-3 + 1e-3 * np.abs(ref), axis=-1)
    assert close.mean() >= 0.98, f"{close.mean():.4f} of pixels within the bar"


@pytest.mark.parametrize("route", list(ROUTES))
def test_route_matches_jax(scenes, route):
    """Each route renders through its own walk alone and matches the JAX
    package's render."""
    from tungsten_tpu_torch.renderer.render import render_flat

    dropped, _ = ROUTES[route]
    scene = dataclasses.replace(scenes["scene"], **dict.fromkeys(dropped))
    before = _launches()
    img = render_flat(scene, seed=scenes["seed"])
    moved = {r: n - before[r] for r, n in _launches().items()}
    assert moved[route] > 0 and all(v == 0 for r, v in moved.items() if r != route), moved
    _check_image(img, scenes["ref"])


def test_jax_scene_without_packs_renders_on_k2(scenes):
    """A JAX scene carried across without its BVH packs (as its VMEM gates
    leave a large scene) has only ptris left, and renders on K2."""
    from tungsten_tpu_torch.renderer.render import render_flat
    from tungsten_tpu_torch.scene.flatten import from_arrays

    arrays = {k: v for k, v in scenes["arrays"].items()
              if k.split(".")[0] not in ("pbvh8", "gbvh", "pbvh3", "pbvh")}
    scene = from_arrays(arrays, scenes["meta"], torch.device("cpu"))
    assert scene.pbvh8 is None and scene.pbvh3 is None and scene.pbvh is None
    assert scene.gbvh is None
    assert scene.ana is not None and scene.ptris.n_tris == scene.tris.v0.shape[0]
    before = _launches()
    img = render_flat(scene, seed=scenes["seed"])
    moved = {r: n - before[r] for r, n in _launches().items()}
    assert moved["K2"] > 0 and moved["K3"] == moved["K1"] == moved["K5"] == 0, moved
    _check_image(img, scenes["ref"])


def test_analytic_reference_means_file_matches(scenes):
    """The JSON carries the JAX render's means for the GPU check; rtol 1e-4
    leaves room for another CPU's float rounding in XLA, far below the
    5e-3 the GPU check applies."""
    with open(REF) as f:
        data = json.load(f)
    assert data["scene"] == "small-analytic" and data["seed"] == scenes["seed"]
    assert data["spp"] == 4 and data["resolution"] == [64, 48]
    np.testing.assert_allclose(data["channel_means"], scenes["ref"].reshape(-1, 3).mean(0),
                               rtol=1e-4)


def test_brute_force_at_64_triangles_or_fewer(scenes):
    """At 64 triangles or fewer the dispatch takes brute force and no pack,
    as the JAX package does; the analytic prims still come first."""
    from tungsten_tpu_torch.integrators.path_tracer import _intersect
    from tungsten_tpu_torch.ops.intersect import TriangleSoA

    scene = scenes["scene"]
    tris = TriangleSoA(scene.tris.v0[:40], scene.tris.e1[:40], scene.tris.e2[:40])
    small = dataclasses.replace(scene, tris=tris)
    rng = np.random.default_rng(5)
    o = torch.as_tensor(rng.uniform(-3, 3, (512, 3)), dtype=torch.float32)
    d = torch.as_tensor(rng.normal(size=(512, 3)), dtype=torch.float32)
    d = d / d.norm(dim=1, keepdim=True)
    near, far = torch.full((512,), 1e-4), torch.full((512,), 3.0e38)
    before = _launches()
    h = _intersect(small, o, d, near, far)
    assert _launches() == before
    assert (h.prim >= 40).any() and ((h.prim >= 0) & (h.prim < 40)).any()
