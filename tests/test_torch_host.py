"""The torch port's host side: package rules and the flattened scene.

The port's own flatten_scene(load_scene(p)) must equal the JAX package's
FlatScene carried across with from_arrays: integer tables exactly, float
tables at rtol 1e-6 (they come out of the same numpy code, so in practice
bit for bit), the BVH packs (pbvh8, pbvh3, pbvh) exactly, and the static
facts equal.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def numpy_bvh(monkeypatch, tmp_path):
    """Both packages on the numpy BVH build, without the JAX disk cache."""
    import tungsten_tpu.accel.bvh as jbvh
    import tungsten_tpu_torch.accel.bvh as tbvh

    monkeypatch.setattr(jbvh, "_NATIVE", False)
    monkeypatch.setattr(tbvh, "_NATIVE", False)
    monkeypatch.setattr(jbvh, "_CACHE_DIR", str(tmp_path / "bvh_cache"))


def _tensors(scene):
    """Every table of a port FlatScene by name."""
    out = {
        "tris.v0": scene.tris.v0, "tris.e1": scene.tris.e1, "tris.e2": scene.tris.e2,
        "shade_pack": scene.shade_pack, "materials.gpack2": scene.materials.gpack2,
        "textures.tpack": scene.textures.tpack, "textures.data": scene.textures.data,
        "textures.data4": scene.textures.data4,
        "env.rot": scene.env.rot, "env.inv_rot": scene.env.inv_rot,
        "env.dist.alias_pack": scene.env.dist.alias_pack,
        "env.dist.joint_pdf": scene.env.dist.joint_pdf,
        "camera.rot": scene.camera.rot, "camera.pos": scene.camera.pos,
        "camera.plane_dist": scene.camera.plane_dist,
    }
    for k in ("boxes", "kid", "order", "planes", "prim_map", "kid_t", "order_t", "tri_planes"):
        out[f"pbvh8.{k}"] = getattr(scene.pbvh8, k)
    for k in ("nf", "ni", "box_t", "ni_t"):
        out[f"pbvh3.{k}"] = getattr(scene.pbvh3, k)
    for k in ("nodes", "tris", "prim_map", "box_t", "ni_t", "tri_t"):
        out[f"pbvh.{k}"] = getattr(scene.pbvh, k)
    return out


def test_flatten_matches_jax_flatscene(numpy_bvh, tmp_path):
    from tungsten_tpu.scene.flatten import flatten_scene as jflatten
    from tungsten_tpu.scene.load import load_scene as jload
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.scene.flatten import ARRAY_KEYS, SceneMeta, flatten_scene, from_arrays
    from tungsten_tpu_torch.scene.load import load_scene

    path = synth.write_scene(str(tmp_path / "small"), "small")
    cpu = torch.device("cpu")
    mine = flatten_scene(load_scene(path), cpu)
    js = jflatten(jload(path))
    arrays = {k: None if (v := functools.reduce(getattr, k.split("."), js)) is None
              else np.asarray(v) for k in ARRAY_KEYS}
    theirs = from_arrays(arrays, js.meta, cpu)

    a, b = _tensors(mine), _tensors(theirs)
    for k in a:
        x, y = a[k].numpy(), b[k].numpy()
        assert x.shape == y.shape and x.dtype == y.dtype, k
        if k.startswith("pbvh") or not np.issubdtype(x.dtype, np.floating):
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=0, err_msg=k)
    # integer columns of the packed rows (material / light / texture ids)
    np.testing.assert_array_equal(a["shade_pack"][:, 18:].numpy(), b["shade_pack"][:, 18:].numpy())
    assert mine.env.tex == theirs.env.tex and mine.env.tex_kind == theirs.env.tex_kind
    assert mine.env.dist.shape == theirs.env.dist.shape == tuple(js.env.dist.shape)
    assert mine.materials.present == theirs.materials.present == js.materials.present
    assert mine.materials.albedo_kinds == js.materials.albedo_kinds
    assert mine.textures.present == js.textures.present
    assert mine.pbvh8.leaf == js.pbvh8.leaf == 128
    # pbvh3 and pbvh come from pbvh8's tree; pbvh3 shares its leaf tensors
    assert mine.pbvh3.n_nodes == theirs.pbvh.n_nodes == js.pbvh3.n_nodes == js.pbvh.n_nodes
    for s in (mine, theirs):
        assert s.pbvh3.prim_map is s.pbvh8.prim_map and s.pbvh3.tri_planes is s.pbvh8.tri_planes
    for f in dataclasses.fields(SceneMeta):
        assert getattr(mine.meta, f.name) == getattr(js.meta, f.name), f.name


def test_bvh_build_matches_jax(rng):
    from tungsten_tpu.accel.bvh import build_bvh as jbuild
    from tungsten_tpu_torch.accel.bvh import build_bvh

    lo = rng.uniform(-2, 2, (700, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 0.4, (700, 3)).astype(np.float32)
    for leaf in (4, 128):
        mine, theirs = build_bvh(lo, hi, leaf), jbuild(lo, hi, leaf)
        for k in ("node_min", "node_max", "first", "count", "skip", "prim_order"):
            np.testing.assert_array_equal(getattr(mine, k), getattr(theirs, k), err_msg=k)


def test_package_imports_without_jax():
    """Import every module of the port with jax, flax and the JAX package
    blocked: the port must stand alone on a machine without JAX."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'jaxlib', 'flax', 'tungsten_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import tungsten_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'tungsten_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_tf32_is_off():
    import tungsten_tpu_torch  # noqa: F401

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


def test_device_helper():
    from tungsten_tpu_torch import device

    assert device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            device("cuda")


def _edit_small(doc, what):
    prims, bsdfs = doc["primitives"], doc["bsdfs"]
    if what == "analytic sphere":
        prims.append({"type": "sphere", "bsdf": "inner"})
    elif what == "area light":
        prims[2]["emission"] = 5.0
    elif what == "media":
        doc["media"] = [{"name": "fog", "type": "homogeneous"}]
    elif what == "thinlens":
        doc["camera"]["type"] = "thinlens"
    elif what == "other bsdf":
        bsdfs[2] = {"name": "inner", "type": "dielectric"}
    elif what == "aov":
        doc["renderer"]["output_buffers"] = [{"type": "normal"}]
    elif what == "no env":
        del prims[3]
    elif what == "point light":
        prims.append({"type": "point", "power": 10.0})
    return doc


@pytest.mark.parametrize("what", ["analytic sphere", "area light", "media", "thinlens",
                                  "other bsdf", "aov", "no env", "point light"])
def test_missing_features_raise(tmp_path, what):
    """Every feature outside the slice raises NotImplementedError; none is
    skipped silently."""
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    path = synth.write_scene(str(tmp_path), "small")
    with open(path) as f:
        doc = _edit_small(json.load(f), what)
    with open(path, "w") as f:
        json.dump(doc, f)
    with pytest.raises(NotImplementedError):
        flatten_scene(load_scene(path), torch.device("cpu"))
