"""The torch port's host side: package rules and the flattened scene.

The port's own flatten_scene(load_scene(p)) must equal the JAX package's
FlatScene carried across with from_arrays: integer tables exactly, float
tables at rtol 1e-6 (they come out of the same numpy code, so in practice
bit for bit), the intersector packs (pbvh8, pbvh3, pbvh, ptris) and the
analytic table exactly, and the static facts equal.
"""
import dataclasses
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


def media_arrays(table):
    """A medium table's fields as MediumTable.from_arrays takes them, read
    by name from the JAX package's pytree (or any object with its fields)."""
    from tungsten_tpu_torch.models.grids.grid import DenseGrid
    from tungsten_tpu_torch.models.media.media import ARRAY_FIELDS, STATIC_FIELDS

    grids = [({k: np.asarray(getattr(g, k)) for k in DenseGrid.FIELDS},
              {k: getattr(g, k) for k in DenseGrid.STATICS}) for g in table.vox_grids]
    return {"arrays": {k: np.asarray(getattr(table, k)) for k, _ in ARRAY_FIELDS},
            "statics": {k: getattr(table, k) for k in STATIC_FIELDS}, "grids": grids}


def jax_arrays(js):
    """The JAX FlatScene's arrays under the port's ARRAY_KEYS, None where a
    pack on the way is None (a pack the JAX flatten left out), and its env
    lights under "envs"."""
    from tungsten_tpu_torch.scene.flatten import ARRAY_KEYS, ENV_KEYS

    def get(obj, key):
        for part in key.split("."):
            obj = None if obj is None else getattr(obj, part)
        return None if obj is None else np.asarray(obj)

    out = {k: get(js, k) for k in ARRAY_KEYS}
    out["envs"] = [{k: get(e, k) for k in ENV_KEYS} for e in js.envs]
    out["media"] = media_arrays(js.media)
    return out


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
    for k in ("tris_t", "clusters", "tri_c"):
        out[f"ptris.{k}"] = getattr(scene.ptris, k)
    if scene.ana is not None:
        for k in dataclasses.fields(scene.ana):
            out[f"ana.{k.name}"] = getattr(scene.ana, k.name)
    return out


def _flatten_both(tmp_path, size):
    """(port scene, JAX scene carried across, JAX scene) of a synth size."""
    from tungsten_tpu.scene.flatten import flatten_scene as jflatten
    from tungsten_tpu.scene.load import load_scene as jload
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.scene.flatten import flatten_scene, from_arrays
    from tungsten_tpu_torch.scene.load import load_scene

    path = synth.write_scene(str(tmp_path / size), size)
    cpu = torch.device("cpu")
    js = jflatten(jload(path))
    return flatten_scene(load_scene(path), cpu), from_arrays(jax_arrays(js), js.meta, cpu), js


def test_flatten_matches_jax_flatscene(numpy_bvh, tmp_path):
    from tungsten_tpu_torch.scene.flatten import SceneMeta

    mine, theirs, js = _flatten_both(tmp_path, "small")

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
    assert mine.ana is None and theirs.ana is None and js.ana is None
    assert mine.pbvh.n_nodes == js.pbvh.n_nodes and mine.ptris.n_tris == js.ptris.n_tris


def test_flatten_matches_jax_flatscene_analytic(numpy_bvh, tmp_path):
    """small-analytic: the analytic table, the virtual shading rows (one per
    analytic prim, after the triangles) and meta.has_analytic."""
    from tungsten_tpu_torch.scene.flatten import SceneMeta

    mine, theirs, js = _flatten_both(tmp_path, "small-analytic")
    a, b = _tensors(mine), _tensors(theirs)
    assert a.keys() == b.keys() and "ana.inv_rot" in a
    for k in a:
        x, y = a[k].numpy(), b[k].numpy()
        assert x.shape == y.shape and x.dtype == y.dtype, k
        if k.startswith(("pbvh", "ptris", "ana")) or not np.issubdtype(x.dtype, np.floating):
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=0, err_msg=k)
    n_tris, n_ana = mine.tris.v0.shape[0], mine.ana.n
    assert n_ana == 3 and mine.shade_pack.shape[0] == n_tris + n_ana
    rows = mine.shade_pack[n_tris:].numpy()
    assert (rows[:, :18] == 0).all() and (rows[:, 19] == -1).all()
    np.testing.assert_array_equal(rows[:, 18], [3, 2, 4])  # accent, inner, chrome
    for f in dataclasses.fields(SceneMeta):
        assert getattr(mine.meta, f.name) == getattr(js.meta, f.name), f.name
    assert mine.meta.has_analytic


def test_from_arrays_takes_each_pack_all_or_none(numpy_bvh, tmp_path):
    """A JAX scene whose VMEM gates dropped pbvh8 / pbvh3 / pbvh carries
    across without them; a pack given in part, pbvh3 without the pbvh8
    whose leaves it shares, or env lights that do not match meta.n_envs, is
    refused."""
    from tungsten_tpu.scene.flatten import flatten_scene as jflatten
    from tungsten_tpu.scene.load import load_scene as jload
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.scene.flatten import from_arrays

    path = synth.write_scene(str(tmp_path / "s"), "small-analytic")
    js = jflatten(jload(path))
    arrays = jax_arrays(js)
    cpu = torch.device("cpu")

    def drop(*groups):
        return {k: v for k, v in arrays.items() if k.split(".")[0] not in groups}

    s = from_arrays(drop("pbvh8", "pbvh3"), js.meta, cpu)
    assert s.pbvh8 is None and s.pbvh3 is None and s.pbvh is not None and s.ana is not None
    s = from_arrays({**drop("pbvh8", "pbvh3", "pbvh"), "pbvh.nodes": None}, js.meta, cpu)
    assert s.pbvh is None and s.ptris.n_tris == js.ptris.n_tris
    with pytest.raises(KeyError, match="pbvh8"):
        from_arrays({**arrays, "pbvh8.kid": None}, js.meta, cpu)
    with pytest.raises(KeyError, match="ptris"):
        from_arrays(drop("ptris"), js.meta, cpu)
    with pytest.raises(ValueError, match="pbvh3"):
        from_arrays(drop("pbvh8"), js.meta, cpu)
    assert js.meta.n_envs == len(arrays["envs"]) >= 1
    for envs in ([], arrays["envs"] * 2):  # the env lights must match meta.n_envs
        with pytest.raises(KeyError, match="n_envs"):
            from_arrays({**arrays, "envs": envs}, js.meta, cpu)


def test_all_analytic_scene_flattens(tmp_path):
    """With no triangles at all, one degenerate far-away triangle keeps the
    tables and packs well formed (flatten.py:526-540); it is never hit."""
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    path = synth.write_scene(str(tmp_path), "small-analytic")
    with open(path) as f:
        doc = json.load(f)
    doc["primitives"] = [p for p in doc["primitives"] if p["type"] not in ("quad", "mesh", "cube")]
    with open(path, "w") as f:
        json.dump(doc, f)
    scene = flatten_scene(load_scene(path), torch.device("cpu"))
    assert scene.tris.v0.shape[0] == 1 and scene.ana.n == 3
    assert scene.shade_pack.shape[0] == 4 and scene.meta.has_analytic


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
    if what == "analytic sphere":  # an emissive one
        prims.append({"type": "sphere", "bsdf": "inner", "emission": 5.0})
    elif what == "emissive cylinder":
        prims.append({"type": "cylinder", "bsdf": "inner", "power": 20.0})
    elif what == "skydome":
        prims.append({"type": "skydome", "turbidity": 3, "intensity": 2})
    elif what == "area light":
        prims[2]["emission"] = 5.0
    elif what == "media":
        doc["media"] = [{"name": "fog", "type": "homogeneous"}]
    elif what == "thinlens":
        doc["camera"]["type"] = "thinlens"
    elif what == "other bsdf":  # a fiber on the cube
        bsdfs[2] = {"name": "inner", "type": "hair"}
    elif what == "unknown bsdf":
        bsdfs[2] = {"name": "inner", "type": "velvet"}
    elif what == "unknown primitive":
        prims.append({"type": "bezier_patch", "bsdf": "inner"})
    elif what == "dielectric":
        bsdfs[2] = {"name": "inner", "type": "dielectric", "ior": 1.5}
    elif what == "textured roughness":
        bsdfs[1]["roughness"] = {"type": "checker", "on_color": 0.05, "off_color": 0.3}
    elif what == "hdr sky":
        prims[3]["emission"] = "sky.hdr"
    elif what == "aov":
        doc["renderer"]["output_buffers"] = [{"type": "normal"}]
    elif what == "no env":
        del prims[3]
    elif what == "point light":
        prims.append({"type": "point", "power": 10.0})
    elif what == "emissive disk":
        prims.append({"type": "disk", "bsdf": "inner", "emission": 5.0})
    elif what == "cap light":
        prims.append({"type": "infinite_sphere_cap", "emission": 5.0, "cap_angle": 10.0})
    elif what == "two envs":
        prims.append({"type": "infinite_sphere", "emission": 0.5})
    elif what == "unsampled env":
        prims[3]["sample"] = False
    return doc


# edit -> the light rows it leaves
NOW_PORTED = {"area light": 2, "no env": 0, "dielectric": 1, "textured roughness": 1,
              "hdr sky": 1, "analytic sphere": 2, "emissive cylinder": 2, "point light": 2,
              "emissive disk": 2, "cap light": 2, "two envs": 2, "unsampled env": 0,
              "thinlens": 1, "aov": 1, "media": 1, "skydome": 2, "other bsdf": 1}
SURFACE_LIGHTS = ("area light", "analytic sphere", "emissive cylinder", "emissive disk")


@pytest.mark.parametrize("what", ["analytic sphere", "area light", "media", "thinlens",
                                  "other bsdf", "aov", "no env", "point light",
                                  "emissive disk", "cap light", "two envs", "unsampled env",
                                  "dielectric", "textured roughness", "hdr sky",
                                  "emissive cylinder", "skydome", "unknown bsdf",
                                  "unknown primitive"])
def test_missing_features_raise(tmp_path, what):
    """Every feature outside the port (a BSDF or primitive type no package
    knows) raises NotImplementedError naming it; none is skipped silently.
    Those that have joined the port since (an emissive cube beside the sky;
    a scene without an env light; a dielectric; a textured roughness; an
    .hdr env map; emissive analytic prims, point and cap lights, two envs,
    an unsampled env; a thinlens camera; an AOV buffer; a medium; a skydome
    beside the sky; a fiber BSDF) flatten, with the light rows they should
    have."""
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    path = synth.write_scene(str(tmp_path), "small")
    if what == "hdr sky":
        from tungsten_tpu_torch.io.imageio import load_pfm, save_hdr

        save_hdr(str(tmp_path / "sky.hdr"), load_pfm(str(tmp_path / "sky.pfm")))
    with open(path) as f:
        doc = _edit_small(json.load(f), what)
    with open(path, "w") as f:
        json.dump(doc, f)
    if what in NOW_PORTED:
        scene = flatten_scene(load_scene(path), torch.device("cpu"))
        assert scene.meta.n_lights == NOW_PORTED[what]
        assert scene.lights.has_surface == (what in SURFACE_LIGHTS)
        return
    with pytest.raises(NotImplementedError, match={"unknown bsdf": "'velvet'",
                                                  "unknown primitive": "'bezier_patch'"}[what]):
        flatten_scene(load_scene(path), torch.device("cpu"))


def test_build_hash_covers_nested_headers(monkeypatch, tmp_path):
    """A kernel library's name hashes its source and every csrc header it
    reaches, headers included by headers too: editing any of them rebuilds
    the library (ops/_build.py). The port's own sources resolve."""
    from tungsten_tpu_torch.ops import _build

    for name in ("bvh8_walk", "bvh_walk", "intersect_stream"):
        assert os.path.exists(_build._paths(name)[0])
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    first = _build._paths("k")[1]
    assert _build._paths("k")[1] == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert _build._paths("k")[1] != first
