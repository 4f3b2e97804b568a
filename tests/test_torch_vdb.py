"""The port's OpenVDB reader against the JAX package's, and the port's
writer (synth.write_vdb) against tests/test_vdb.py's independent writer.

Archives are written in code, by the test's writer and by the port's copy
of it, and decoded by both readers to equal arrays (bit for bit: both are
the same numpy decode). The cases mirror tests/test_vdb.py: float grids
in both header framings, uncompressed, zip and blosc; an Internal5-level
tile; half floats; a density + vec3 archive; the index-space placement of
normalize_size=false; every readCompressedValues metadata code against
hand-written bytes; a vdb grid spec through load_grid_spec. A grid given by
voxels writes the same bytes through both writers, and the port's dense
path (the 192^3 cloud's) equals the voxel path on the same grid.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_vdb import _W, _expect_dense, _scatter_voxels, _write_mask, write_vdb
from tungsten_tpu.models.grids import vdb as jvdb
from tungsten_tpu_torch import synth
from tungsten_tpu_torch.models.grids import vdb as tvdb


def _read_both(path, name="density"):
    """The grid by both readers; the arrays and infos must agree."""
    a, ia = tvdb.read_vdb_grid(path, name)
    b, ib = jvdb.read_vdb_grid(path, name)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == b.dtype and a.shape == b.shape
    for k in ("voxel_size", "translate", "index_min"):
        np.testing.assert_array_equal(np.asarray(ia[k]), np.asarray(ib[k]))
    assert ia["grids"] == ib["grids"]
    return a, ia


@pytest.mark.parametrize("writer", ["test", "port"])
@pytest.mark.parametrize("version,zipped", [(224, True), (224, False), (221, True),
                                            (224, "blosc")])
def test_roundtrip_float_grid(tmp_path, version, zipped, writer):
    if writer == "port" and zipped == "blosc":
        zipped = True  # the port's writer compresses with zlib only
    if zipped == "blosc" and jvdb._blosc() is None:
        zipped = True  # no libblosc here: the zip framing instead
    rng = np.random.default_rng(7)
    voxels = _scatter_voxels(rng, [(0, 0, 0), (8, 16, 24), (128, 0, 64), (4096, 8, 0)])
    path = str(tmp_path / "d.vdb")
    write = write_vdb if writer == "test" else synth.write_vdb
    write(path, [{"name": "density", "type": "float", "voxels": voxels, "voxel_size": 0.25}],
          version=version, zipped=zipped)
    arr, info = _read_both(path)
    np.testing.assert_array_equal(arr, _expect_dense(voxels, [], 1))
    np.testing.assert_allclose(info["voxel_size"], 0.25)


def test_roundtrip_internal_tile(tmp_path):
    """An Internal5-level tile (a 128^3 constant region) and a leaf."""
    voxels = {(130, 5, 7): np.array([2.5], np.float32)}
    tiles = [((256, 0, 0), 128, np.array([0.75], np.float32))]
    for i, write in enumerate((write_vdb, synth.write_vdb)):
        path = str(tmp_path / f"t{i}.vdb")
        write(path, [{"name": "density", "type": "float", "voxels": voxels, "tiles": tiles}])
        arr, _ = _read_both(path)
        np.testing.assert_array_equal(arr, _expect_dense(voxels, tiles, 1))


def test_roundtrip_half_float(tmp_path):
    rng = np.random.default_rng(3)
    voxels = _scatter_voxels(rng, [(0, 0, 0), (8, 8, 8)])
    path = str(tmp_path / "h.vdb")
    synth.write_vdb(path, [{"name": "density", "type": "float", "half": True,
                            "voxels": voxels}])
    arr, _ = _read_both(path)
    np.testing.assert_allclose(arr, _expect_dense(voxels, [], 1), rtol=1e-3)


def test_multi_grid_vec3(tmp_path):
    """density (float) + Cd (vec3s) in one archive."""
    rng = np.random.default_rng(11)
    dvox = _scatter_voxels(rng, [(0, 0, 0), (16, 8, 0)])
    evox = _scatter_voxels(rng, [(0, 0, 0), (16, 8, 0)], ncomp=3)
    path = str(tmp_path / "fire.vdb")
    synth.write_vdb(path, [{"name": "density", "type": "float", "voxels": dvox},
                           {"name": "Cd", "type": "vec3s", "voxels": evox}])
    d, info = _read_both(path, "density")
    e, _ = _read_both(path, "Cd")
    assert info["grids"] == ["density"]
    np.testing.assert_array_equal(d, _expect_dense(dvox, [], 1))
    np.testing.assert_array_equal(e, _expect_dense(evox, [], 3))
    with pytest.raises(KeyError):
        tvdb.read_vdb_grid(path, "temperature")


def test_index_min_and_placement(tmp_path):
    """normalize_size=false: dense index q lands at world (q + index_min) *
    spacing + translate (VdbGrid.cpp:241-249), in both packages."""
    from tungsten_tpu.models.grids import grid_density as jdensity
    from tungsten_tpu.models.grids import load_grid_spec as jload
    from tungsten_tpu_torch.models.grids.grid import grid_density, load_grid_spec

    voxels = {(x, 21, 35): np.array([float(x)], np.float32) for x in range(10, 14)}
    path = str(tmp_path / "p.vdb")
    synth.write_vdb(path, [{"name": "density", "type": "float", "voxels": voxels,
                            "voxel_size": 0.5}])
    arr, info = _read_both(path)
    np.testing.assert_array_equal(info["index_min"], [10, 21, 35])
    assert arr.shape == (1, 1, 4)
    spec = {"type": "vdb", "file": path, "normalize_size": False}
    p = np.array([[12.5 * 0.5, 21.5 * 0.5, 35.5 * 0.5]], np.float32)
    got = grid_density(load_grid_spec(spec, device=torch.device("cpu")), torch.as_tensor(p)).numpy()
    np.testing.assert_allclose(got, [12.0], rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jdensity(jload(spec), jnp.asarray(p))),
                               rtol=1e-6)


@pytest.mark.parametrize("code", [0, 1, 2, 3, 4, 5, 6])
def test_read_compressed_values_codes(code):
    """Every readCompressedValues metadata code against hand-written bytes
    with a nonzero background, through both readers."""
    rng = np.random.default_rng(code)
    n = 64
    mask = rng.random(n) < 0.4
    bg = np.float32(2.0)
    active = rng.random(mask.sum()).astype(np.float32) + 0.1
    w = _W()
    w.i8(code)
    want = np.empty(n, np.float32)
    want[mask] = active
    if code == 0:
        want[~mask] = bg
    elif code == 1:
        want[~mask] = -bg
    elif code == 2:
        w.f32(7.5)
        want[~mask] = 7.5
    elif code in (3, 4, 5):
        if code == 4:
            w.f32(7.5)
            v0, v1 = 7.5, bg
        elif code == 5:
            w.f32(7.5)
            w.f32(-3.25)
            v0, v1 = 7.5, -3.25
        else:
            v0, v1 = -bg, bg
        sel = np.zeros(n, bool)
        sel[~mask] = rng.random((~mask).sum()) < 0.5
        _write_mask(w, sel)
        want[~mask & ~sel] = v0
        want[~mask & sel] = v1
    stored = want if code == 6 else active
    w.i64(-(stored.size * 4))  # the zlib framing's raw escape
    w.raw(np.asarray(stored, np.float32).tobytes())
    for mod in (tvdb, jvdb):
        got = mod._read_compressed_values(
            mod._R(w.bytes()), n, 1, mask, np.array([bg]), 224,
            mod.COMPRESS_ZIP | mod.COMPRESS_ACTIVE_MASK, False, "<mem>")
        np.testing.assert_array_equal(got[:, 0], want)


def test_vdb_grid_spec_loads(tmp_path):
    """A {"type": "vdb"} grid spec through load_grid_spec, in both packages:
    equal DenseGrid fields, and the density at a voxel's center."""
    from tungsten_tpu.models.grids import load_grid_spec as jload
    from tungsten_tpu_torch.models.grids.grid import DenseGrid, grid_density, load_grid_spec

    voxels = {(x, y, z): np.array([float(x + 1)], np.float32)
              for x in range(8) for y in range(8) for z in range(8)}
    path = str(tmp_path / "s.vdb")
    synth.write_vdb(path, [{"name": "density", "type": "float", "voxels": voxels}])
    spec = {"type": "vdb", "file": path, "density_scale": 2.0, "normalize_size": True}
    g, jgr = load_grid_spec(spec, device=torch.device("cpu")), jload(spec)
    for k in DenseGrid.FIELDS:
        np.testing.assert_array_equal(getattr(g, k).numpy(), np.asarray(getattr(jgr, k)))
    for k in DenseGrid.STATICS:
        assert getattr(g, k) == getattr(jgr, k), k
    d = grid_density(g, torch.tensor([[3.5 / 8 - 0.5, 0.5, 0.0]]))
    np.testing.assert_allclose(d.numpy(), [2.0 * 4.0], rtol=0.15)


def test_port_writer_equals_test_writer(tmp_path):
    """A grid given by voxels (with a tile, a vec3 grid, both framings)
    writes the same bytes through the port's writer as through the test's;
    the dense path equals the voxel path on a grid whose every voxel of its
    leaves is active; the cloud grid round-trips through both readers."""
    rng = np.random.default_rng(21)
    grids = [{"name": "density", "type": "float",
              "voxels": _scatter_voxels(rng, [(0, 0, 0), (24, 8, 136)]),
              "tiles": [((256, 0, 0), 128, np.array([0.5], np.float32))], "voxel_size": 0.1},
             {"name": "Cd", "type": "vec3s", "voxels": _scatter_voxels(rng, [(8, 8, 8)], 3)}]
    for version in (224, 221):
        a, b = str(tmp_path / f"a{version}.vdb"), str(tmp_path / f"b{version}.vdb")
        write_vdb(a, grids, version=version)
        synth.write_vdb(b, grids, version=version)
        assert open(a, "rb").read() == open(b, "rb").read()
    dense = rng.uniform(0.0, 1.0, (16, 8, 24)).astype(np.float32)
    vox = {(x, y, z): dense[z, y, x:x + 1] for z in range(16) for y in range(8)
           for x in range(24)}
    a, b = str(tmp_path / "dense.vdb"), str(tmp_path / "vox.vdb")
    synth.write_vdb(a, [{"name": "density", "type": "float", "dense": dense}])
    synth.write_vdb(b, [{"name": "density", "type": "float", "voxels": vox}])
    assert open(a, "rb").read() == open(b, "rb").read()
    cloud = synth.cloud_density(32)
    c = str(tmp_path / "cloud.vdb")
    synth.write_vdb(c, [{"name": "density", "type": "float", "dense": cloud}])
    arr, info = _read_both(c)
    np.testing.assert_array_equal(arr, cloud)
    np.testing.assert_array_equal(info["index_min"], [0, 0, 0])
