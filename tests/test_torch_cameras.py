"""The port's cameras against the JAX package (tests/test_thinlens.py's
cases, on both packages).

One scene document (test_thinlens.py's floor, here beside a cube named
"ball") is flattened by both packages with each camera: pinhole, thinlens
with a disk, blade, bitmap and constant aperture and with the cat-eye,
equirectangular and cubemap, under several filters.

  * camera_rays_w on the same 4,096 pixels and uniforms: origins and
    directions at rtol 1e-5 / atol 1e-6, the cat-eye weight equal on
    >= 99.9% of the lanes (a lane on the diaphragm's edge may flip);
  * _sample_aperture for each kind against the JAX package, with
    test_thinlens.py's invariants (uniform disk, the blade polygon, the
    bitmap's bright quadrant);
  * the cat-eye vignettes the corners, focus_pivot sets the focus distance;
  * the disk and blade textures against the JAX eval_texture, their uv == 0
    case included;
  * the flatten's camera fields and meta (camera_type, aperture kind, blades,
    cat-eye, aovs) equal the JAX flatten's, and the JAX FlatScene's camera
    carried across (from_arrays) gives the port's rays.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_host import jax_arrays

CPU = torch.device("cpu")
BALL = {"name": "ball", "type": "cube", "bsdf": "white",
        "transform": {"position": [0.0, 0.5, -1.0], "scale": 0.3}}
CASES = {  # name -> (camera fields, filter, resolution)
    "pinhole": ({"type": "pinhole"}, "tent", [32, 24]),
    "thinlens disk": ({}, "box", [32, 24]),
    "thinlens blade": ({"aperture": {"type": "blade", "blades": 5, "angle": 0.3}},
                       "mitchell_netravali", [32, 24]),
    "thinlens bitmap": ({"aperture": "aperture.pfm"}, "gaussian", [32, 24]),
    "thinlens const": ({"aperture": 1.0}, "tent", [32, 24]),
    "thinlens cateye": ({"cateye": 0.5, "aperture_size": 0.3, "focus_pivot": "ball",
                         "aperture": {"type": "blade", "blades": 6}}, "catmull_rom", [32, 24]),
    "equirectangular": ({"type": "equirectangular"}, "lanczos", [64, 32]),
    "cubemap": ({"type": "cubemap"}, "catmull_rom", [96, 16]),
}


def _doc(cam_extra=None, rfilter="box", res=(32, 24), aovs=()):
    return {
        "media": [],
        "bsdfs": [{"name": "white", "albedo": 0.7, "type": "lambert"}],
        "primitives": [dict(BALL), {"name": "floor", "transform": {"scale": 8.0},
                                    "type": "quad", "bsdf": "white"}],
        "camera": {"tonemap": "linear", "resolution": list(res), "reconstruction_filter": rfilter,
                   "transform": {"position": [0, 1.0, 4.0], "look_at": [0, 0.5, 0],
                                 "up": [0, 1, 0]},
                   "type": "thinlens", "fov": 40, "aperture_size": 0.2, "focus_distance": 2.0,
                   **(cam_extra or {})},
        "integrator": {"type": "path_tracer", "min_bounces": 0, "max_bounces": 2},
        "renderer": {"spp": 4, "scene_bvh": True,
                     "output_buffers": [{"type": t, "output_file": f"{t}.png"} for t in aovs]},
    }


def _aperture_image(path):
    """A bitmap aperture with a bright top-right quadrant (rows top-down)."""
    from tungsten_tpu_torch.io.imageio import save_pfm

    img = np.zeros((16, 16, 3), np.float32)
    img[:8, 8:] = 1.0
    img[10:14, 2:6] = 0.05  # a dim patch the importance sampler still reaches
    save_pfm(str(path), img)


def _both(tmp_path, doc):
    """(port FlatScene, JAX FlatScene) of one document."""
    from tungsten_tpu.scene.flatten import flatten_scene as jflatten
    from tungsten_tpu.scene.load import load_scene as jload
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    _aperture_image(tmp_path / "aperture.pfm")
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(doc))
    return flatten_scene(load_scene(str(path)), CPU), jflatten(jload(str(path)))


def _inputs(meta, rng, n=4096):
    px = rng.integers(0, meta.res_x, n)
    py = rng.integers(0, meta.res_y, n)
    px[:4], py[:4] = [0, meta.res_x - 1, 0, meta.res_x - 1], [0, 0, meta.res_y - 1, meta.res_y - 1]
    return px, py, rng.uniform(size=(n, 2)).astype(np.float32), rng.uniform(size=(n, 2)).astype(
        np.float32)


def _rays(scene, js, px, py, uf, ul):
    """camera_rays_w of both packages on the same inputs, as numpy."""
    from tungsten_tpu.models.cameras.pinhole import camera_rays_w as jrays
    from tungsten_tpu_torch.models.cameras.pinhole import camera_rays_w

    mine = camera_rays_w(scene.camera, scene.meta, torch.as_tensor(px), torch.as_tensor(py),
                         torch.as_tensor(uf), torch.as_tensor(ul))
    theirs = jrays(js.camera, js.meta, jnp.asarray(px, jnp.int32), jnp.asarray(py, jnp.int32),
                   jnp.asarray(uf), jnp.asarray(ul))
    return [m.numpy() for m in mine], [np.asarray(t) for t in theirs]


@pytest.mark.parametrize("case", list(CASES))
def test_camera_rays_match_jax(tmp_path, rng, case):
    extra, rfilter, res = CASES[case]
    scene, js = _both(tmp_path, _doc(extra, rfilter, res))
    assert scene.meta.camera_type == js.meta.camera_type
    (o, d, w), (jo, jd, jw) = _rays(scene, js, *_inputs(scene.meta, rng))
    assert o.shape == d.shape == (4096, 3) and w.shape == (4096,)
    assert np.isfinite(o).all() and np.isfinite(d).all()
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(o, jo, rtol=1e-5, atol=1e-6, err_msg=case)
    np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-6, err_msg=case)
    assert (w == jw).mean() >= 0.999, case
    assert set(np.unique(w)) <= {0.0, 1.0}
    if case == "thinlens cateye":
        assert 0.05 < w.mean() < 0.95, w.mean()  # some lanes vignetted, some not
    else:
        assert (w == 1.0).all()


@pytest.mark.parametrize("kind", ["disk", "blade", "bitmap", "const"])
def test_sample_aperture_matches_jax(tmp_path, rng, kind):
    from tungsten_tpu.models.cameras.pinhole import _sample_aperture as jsample
    from tungsten_tpu_torch.models.cameras.pinhole import _sample_aperture

    extra = {"disk": {}, "blade": {"aperture": {"type": "blade", "blades": 5, "angle": 0.3}},
             "bitmap": {"aperture": "aperture.pfm"}, "const": {"aperture": 1.0}}[kind]
    scene, js = _both(tmp_path, _doc(extra))
    assert scene.meta.aperture_kind == js.meta.aperture_kind == kind
    u = rng.uniform(size=(4096, 2)).astype(np.float32)
    a = _sample_aperture(scene.camera, scene.meta, torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(a, np.asarray(jsample(js.camera, js.meta, jnp.asarray(u))),
                               rtol=1e-5, atol=1e-6)
    if kind == "disk":  # uniform over the disk: mean radius 2/3 R
        r = np.linalg.norm(a - 0.5, axis=-1)
        assert np.all(r <= 0.5 + 1e-6) and abs(r.mean() - (2.0 / 3.0) * 0.5) < 0.01
    elif kind == "blade":  # inside the pentagon, left of each ccw edge
        g = a * 2.0 - 1.0
        ang = 0.3 + np.arange(6) * (2 * np.pi / 5)
        vx, vy = np.cos(ang), np.sin(ang)
        for k in range(5):
            ex, ey = vx[k + 1] - vx[k], vy[k + 1] - vy[k]
            cross = ex * (g[:, 1] - vy[k]) - ey * (g[:, 0] - vx[k])
            assert np.all(cross >= -1e-4), (k, cross.min())
        assert np.abs(g.mean(0)).max() < 0.02
    elif kind == "bitmap":  # the bright top-right quadrant takes nearly all samples
        assert ((a[:, 0] >= 0.5 - 1e-5) & (a[:, 1] >= 0.5 - 1e-5)).mean() > 0.97
        assert scene.camera.ap_dist.shape == tuple(js.camera.ap_dist.shape) == (16, 16)
    else:
        np.testing.assert_array_equal(a, u)


def test_cateye_vignettes_corners(tmp_path, rng):
    """cateye > 0 kills the rays whose diaphragm point leaves the aperture:
    the corner pixels lose throughput, the centre keeps it
    (ThinlensCamera.cpp:119-124); without it nothing is vignetted."""
    from tungsten_tpu_torch.models.cameras.pinhole import camera_rays_w

    scene, _ = _both(tmp_path, _doc({"cateye": 1.0}))
    assert scene.meta.cateye == 1.0
    n = 1024
    uf, ul = (torch.as_tensor(rng.uniform(size=(n, 2)).astype(np.float32)) for _ in range(2))
    centre = (torch.full((n,), 16), torch.full((n,), 12))
    corner = (torch.zeros(n, dtype=torch.int64), torch.zeros(n, dtype=torch.int64))
    w_c = camera_rays_w(scene.camera, scene.meta, *centre, uf, ul)[2]
    w_e = camera_rays_w(scene.camera, scene.meta, *corner, uf, ul)[2]
    assert w_c.mean() > w_e.mean() and w_e.mean() < 0.9
    plain, _ = _both(tmp_path, _doc())
    assert camera_rays_w(plain.camera, plain.meta, *corner, uf, ul)[2].min() == 1.0


def test_focus_pivot_sets_focus_distance(tmp_path):
    """focus_pivot: |the pivot's transform origin - the camera position|
    (ThinlensCamera.cpp:206-217); without it the JSON focus_distance."""
    scene, js = _both(tmp_path, _doc({"focus_pivot": "ball"}))
    want = np.linalg.norm(np.asarray([0, 0.5, -1.0]) - np.asarray([0, 1.0, 4.0]))
    assert abs(float(scene.camera.focus_dist) - want) < 1e-5
    assert float(scene.camera.focus_dist) == float(js.camera.focus_dist)
    plain, _ = _both(tmp_path, _doc())
    assert float(plain.camera.focus_dist) == 2.0


def test_disk_and_blade_textures_match_jax(rng):
    """The aperture textures as scene textures: texture_from_spec's ids and
    rows, and eval_texture against the JAX package's on random uvs, the
    centre, the uv == 0 corner (the blade's special case) and the edges."""
    from tungsten_tpu.models.textures import textures as jt
    from tungsten_tpu_torch.models.textures import textures as tt

    specs = [{"type": "disk", "value": [0.5, 1.0, 2.0]}, {"type": "blade"},
             {"type": "blade", "blades": 5, "angle": 0.3, "value": 3.0},
             {"type": "blade", "blades": 2, "value": 1.0}, 0.25]
    tb, jb = tt.TextureBuilder(), jt.TextureBuilder()
    ids = [tt.texture_from_spec(s, tb) for s in specs]
    assert ids == [jt.texture_from_spec(s, jb) for s in specs]
    arrays, table = tb.build_arrays(), jb.build()
    np.testing.assert_array_equal(arrays["tpack"], np.asarray(table.tpack))
    mine = tt.TextureTable.from_arrays(arrays["tpack"], arrays["data"], arrays["data4"], CPU)
    assert mine.present == table.present == (0, 3, 4)
    uv = np.concatenate([rng.uniform(size=(4096, 2)), [[0.0, 0.0], [0.5, 0.5], [1.0, 0.5],
                                                       [0.5, 0.0], [0.02, 0.5]]]).astype(np.float32)
    tex = rng.integers(0, len(specs), len(uv))
    got = tt.eval_texture(mine, torch.as_tensor(tex), torch.as_tensor(uv)).numpy()
    want = np.asarray(jt.eval_texture(table, jnp.asarray(tex, jnp.int32), jnp.asarray(uv)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    corner = tt.eval_texture(mine, torch.tensor([1, 2]), torch.zeros(2, 2)).numpy()
    np.testing.assert_array_equal(corner, [[1.0] * 3, [3.0] * 3])  # the uv == 0 case
    for i in range(len(specs)):
        np.testing.assert_allclose(tb.average(i), jb.average(i), rtol=1e-6)


def test_flatten_camera_fields_match_jax(tmp_path):
    """The flatten's camera arrays and meta equal the JAX flatten's, for
    each case; the JAX FlatScene carried across gives the port's rays."""
    import dataclasses

    from tungsten_tpu_torch.models.cameras.pinhole import camera_rays_w
    from tungsten_tpu_torch.scene.flatten import CameraParams, from_arrays

    for case, (extra, rfilter, res) in CASES.items():
        aovs = ("depth", "normal", "albedo") if case == "thinlens blade" else ()
        scene, js = _both(tmp_path, _doc(extra, rfilter, res, aovs))
        for f in dataclasses.fields(CameraParams):
            mine, theirs = getattr(scene.camera, f.name), getattr(js.camera, f.name)
            if f.name == "ap_dist":
                assert (mine is None) == (theirs is None) == (case != "thinlens bitmap")
                if mine is not None:
                    np.testing.assert_array_equal(mine.alias_pack.numpy(),
                                                  np.asarray(theirs.alias_pack))
                    np.testing.assert_array_equal(mine.joint_pdf.numpy(),
                                                  np.asarray(theirs.joint_pdf))
            else:
                np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs), err_msg=f.name)
        for k in ("camera_type", "filter", "aperture_kind", "ap_blades", "cateye", "aovs"):
            assert getattr(scene.meta, k) == getattr(js.meta, k), (case, k)
        if aovs:
            assert scene.meta.aovs == (("depth", "depth.png", ""), ("normal", "normal.png", ""),
                                       ("albedo", "albedo.png", ""))
        carried = from_arrays(jax_arrays(js), js.meta, CPU)
        px, py = torch.arange(64) % res[0], torch.arange(64) // 4 % res[1]
        u = torch.rand(64, 2, generator=torch.Generator().manual_seed(1))
        for a, b in zip(camera_rays_w(scene.camera, scene.meta, px, py, u, u.flip(-1)),
                        camera_rays_w(carried.camera, carried.meta, px, py, u, u.flip(-1))):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
