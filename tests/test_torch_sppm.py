"""SPPM on surfaces in both packages, on the CPU: small-box and its caustic
variant (the ball a smooth dielectric), on the numpy BVH build, 2^14
photons an iteration (synth.PHOTON_COUNT).

  * `trace_photons` lane by lane against the JAX package's (pass 0's
    seed): the photons' validity on >= 99.9% of the records, their
    position, power and direction within rtol 1e-4 (and an absolute 1e-4,
    1e-6, 1e-5) on >= 99.9% of the records both keep;
  * `gather_pass` on the JAX package's own photon grid, with the fixed
    radius and with the kNN radius (K = 4): per lane within rtol 1e-4 on
    >= 99.9% of the lanes (XLA contracts multiply-adds on the CPU, and
    sums the candidates in its own order, so a photon at the radius can
    flip), K7's twin launched;
  * `render_sppm` (SPP = 2 iterations) through progressive_photon_map and
    photon_map (the scene's kNN count) on both scenes against the JAX
    renders at equal seed, with the render tests' bars (check_image of
    test_torch_lockstep_area.py), the overflow totals equal;
  * a kNN count of 10,000 gives the fixed-radius image bit for bit
    (tests/test_path_tracer.py::test_knn_gather_matches_fixed_radius);
  * tests/data/torch_port_sppm_ref.json holds the JAX renders' channel
    means and overflow totals, here and in test_torch_sppm_media.py, for
    the check on the card; `PYTHONPATH=. python tests/test_torch_sppm.py`
    writes it anew.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_light_tracer import SEED, jax_seed
from test_torch_lockstep_area import DATA, check_image, one_torch_thread  # noqa: F401

REF = os.path.join(DATA, "torch_port_sppm_ref.json")
BAR = 0.999
RTOL, ATOL = 1e-4, 1e-6
SPP = 2  # SPPM iterations of the renders held to the JAX package's
POS_POW_DIR_ATOL = (1e-4, ATOL, 1e-5)  # a record's position, power, direction
FOG_RES = [32, 24]  # the fog renders' resolution: the plane sweeps cost lanes x planes
FOG_PHOTONS = 1 << 12  # the fog renders' photons an iteration: the CPU's time
FULL_PHOTONS = 1 << 18  # photons an iteration of box-synth's SPPM renders (synth.PHOTON_COUNT)
# reference key -> (scene variant, integrator, volume photon type)
RENDERS = {
    "ppm": ("progressive_photon_map", "progressive_photon_map", "points"),
    "pm": ("photon_map", "photon_map", "points"),
    "caustic-ppm": ("progressive_photon_map+caustic", "progressive_photon_map", "points"),
    "caustic-pm": ("photon_map+caustic", "photon_map", "points"),
    "fog-points": ("progressive_photon_map+fog", "progressive_photon_map", "points"),
    "fog-beams": ("progressive_photon_map+fog", "progressive_photon_map", "beams"),
    "fog-planes": ("progressive_photon_map+fog", "progressive_photon_map", "planes"),
    "fog-planes_1d": ("progressive_photon_map+fog", "progressive_photon_map", "planes_1d"),
}


def sppm_scenes(variant, tmp_dir):
    """small-box `variant` flattened by both packages on the numpy BVH build
    (the fog at FOG_RES): (the port's scene on the CPU, the JAX scene)."""
    import tungsten_tpu.accel.bvh as jbvh
    import tungsten_tpu_torch.accel.bvh as tbvh
    from tungsten_tpu.scene.flatten import flatten_scene as jflatten
    from tungsten_tpu.scene.load import load_scene as jload
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbvh, "_NATIVE", False)
        mp.setattr(tbvh, "_NATIVE", False)
        mp.setattr(jbvh, "_CACHE_DIR", os.path.join(tmp_dir, "bvh_cache"))
        path = synth.write_scene(tmp_dir, "small-box", variant)
        if "fog" in variant:
            with open(path) as f:
                doc = json.load(f)
            doc["camera"]["resolution"] = FOG_RES
            with open(path, "w") as f:
                json.dump(doc, f)
        return flatten_scene(load_scene(path), torch.device("cpu")), jflatten(jload(path))


def photons_of(variant):
    """The photons an iteration of a reference render: the scene's
    photon_count, FOG_PHOTONS in the fog."""
    from tungsten_tpu_torch import synth

    return FOG_PHOTONS if "fog" in variant else synth.PHOTON_COUNT["small-box"]


def sppm_kwargs(variant, integrator, vtype):
    """render_sppm's arguments as the CLI reads them from the scene (the
    fog's photons FOG_PHOTONS)."""
    from tungsten_tpu_torch import synth

    return dict(spp=SPP, photons_per_iter=photons_of(variant), volume_photon_type=vtype,
                gather_count=synth.GATHER_COUNT["small-box"] if integrator == "photon_map"
                else None)


def jax_render(js, key):
    """The JAX render_sppm of reference `key` on js: (image, overflow)."""
    from tungsten_tpu.renderer.render import render_sppm

    img = np.asarray(render_sppm(js, seed=SEED, **sppm_kwargs(*RENDERS[key])))
    return img, render_sppm.last_overflow


def port_render(ts, key):
    from tungsten_tpu_torch.renderer.render import render_sppm

    img = render_sppm(ts, seed=SEED, **sppm_kwargs(*RENDERS[key]))
    return img, render_sppm.last_overflow


def fog_median_ratio(img, points):
    """The per-channel median of img / points over the pixels points shows
    above 0.01 (tests/test_path_tracer.py:197-288)."""
    mask = points.max(-1) > 0.01
    return np.median(img[mask] / np.maximum(points[mask], 1e-9), axis=0)


def close_share(a, b, rtol=RTOL, atol=ATOL):
    """The share of rows (lanes) whose every entry is within the bar."""
    ok = np.abs(a - b) <= atol + rtol * np.abs(b)
    return ok.reshape(ok.shape[0], -1).all(-1).mean()


def lane_close_share(a, b, rtol=RTOL, atol=ATOL):
    """The share of lanes whose largest channel difference is within the
    bar of their largest channel: a gather's three channels are one
    estimate (planes_1d's control variate subtracts two large sums channel
    by channel, and a channel can cancel to near 0)."""
    big = np.abs(b).max(-1)
    return (np.abs(a - b).max(-1) <= atol + rtol * big).mean()


def check_records(got, want, valid_got, valid_want, label, atols, rtols=None):
    """Records of one kind lane by lane: validity on >= BAR, the kept
    records' fields within their `rtols` (RTOL by default) and `atols` on
    >= BAR of those both keep. A photon's one-ulp differences compound
    bounce by bounce (off the rough copper ball most), so positions take an
    absolute 1e-4, 1e-5 of the box's extent."""
    vg, vw = np.asarray(valid_got), np.asarray(valid_want)
    assert vw.any(), label
    assert (vg == vw).mean() >= BAR, f"{label}: validity agrees on {(vg == vw).mean():.5f}"
    both = vg & vw
    for i, (a, b, atol, rtol) in enumerate(zip(got, want, atols, rtols or [RTOL] * len(atols))):
        share = close_share(np.asarray(a)[both], np.asarray(b)[both], rtol=rtol, atol=atol)
        assert share >= BAR, f"{label} field {i}: {share:.5f} of the records within the bar"


def jax_gather(js, seed1, photons, grid_kw, knn):
    """The JAX gather_pass of pass `seed1` over js's lanes (render_sppm's
    lane order) on the given grid arguments."""
    from tungsten_tpu.integrators.photon_map import gather_pass

    w, h = js.meta.res_x, js.meta.res_y
    px = jnp.tile(jnp.arange(w, dtype=jnp.int32), h)
    py = jnp.repeat(jnp.arange(h, dtype=jnp.int32), w)
    return np.asarray(gather_pass(js, jax_seed(seed1), jnp.arange(w * h, dtype=jnp.uint32), px,
                                  py, **grid_kw, n_emitted=jnp.float32(photons), knn_count=knn))


def port_gather(ts, seed1, photons, grid_kw, knn):
    from tungsten_tpu_torch.integrators.photon_map import gather_pass

    w, h = ts.meta.res_x, ts.meta.res_y
    px = torch.arange(w).repeat(h)
    py = torch.arange(h).repeat_interleave(w)
    kw = {k: torch.as_tensor(np.array(v)) if np.ndim(v) else float(np.asarray(v))
          for k, v in grid_kw.items()}
    return gather_pass(ts, (SEED, seed1), torch.arange(w * h), px, py, **kw, n_emitted=photons,
                       knn_count=knn).numpy()


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    return {v: sppm_scenes(v, str(tmp_path_factory.mktemp(v.replace("+", "-"))))
            for v in ("progressive_photon_map", "progressive_photon_map+caustic")}


@pytest.fixture(scope="module")
def photons(scenes):
    """small-box's photons of pass 0 in the JAX package, and their grid at
    the render's first radius."""
    from tungsten_tpu.integrators.photon_map import build_photon_grid, trace_photons
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.renderer.render import _scene_diagonal

    ts, js = scenes["progressive_photon_map"]
    n = synth.PHOTON_COUNT["small-box"]
    surf, _, _, _ = trace_photons(js, jax_seed(0x30000), jnp.arange(n, dtype=jnp.uint32),
                                  k_max=min(js.meta.max_bounces, 6))
    radius = _scene_diagonal(ts) * 5e-3
    ext = np.asarray(js.bvh.node_max[0] - js.bvh.node_min[0])
    assert radius == float(np.linalg.norm(ext)) * 5e-3  # the port's diagonal is the JAX one
    pack, starts, counts, _ = build_photon_grid(*surf[:4], radius, bounce=surf[4])
    return {"surf": surf, "n": n, "radius": radius,
            "grid": dict(pack=pack, starts=starts, counts=counts, radius=jnp.float32(radius))}


@pytest.fixture(scope="module")
def renders(scenes):
    out = {}
    for key in ("ppm", "pm", "caustic-ppm", "caustic-pm"):
        variant = "progressive_photon_map+caustic" if key.startswith("caustic") else (
            "progressive_photon_map")
        out[key] = jax_render(scenes[variant][1], key)
    return out


def test_trace_photons_matches_jax(scenes, photons):
    from tungsten_tpu_torch.integrators.photon_map import trace_photons
    from tungsten_tpu_torch.ops import bvh8

    ts = scenes["progressive_photon_map"][0]
    fast = bvh8.walk_fast_twin.launches
    surf, vol, beams, planes = trace_photons(ts, (SEED, 0x30000), torch.arange(photons["n"]),
                                             k_max=min(ts.meta.max_bounces, 6))
    assert bvh8.walk_fast_twin.launches > fast
    assert vol is None and beams is None and planes is None
    want = photons["surf"]
    np.testing.assert_array_equal(surf[4].numpy(), np.asarray(want[4]))
    check_records([x.numpy() for x in surf[:3]], want[:3], surf[3].numpy(), want[3],
                  "surface photons", POS_POW_DIR_ATOL)
    assert surf[3].numpy().mean() > 0.2  # most paths deposit


@pytest.mark.parametrize("knn", [None, 4])
def test_gather_pass_matches_jax(scenes, photons, knn):
    from tungsten_tpu_torch.ops import photon_walk

    ts, js = scenes["progressive_photon_map"]
    want = jax_gather(js, 0x40000, photons["n"], photons["grid"], knn)
    before = photon_walk.walk_twin.launches
    got = port_gather(ts, 0x40000, photons["n"], photons["grid"], knn)
    assert photon_walk.walk_twin.launches == before + (2 if knn else 1)
    assert (want.sum(-1) > 0).mean() > 0.5
    share = close_share(got, want)
    assert share >= BAR, f"{share:.5f} of the lanes within the bar"


@pytest.mark.parametrize("key", ["ppm", "pm", "caustic-ppm", "caustic-pm"])
def test_render_sppm_matches_jax(scenes, renders, key):
    variant = "progressive_photon_map+caustic" if key.startswith("caustic") else (
        "progressive_photon_map")
    img, ovf = port_render(scenes[variant][0], key)
    want, want_ovf = renders[key]
    assert img.shape == (48, 64, 3)
    check_image(img, want, f"small-box {key}")
    assert ovf == want_ovf


def test_knn_of_10000_is_the_fixed_radius(scenes):
    from tungsten_tpu_torch.renderer.render import render_sppm

    ts = scenes["progressive_photon_map"][0]
    kw = dict(spp=2, seed=42, photons_per_iter=1 << 12)
    fixed = render_sppm(ts, **kw)
    np.testing.assert_array_equal(render_sppm(ts, gather_count=10_000, **kw), fixed)
    assert (fixed.reshape(-1, 3).mean(0) > 0.01).all()


def test_reference_means_file_matches(renders):
    with open(REF) as f:
        data = json.load(f)
    assert data["seed"] == SEED and data["fog_resolution"] == FOG_RES and data["spp"] == SPP
    for key, (img, ovf) in renders.items():
        np.testing.assert_allclose(data["channel_means"][key], img.reshape(-1, 3).mean(0),
                                   rtol=1e-4, err_msg=key)
        assert data["overflow"][key] == ovf


if __name__ == "__main__":  # write tests/data/torch_port_sppm_ref.json anew
    import tempfile

    jax.config.update("jax_platforms", "cpu")
    means, overflow, imgs = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        flat = {}
        for key, (variant, _, _) in RENDERS.items():
            if variant not in flat:
                flat[variant] = sppm_scenes(variant,
                                            os.path.join(tmp, variant.replace("+", "-")))[1]
            img, ovf = jax_render(flat[variant], key)
            means[key] = img.reshape(-1, 3).mean(0).tolist()
            overflow[key] = ovf
            imgs[key] = img
            print(key, means[key], ovf, flush=True)
        ratios = {k: fog_median_ratio(imgs[k], imgs["fog-points"]).tolist()
                  for k in ("fog-beams", "fog-planes", "fog-planes_1d")}
        # the same ratios at the photon count of chip_smoke's full-width
        # renders (the beams' image depends on it, ROADMAP §3); minutes here
        from tungsten_tpu.renderer.render import render_sppm
        at = {}
        for v in ("points", "beams", "planes", "planes_1d"):
            at[v] = np.asarray(render_sppm(flat["progressive_photon_map+fog"], spp=SPP, seed=SEED,
                                           photons_per_iter=FULL_PHOTONS, volume_photon_type=v))
        at = {f"fog-{v}": fog_median_ratio(at[v], at["points"]).tolist()
              for v in ("beams", "planes", "planes_1d")}
        at["photons"] = FULL_PHOTONS
    print(ratios, at)
    with open(REF, "w") as f:
        json.dump({"seed": SEED, "spp": SPP, "scene": "small-box", "fog_resolution": FOG_RES,
                   "variants": {k: list(v) for k, v in RENDERS.items()},
                   "photons": {k: photons_of(v[0]) for k, v in RENDERS.items()},
                   "channel_means": means, "overflow": overflow,
                   "fog_median_ratio": ratios, "fog_median_ratio_at": at}, f, indent=1)
