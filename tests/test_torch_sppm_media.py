"""SPPM's volume photons in both packages, on the CPU: small-box fog (the
box filled with synth.FOG, a homogeneous medium with the davis
transmittance and a Henyey-Greenstein phase: the camera's medium and every
prim's), on the numpy BVH build.

  * `trace_photons`' media records lane by lane against the JAX package's
    (pass 0's seed): the volume photons, the short beams (with the points
    mode's gate and the plane modes' single-scatter gate) and the two plane
    slots a vertex, by test_torch_sppm.py's bars (the powers by rtol 1e-3:
    the davis transmittance's distance samples);
  * the gathers on the JAX package's grids and plane table, on 2,048 rays
    from inside the box to their first hit: `_volume_beam_gather` (K7
    points), `_beam1d_gather` (K7 beams), `_plane0d_gather` and
    `_plane1d_gather`, per lane within rtol 1e-4 of the lane's largest
    channel on >= 99.9% of the lanes;
  * the beams' global round count: the same short rays gathered alone and
    beside one long ray give other estimates, in both packages alike (a
    caveat of the reference, ROADMAP §3);
  (the renders in the fog: test_torch_sppm_fog.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_light_tracer import SEED, jax_seed
from test_torch_lockstep_area import one_torch_thread  # noqa: F401
from test_torch_sppm import (BAR, POS_POW_DIR_ATOL, RTOL, check_records, lane_close_share,
                             sppm_scenes)

N_RAYS = 2048
N_PHOTONS = 1 << 12  # the photon paths of the records and grids
FOG_RTOLS = (RTOL, 1e-3, RTOL)  # a record's position, power, direction
VARIANT = "progressive_photon_map+fog"


@pytest.fixture(scope="module")
def fog(tmp_path_factory):
    return sppm_scenes(VARIANT, str(tmp_path_factory.mktemp("fog")))


@pytest.fixture(scope="module")
def records(fog):
    """The JAX package's photon records of pass 0, with and without planes,
    and the port's."""
    from tungsten_tpu.integrators.photon_map import trace_photons as jtrace
    from tungsten_tpu_torch.integrators.photon_map import trace_photons

    ts, js = fog
    n = N_PHOTONS
    out = {}
    for planes in (False, True):
        out["jax", planes] = jtrace(js, jax_seed(0x30000), jnp.arange(n, dtype=jnp.uint32),
                                    k_max=6, want_planes=planes)
        out["port", planes] = trace_photons(ts, (SEED, 0x30000), torch.arange(n), k_max=6,
                                            want_planes=planes)
    return out


@pytest.fixture(scope="module")
def rays(fog):
    """N_RAYS rays from points inside the box in random directions, to
    their first hit (the JAX package's walk): o, d, seg, medium, active."""
    from tungsten_tpu.integrators.path_tracer import _intersect

    js = fog[1]
    gen = np.random.default_rng(21)
    o = gen.uniform([-3.8, 0.2, -2.3], [3.8, 3.8, 7.3], (N_RAYS, 3)).astype(np.float32)
    d = gen.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    hit = _intersect(js, jnp.asarray(o), jnp.asarray(d), jnp.full((N_RAYS,), 1e-4),
                     jnp.full((N_RAYS,), 3e38))
    seg = np.where(np.asarray(hit.prim) >= 0, np.asarray(hit.t), 30.0).astype(np.float32)
    active = gen.random(N_RAYS) < 0.9
    medium = np.full(N_RAYS, js.meta.camera_medium, np.int32)
    return o, d.astype(np.float32), seg, medium, active


@pytest.fixture(scope="module")
def grids(records):
    """The JAX package's volume grid, beam grid and plane table of the
    records, at small-box's first volume radius."""
    from tungsten_tpu.integrators import photon_map as jpm

    vol = records["jax", False][1]
    beams = records["jax", False][2]
    r = 0.27
    return {"r": r,
            "points": jpm.build_photon_grid(*vol[:4], 2.0 * r, bounce=vol[4])[:3],
            "beams": jpm.build_beam_grid(*beams, jnp.float32(r))[:3],
            "planes": jpm.build_plane_list(*records["jax", True][3], seed=0)[:2]}


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("planes", [False, True])
def test_media_records_match_jax(records, planes):
    surf_p, vol_p, beams_p, planes_p = records["port", planes]
    surf_j, vol_j, beams_j, planes_j = records["jax", planes]
    # in the fog a photon's power takes every segment's distance-sample
    # weight through the davis transmittance: rtol 1e-3 (rtol 1e-4 holds on
    # 99.89% of the surface photons)
    check_records([x.numpy() for x in surf_p[:3]], surf_j[:3], surf_p[3].numpy(), surf_j[3],
                  "surface photons", POS_POW_DIR_ATOL, FOG_RTOLS)
    check_records([x.numpy() for x in vol_p[:3]], vol_j[:3], vol_p[3].numpy(), vol_j[3],
                  "volume photons", POS_POW_DIR_ATOL, FOG_RTOLS)
    check_records([beams_p[i].numpy() for i in (0, 1, 2, 3)], [beams_j[i] for i in (0, 1, 2, 3)],
                  beams_p[5].numpy(), beams_j[5], "beams", (1e-4, 1e-5, 1e-4, 1e-6),
                  (RTOL,) * 3 + (1e-3,))
    np.testing.assert_array_equal(beams_p[4].numpy()[np.asarray(beams_j[5])],
                                  np.asarray(beams_j[4])[np.asarray(beams_j[5])])
    if planes:
        # a plane's power multiplies its vertex's power by two flights, the
        # continued one through the davis transmittance's inverse: rtol 1e-3
        check_records([planes_p[i].numpy() for i in (0, 1, 2, 3, 4)],
                      [planes_j[i] for i in (0, 1, 2, 3, 4)], planes_p[5].numpy(), planes_j[5],
                      "planes", (1e-4, 1e-4, 1e-5, 1e-4, 1e-6), (RTOL,) * 4 + (1e-3,))
        np.testing.assert_array_equal(planes_p[6].numpy(), np.asarray(planes_j[6]))
        assert np.asarray(planes_j[5]).reshape(-1, 6, 2).any((0, 1)).all()  # both slots
    else:
        assert planes_p is None


def jax_gather(js, name, args, grid, r, **kw):
    from tungsten_tpu.integrators import photon_map as jpm

    fn = getattr(jpm, name)
    if name == "_plane1d_gather":
        return np.asarray(fn(js, *args, *grid, jnp.float32(r), 1, **kw))
    if name == "_plane0d_gather":
        return np.asarray(fn(js, *args, *grid, 1, **kw))
    return np.asarray(fn(js, *args, *grid, jnp.float32(r), 1))


def port_gather(ts, name, args, grid, r, **kw):
    from tungsten_tpu_torch.integrators import photon_map as tpm

    fn = getattr(tpm, name)
    grid = tuple(t(x) for x in grid)
    if name == "_plane1d_gather":
        return fn(ts, *args, *grid, r, 1, **kw).numpy()
    if name == "_plane0d_gather":
        return fn(ts, *args, *grid, 1, **kw).numpy()
    return fn(ts, *args, *grid, r, 1).numpy()


@pytest.mark.parametrize("name,grid", [("_volume_beam_gather", "points"),
                                       ("_beam1d_gather", "beams"),
                                       ("_plane0d_gather", "planes"),
                                       ("_plane1d_gather", "planes")])
def test_gathers_match_jax_per_lane(fog, rays, grids, name, grid):
    from tungsten_tpu_torch.ops import photon_walk

    ts, js = fog
    o, d, seg, medium, active = rays
    kw = {"seed_u": 0x40000} if grid == "planes" else {}
    want = jax_gather(js, name, [jnp.asarray(x) for x in rays], grids[grid], grids["r"],
                      **({"seed_u": jnp.uint32(0x40000)} if kw else {}))
    before = photon_walk.walk_twin.launches
    got = port_gather(ts, name, [t(o), t(d), t(seg), t(medium).long(), t(active)], grids[grid],
                      grids["r"], **kw)
    assert photon_walk.walk_twin.launches == before + (grid != "planes")
    lit = np.abs(want).sum(-1) > 0
    assert lit[active].mean() > 0.3 and not lit[~active].any()
    share = lane_close_share(got, want)
    assert share >= BAR, f"{name}: {share:.5f} of the lanes within the bar"


def test_beam_rounds_are_global(fog, rays, grids):
    """The beams' DDA walks every lane as far as the longest: the short
    rays' estimates change when a long ray walks beside them, the same in
    both packages (photon_map.py:560-562)."""
    from tungsten_tpu.integrators import photon_map as jpm
    from tungsten_tpu_torch.integrators import photon_map as tpm
    from tungsten_tpu_torch.ops import photon_walk

    ts, js = fog
    o, d, seg, medium, active = (np.array(x) for x in rays)
    k = 256
    seg[:k] = np.minimum(seg[:k], 0.6)
    active[:k] = True
    out = {}
    for long_ray in (False, True):
        sel = np.r_[np.arange(k), [k]] if long_ray else np.arange(k)
        s = seg[sel].copy()
        if long_ray:
            s[-1] = 12.0
        args = (o[sel], d[sel], s, medium[sel], active[sel])
        out["jax", long_ray] = np.asarray(jpm._beam1d_gather(
            js, *(jnp.asarray(x) for x in args), *grids["beams"], jnp.float32(grids["r"]),
            1))[:k]
        out["port", long_ray] = tpm._beam1d_gather(
            ts, *(t(x) for x in args[:3]), t(args[3]).long(), t(args[4]), *(t(x) for x in
                                                                             grids["beams"]),
            grids["r"], 1).numpy()[:k]
        out["rounds", long_ray] = photon_walk.walk_twin.work["rounds"]
    assert out["rounds", True] > out["rounds", False]
    grew = np.abs(out["jax", True] - out["jax", False]).sum(-1) > 0
    assert grew.mean() > 0.05, grew.mean()
    for long_ray in (False, True):
        share = lane_close_share(out["port", long_ray], out["jax", long_ray])
        assert share >= BAR, f"long ray {long_ray}: {share:.5f} of the lanes within the bar"
