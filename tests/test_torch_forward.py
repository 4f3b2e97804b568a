"""The forward-lobe branch of the lockstep tracer against the JAX package:
`small-cutout`, per call and end to end.

`small-cutout` (tungsten_tpu_torch/synth.py) has the ball as a transparency
over lambert with a checker alpha, a thinsheet bubble with thin-film
interference, a forward quad standing across part of the view, a lambert
checker floor, a plastic orb, the sky and one emissive quad above the ball
and the bubble. Forward lobes send every render to trace_pass's
crossing-walk branch (`_trace_pass_forward`); regen refuses them. Both
packages flatten it on the numpy BVH build (a single-substrate wrapper and
no mixed: both build gpack3).

  * `forward_transparency` of the port's dispatch against the JAX
    `_forward_transparency` on seeded lanes over the scene's materials: rtol
    1e-5 on >= 99.9% of the elements (test_torch_bsdfs.py's bar);
  * `_trace_transparent` on the same rays over the scene (shadow-like
    segments from points on the floor to the light and beyond, and rays to
    infinity): prim equal on >= 99.9% of lanes, weight and t within rtol
    1e-5 where prim agrees;
  * render_flat(wavefront="lockstep") and "auto" (which picks lockstep here)
    against the JAX lockstep render at test_torch_render.py's bars, with
    every BSDF type hit; one lockstep pass lane by lane, with its walk
    launches: every closest-hit query is the fast walk plus its repair,
    and no any-hit walk runs (the crossing walk replaces the shadow walk);
  * tests/data/torch_port_cutout_ref.json holds the JAX render's means for
    the check on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_bsdfs import _close
from test_torch_lockstep_area import (check_image, check_means_file, jax_case,  # noqa: F401
                                      one_torch_thread)
from tungsten_tpu_torch.ops import bvh8

SIZE = "small-cutout"
TYPES = {"lambert": 0, "plastic": 10, "thinsheet": 12, "transparency": 13, "forward": 14}
N = 4000


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The scene in both packages (the JAX flatten kept as "js"), the JAX
    lockstep results and the port's renders with their hit counts."""
    import tungsten_tpu.accel.bvh as jbvh
    from tungsten_tpu.scene.flatten import flatten_scene as jflatten
    from tungsten_tpu.scene.load import load_scene as jload
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.integrators.path_tracer import count_bsdf_hits
    from tungsten_tpu_torch.renderer.render import render_flat

    c = jax_case(SIZE, tmp_path_factory, wavefronts=("lockstep",))
    mp = pytest.MonkeyPatch()
    mp.setattr(jbvh, "_NATIVE", False)
    mp.setattr(jbvh, "_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache_js")))
    c["js"] = jflatten(jload(synth.write_scene(str(tmp_path_factory.mktemp("js")), SIZE)))
    mp.undo()
    c["port"], c["hits"] = {}, {}
    for wavefront in ("lockstep", "auto"):
        with count_bsdf_hits(torch.device("cpu")) as hits:
            c["port"][wavefront] = render_flat(c["scene"], seed=c["seed"], wavefront=wavefront)
        c["hits"][wavefront] = hits
    return c


def test_scene_has_forward_lobes_and_gpack3(case):
    from tungsten_tpu_torch.integrators.path_tracer import trace_regen_batch

    scene, js = case["scene"], case["js"]
    assert scene.meta.has_forward and js.meta.has_forward
    np.testing.assert_array_equal(scene.materials.gpack3.numpy(), np.asarray(js.materials.gpack3))
    with pytest.raises(NotImplementedError, match="forward lobes"):
        trace_regen_batch(scene, (0, 0), None, None, None, 0)


def test_forward_transparency_matches_jax(case, rng):
    """The straight-through transmission of every material of the scene
    (transparency's 1 - alpha from its checker, thinsheet's interference
    transmittance, forward's 1, zero elsewhere) on seeded lanes."""
    from tungsten_tpu.integrators.path_tracer import _forward_transparency
    from tungsten_tpu_torch.models.bsdfs import dispatch as td

    scene, js = case["scene"], case["js"]
    n_mat = scene.materials.gpack2.shape[0]
    mat = rng.integers(0, n_mat, N).astype(np.int32)
    uv = rng.uniform(-0.5, 1.5, (N, 2)).astype(np.float32)
    wi = rng.normal(size=(N, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    want = np.asarray(_forward_transparency(js, jnp.asarray(mat), jnp.asarray(uv),
                                            jnp.asarray(wi)))
    uv_t = torch.as_tensor(uv)
    pre = td.gather(scene.materials, scene.textures, torch.as_tensor(mat.astype(np.int64)), uv_t)
    got = td.forward_transparency(scene.materials, pre, uv_t, torch.as_tensor(wi),
                                  scene.textures)
    _close(got, want)
    ids = {t: np.nonzero(np.asarray(scene.materials.gpack2[:, 16]) == t)[0] for t in TYPES.values()}
    fwd = np.isin(mat, np.concatenate([ids[12], ids[13], ids[14]]))
    assert (want[~fwd] == 0).all() and want[fwd].std() > 0.05
    assert (want[np.isin(mat, ids[14])] == 1.0).all()


def _rays(rng, scene, n):
    """Segments from random floor points toward random points of the light
    quad's neighbourhood (shadow rays, t < 1 of the segment scaled by its
    length) and, for the other half, rays from the floor to infinity."""
    p = np.stack([rng.uniform(-3, 3, n), np.full(n, 1e-3), rng.uniform(-2, 3, n)], -1)
    q = np.stack([rng.uniform(-2.0, 0.8, n), np.full(n, 3.6), rng.uniform(-0.8, 1.8, n)], -1)
    d = q - p
    dist = np.linalg.norm(d, axis=-1)
    d /= dist[:, None]
    far = np.where(np.arange(n) % 2 == 0, dist * (1.0 - 1e-3), np.inf)
    return (p.astype(np.float32), d.astype(np.float32), far.astype(np.float32))


def test_trace_transparent_matches_jax(case, rng):
    """The crossing walk on the same rays in both packages: the terminal
    prim on >= 99.9% of lanes, weight and t within rtol 1e-5 where it
    agrees; some lanes cross one surface, some several, some none."""
    from tungsten_tpu.integrators.path_tracer import _trace_transparent as jwalk
    from tungsten_tpu_torch.integrators.path_tracer import _trace_transparent

    scene, js = case["scene"], case["js"]
    o, d, far = _rays(rng, scene, N)
    jw, jh, _ = jwalk(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(far),
                      jnp.full((N,), -1, jnp.int32), jnp.ones((N,), bool), jnp.ones((N,), bool))
    tw, th = _trace_transparent(scene, torch.as_tensor(o), torch.as_tensor(d),
                                torch.as_tensor(far))
    jprim = np.asarray(jh.prim)
    same = th.prim.numpy() == jprim
    assert same.mean() >= 0.999, same.mean()
    _close(tw.numpy()[same], np.asarray(jw)[same])
    hit = same & (jprim >= 0)
    _close(th.t.numpy()[hit], np.asarray(jh.t)[hit])
    w = np.asarray(jw)
    crossed = (w < 1.0).any(-1) & (w > 0.0).any(-1)
    assert crossed.mean() > 0.05 and (jprim < 0).mean() > 0.05 and (jprim >= 0).mean() > 0.05


@pytest.mark.parametrize("wavefront", ["lockstep", "auto"])
def test_render_matches_jax(case, wavefront):
    """"auto" picks lockstep where a material has a forward lobe, as the
    JAX package's render does (render.py:149)."""
    img = case["port"][wavefront]
    assert img.shape == (48, 64, 3)
    check_image(img, case["lockstep"], f"{SIZE} {wavefront}")


def test_lockstep_pass_matches_jax_lane_by_lane(case):
    """One pass of the port (trace_batch with one pass) against the JAX
    package's, lane by lane; its walks: per bounce one path walk and the
    steps of the 2N crossing walk, each the fast walk plus its repair
    launch, no shadow walk of its own; more than half the lanes carry
    light; trace_batch's pass is _trace_pass_forward under the pass seed."""
    from tungsten_tpu_torch.integrators import path_tracer as pt
    from tungsten_tpu_torch.renderer.render import _lane_arrays

    c = case
    px, py, _ = (torch.as_tensor(a) for a in _lane_arrays(c["scene"].meta))
    lane = torch.arange(px.shape[0])
    seed = (c["seed"] & 0xFFFFFFFF, 0)
    steps = []
    mp = pytest.MonkeyPatch()
    walk = pt._trace_transparent
    mp.setattr(pt, "_trace_transparent", lambda *a: steps.append(0) or walk(*a))
    fast0, exact0 = bvh8.walk_fast_twin.launches, bvh8.walk_twin.launches
    rad = pt.trace_batch(c["scene"], seed, lane, px, py, 2, n_passes=1).numpy()
    n_fast = bvh8.walk_fast_twin.launches - fast0
    n_exact = bvh8.walk_twin.launches - exact0
    mp.undo()
    bounces = len(steps)  # one crossing walk a bounce that runs NEE
    assert 1 <= bounces <= c["scene"].meta.max_bounces
    assert n_exact == n_fast and bounces * 2 <= n_fast <= bounces * (1 + pt.MAX_CROSSINGS) + 1
    check_image(rad, c["one_pass"], f"{SIZE} one pass")
    assert (rad.sum(-1) > 0).mean() > 0.5
    direct = pt._trace_pass_forward(c["scene"], (seed[0], 2), lane, px, py).numpy()
    np.testing.assert_array_equal(direct, rad)


@pytest.mark.parametrize("wavefront", ["lockstep", "auto"])
def test_every_bsdf_type_is_hit(case, wavefront):
    from tungsten_tpu_torch.models.bsdfs.dispatch import type_name

    hits = case["hits"][wavefront]
    assert set(hits) == set(TYPES.values()), hits
    assert {type_name(t) for t in hits} == set(TYPES)
    assert min(hits.values()) >= 100, hits


def test_reference_means_file_matches(case):
    check_means_file(case, SIZE, wavefronts=("lockstep",))
