"""The light tracer and BDPT through participating media in both packages:
small-media's fog (a homogeneous camera medium, the davis transmittance, a
Henyey-Greenstein phase; its lamp quad beside the sky, which neither
integrator takes), on the numpy BVH build, on the CPU.

  * `render_light_traced` and `render_bdpt` at the scene's 4 spp against the
    JAX renders at equal seed, with the render tests' bars (check_image of
    test_torch_lockstep_area.py);
  * the subpaths of one BDPT pass against the JAX package's
    `_trace_subpath`: vertex counts and kinds equal (medium vertices on the
    camera subpath: the lamp's light leaves into vacuum), and the stored
    area pdfs with the media's edge pdfs folded in (pdf_fwd, pdf_rev) and
    the backward edge pdfs kept for the junctions (edge_med_bwd) within rtol 1e-4 on >= 99.5% of the stored vertices: a
    distance sample's rounding moves the later vertices of a few paths;
  * tests/data/torch_port_bdpt_ref.json holds these renders' JAX means.

Voxel media (small-media's cloud) get no JAX reference here: XLA's CPU
compile of a cloud render does not finish (test_torch_media_render.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_light_tracer import (SEED, both_scenes, check_means_file, jax_bdpt_results,
                                     jax_lt_results, jax_seed)
from test_torch_lockstep_area import check_image, one_torch_thread  # noqa: F401

PDF_BAR = 0.995


def jax_subpaths(js, seed):
    """The camera and light subpaths of the JAX BDPT sample under `seed`,
    set up as bdpt.py:536-611 sets them up: (cv fields, n_cv, lv fields,
    n_lv)."""
    from tungsten_tpu.integrators import bdpt as jb
    from tungsten_tpu.math import vecops as jvo
    from tungsten_tpu.models.cameras import camera_rays_w
    from tungsten_tpu.models.primitives import lights as jl
    from tungsten_tpu.sampling import Sampler, warps

    meta = js.meta
    w, h = meta.res_x, meta.res_y
    n = w * h

    def run(seed):
        px = jnp.tile(jnp.arange(w, dtype=jnp.int32), h)
        py = jnp.repeat(jnp.arange(h, dtype=jnp.int32), w)
        k_max = min(meta.max_bounces + 1, meta.bdpt_max_vertices)
        sampler = Sampler.create(seed, jnp.arange(n, dtype=jnp.uint32))
        u_cam, sampler = sampler.next_2d()
        u_lens, sampler = sampler.next_2d()
        o, d, cam_w = camera_rays_w(js.camera, meta, px, py, u_cam, u_lens)
        ratio = meta.res_y / meta.res_x
        cosz = jnp.maximum((d @ js.camera.rot)[..., 2], 1e-6)
        pd = js.camera.plane_dist
        pdf_cam = 1.0 / ((2.0 / pd) * (2.0 * ratio / pd)) / cosz**3
        root = dict(kind=jnp.full((n,), jb.V_CAMERA, jnp.int32),
                    p=jnp.broadcast_to(js.camera.pos, (n, 3)),
                    ng=jnp.broadcast_to(js.camera.rot[:, 2], (n, 3)),
                    nf=jnp.broadcast_to(js.camera.rot[:, 2], (n, 3)),
                    throughput=jnp.ones((n, 3)), pdf_fwd=jnp.ones((n,)),
                    dirac=jnp.zeros((n,), bool), _medium=jnp.full((n,), meta.camera_medium,
                                                                  jnp.int32))
        cv, n_cv, sampler = jb._trace_subpath(js, sampler, o, d,
                                              jnp.broadcast_to(cam_w[..., None], (n, 3)),
                                              pdf_cam, root, k_max, adjoint=False)
        u_li, sampler = sampler.next_1d()
        li = jnp.minimum((u_li * meta.n_lights).astype(jnp.int32), meta.n_lights - 1)
        pick = 1.0 / meta.n_lights
        u_tri, sampler = sampler.next_1d()
        u_pos, sampler = sampler.next_2d()
        em = jl.sample_emitter_position(js, li, u_tri, u_pos)
        u_dir, sampler = sampler.next_2d()
        d_loc = warps.cosine_hemisphere(u_dir)
        t_e, b_e = jvo.tangent_frame(em.ng)
        root = dict(kind=jnp.full((n,), jb.V_LIGHT, jnp.int32), p=em.p, ng=em.ng, nf=em.ng,
                    uv=em.uv, throughput=em.weight / pick,
                    pdf_fwd=pick / jnp.maximum(js.lights.area[li], 1e-20),
                    dirac=jnp.zeros((n,), bool), light=li, _alive=em.valid,
                    _medium=js.tri_med_ext[jnp.maximum(em.tri, 0)])
        lv, n_lv, _ = jb._trace_subpath(js, sampler, em.p,
                                        jvo.to_global(t_e, b_e, em.ng, d_loc),
                                        em.weight / pick, warps.cosine_hemisphere_pdf(d_loc),
                                        root, k_max, adjoint=True)
        return cv.tree(), n_cv, lv.tree(), n_lv

    out = jax.jit(run)(seed)
    return [{k: np.asarray(v) for k, v in o.items()} if isinstance(o, dict) else np.asarray(o)
            for o in out]


@pytest.fixture(scope="module")
def fog(tmp_path_factory):
    ts, js = both_scenes("small-media", "fog", str(tmp_path_factory.mktemp("fog")))
    out = dict(scene=ts, subpaths=jax_subpaths(js, jax_seed(0x20000)),
               **jax_lt_results(js, pass_too=False))
    out.update(jax_bdpt_results(js, pass_too=False, pyramid=False))
    return out


def test_render_light_traced_matches_jax(fog):
    from tungsten_tpu_torch.renderer.render import render_light_traced

    check_image(render_light_traced(fog["scene"], seed=SEED), fog["lt"],
                "small-media fog render_light_traced")


def test_render_bdpt_matches_jax(fog):
    from tungsten_tpu_torch.renderer.render import render_bdpt

    check_image(render_bdpt(fog["scene"], seed=SEED), fog["bdpt"], "small-media fog render_bdpt")


def test_subpath_media_edge_pdfs_match_jax(fog):
    """One pass's camera and light subpaths (recorded from the port's
    _bdpt_sample) against the JAX package's."""
    from tungsten_tpu_torch.integrators import bdpt
    from tungsten_tpu_torch.renderer.render import _bdpt_lanes

    ts = fog["scene"]
    rec = []
    trace = bdpt._trace_subpath

    def recording(*args, **kwargs):
        out = trace(*args, **kwargs)
        rec.append(out)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bdpt, "_trace_subpath", recording)
        bdpt.trace_bdpt_pass(ts, (SEED, bdpt.BDPT_PASS_SEED), *_bdpt_lanes(ts.meta, "cpu"))
    jcv, jn_cv, jlv, jn_lv = fog["subpaths"]
    # the fog is the camera's medium: the lamp's light leaves into vacuum
    # and enters no fog (no surface hands it over), so the medium vertices
    # are the camera subpath's
    assert (rec[0][0].kind == bdpt.V_MEDIUM).any()
    for label, (verts, n_verts, _), want, want_n in (("camera", rec[0], jcv, jn_cv),
                                                      ("light", rec[1], jlv, jn_lv)):
        np.testing.assert_array_equal(n_verts.numpy(), want_n)
        kind = verts.kind.numpy()
        np.testing.assert_array_equal(kind, want["kind"])
        assert (kind == bdpt.V_SURFACE).any(), label
        stored = kind != bdpt.V_INVALID
        if label == "camera":  # the fog's edges carry distance pdfs
            assert (verts.edge_med_bwd.numpy()[stored] != 1.0).mean() > 0.1
        for f in ("pdf_fwd", "pdf_rev", "edge_med_bwd"):
            a = getattr(verts, f).numpy()[stored]
            b = want[f][stored]
            close = np.isclose(a, b, rtol=1e-4, atol=1e-6)
            assert close.mean() >= PDF_BAR, f"{label} {f}: {close.mean():.5f}"


def test_reference_means_file_matches(fog):
    check_means_file(fog, "small-media-fog", ("lt", "bdpt"))
