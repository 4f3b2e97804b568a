"""Render driver: spp-batched accumulation, adaptive sampling, AOVs,
checkpoint / resume.

Port of tungsten_tpu/renderer/render.py (render_buffers:102-215,
_tile_error, _sample_pixels_by_tile, render_flat, render_scene,
render_light_traced, render_bdpt, render_bdpt_pyramid, render_sppm) with its
`wavefront` argument: "regen" is the regenerating wavefront
(trace_regen_batch, per-pixel sums from the device), "lockstep" the
lockstep one (trace_batch, per-lane sums accumulated through the lane ->
pixel map), "auto" the JAX package's rule: regen on one device unless a
material has a forward lobe, lockstep then and under a device mesh.
Batches are capped by a static `passes_per_batch`, which is what the JAX
package does off the TPU (its DispatchGovernor probes a TPU watchdog and is
not ported). A pass traces `samples_per_pass` samples a pixel; the pass
index keys every sample's RNG stream, so a render resumed from a state file
equals one rendered straight through.

Adaptive sampling mirrors PathTraceIntegrator.cpp:44-134: once every pixel
has ADAPTIVE_THRESHOLD_SPP samples, each pass spends its budget of n_pix *
samples_per_pass lockstep lanes on pixels drawn by a per-4x4-tile relative
error (two-buffer variance) with a 95th-percentile clamp and neighbour
dilation.

`mesh` (parallel/mesh.py, one process a device under torch.distributed)
shards every render's lanes over the ranks, as the JAX package's does:
each rank traces its contiguous block of the global lanes (global lane
ids, so the same RNG streams), per-lane results are all-gathered in rank
order and splat buffers summed, and every rank returns the whole image. A
sharded lockstep render equals the one-process render bit for bit; the
splatting integrators agree up to the reassociated sums. The regenerating
wavefront refills its lanes from a shared pixel queue and runs on one
device only (wavefront="regen" under a mesh raises).

Spans (utils/trace.py): `frame` a render_buffers or render_sppm call, in it
`driver.lanes` (the lane -> pixel maps, uploaded under `sync.h2d.lanes`),
`driver.readback` (a batch's sums read to the host, `sync.readback`) and
`driver.accumulate` (OutputBuffers' numpy), and SPPM's `sppm.iter`.

The resume state's extra carries `res` ([w, h]) beside `next_pass`, which
the denoiser's full-NFOR mode reads (a departure from the JAX package,
whose renderer leaves it out and whose denoiser cannot read its own
renderer's state files).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..integrators.path_tracer import trace_batch, trace_regen_batch
from ..models.cameras.tonemap import tonemap
from ..parallel import mesh as pm
from ..scene.flatten import FlatScene, flatten_scene
from ..scene.load import load_scene
from ..utils import trace
from .framebuffer import OutputBuffers

DEFAULT_SEED = 0xBA5EBA11
ADAPTIVE_THRESHOLD_SPP = 16  # PathTraceIntegrator.hpp:27-29
TILE = 16  # lanes are ordered in 16x16 image tiles (render.py _lane_arrays)


def _lane_arrays(meta, m: int = 1):
    """Lane -> pixel maps in the JAX package's 16x16-tile order, the tile
    order repeated m times (m samples a pixel a pass): (px, py, pixel
    index). The order decides which path id, and so which RNG stream, each
    pixel's samples receive; it is kept for per-pixel parity."""
    w, h = meta.res_x, meta.res_y
    xs, ys = np.meshgrid(np.arange(w, dtype=np.int64), np.arange(h, dtype=np.int64))
    tile_id = (ys // TILE) * ((w + TILE - 1) // TILE) + (xs // TILE)
    order = np.argsort(tile_id.ravel(), kind="stable")
    px = np.tile(xs.ravel()[order], m)
    py = np.tile(ys.ravel()[order], m)
    return px, py, py * w + px


def _gather_out(mesh, out, n):
    """A tracer's per-lane output, (rad) or (rad, {aov: sums}), gathered."""
    if isinstance(out, tuple):
        return (pm.all_gather_lanes(mesh, out[0], n),
                {k: pm.all_gather_lanes(mesh, v, n) for k, v in out[1].items()})
    return pm.all_gather_lanes(mesh, out, n)


def _readback(rad, aux=None):
    """A batch's sums on the host, numpy (aux: the tracers' AOV sums, None
    without AOVs): the span driver.readback, one sync.readback a tensor."""
    with trace.span("driver.readback"):
        return (trace.to_host("sync.readback", rad).numpy(),
                None if aux is None else {k: trace.to_host("sync.readback", v).numpy()
                                          for k, v in aux.items()})


@trace.spanned("frame")
def render_buffers(scene: FlatScene, spp: int | None = None, seed: int = DEFAULT_SEED,
                   verbose: bool = False, mesh=None, samples_per_pass: int = 1,
                   passes_per_batch: int = 32, adaptive: bool = False,
                   resume_file: str | None = None, scene_hash_value: str = "",
                   checkpoint_cb=None, checkpoint_interval: float = 0.0,
                   wavefront: str = "auto") -> OutputBuffers:
    """Full render into OutputBuffers (color, AOVs, halves, variance).
    resume_file: a state file to continue from (when its scene hash is
    `scene_hash_value`) and to save to at the end (by rank 0 under a
    mesh); checkpoint_cb(bufs, passes done) runs after a batch once
    checkpoint_interval seconds have passed since the last. mesh: shard the
    lockstep lanes over the ranks (module docstring)."""
    meta = scene.meta
    if wavefront not in ("auto", "regen", "lockstep"):
        raise ValueError(f"wavefront {wavefront!r}: one of auto, regen, lockstep")
    if mesh is not None and wavefront == "regen":
        raise ValueError("wavefront 'regen' runs on one device; use 'lockstep' or 'auto' under "
                         "a mesh")
    use_regen = mesh is None and (wavefront == "regen"
                                  or (wavefront == "auto" and not meta.has_forward))
    spp = spp if spp is not None else meta.spp
    w, h = meta.res_x, meta.res_y
    n_pix = w * h
    m = samples_per_pass
    aov_names = tuple(a[0] for a in meta.aovs)
    bufs = OutputBuffers(w, h, aovs=aov_names)

    start_pass = 0
    if resume_file:
        extra = bufs.load_state(resume_file, scene_hash_value)
        if extra is not None:
            start_pass = int(extra.get("next_pass", 0))
            if verbose:
                print(f"  resumed at pass {start_pass}")

    scene = pm.replicate(mesh, scene)
    dev = scene.shade_pack.device
    with trace.span("driver.lanes"):
        lanes = _lane_arrays(meta, m)
        pix_map = lanes[2]
        with trace.span("sync.h2d.lanes"):  # host arrays copied up: the stream waits
            px, py, pix = (torch.as_tensor(a, device=dev) for a in lanes)
        lane = torch.arange(px.shape[0], device=dev)
        n_lanes = lane.shape[0]
        lane, px, py = pm.shard_lanes(mesh, lane, px, py)
    seed_pair = (seed & 0xFFFFFFFF, 0)
    total_passes = (spp + m - 1) // m
    done = start_pass
    t0 = time.time()
    last_ckpt = t0
    rng = np.random.default_rng(seed ^ 0x5EED)
    while done < total_passes:
        if adaptive and bufs.count.min() >= ADAPTIVE_THRESHOLD_SPP:
            # one pass of budget, allocated by tile error
            err = _tile_error(bufs, w, h)
            p = err.ravel() / max(err.sum(), 1e-20)
            pix_sel = _sample_pixels_by_tile(p, w, h, rng, n_pix * m)
            px_a = torch.as_tensor(pix_sel % w, device=dev)
            py_a = torch.as_tensor(pix_sel // w, device=dev)
            lane_a, px_a, py_a = pm.shard_lanes(mesh, torch.arange(len(pix_sel), device=dev),
                                                px_a, py_a)
            out = trace_batch(scene, seed_pair, lane_a, px_a, py_a, done, n_passes=1)
            rad, _ = _readback(pm.all_gather_lanes(mesh, out[0] if aov_names else out,
                                                   len(pix_sel)))
            with trace.span("driver.accumulate"):
                bufs.add_batch_sparse(rad, pix_sel)
            done += 1
        elif use_regen:
            nb = max(1, min(passes_per_batch, total_passes - done))
            out = trace_regen_batch(scene, seed_pair, px, py, pix, done, n_passes=nb)
            rad, aux = _readback(*(out if aov_names else (out,)))
            with trace.span("driver.accumulate"):
                bufs.add_pixel_sums(rad, nb * m, aux)
            done += nb
        else:
            nb = max(1, min(passes_per_batch, total_passes - done))
            out = _gather_out(mesh, trace_batch(scene, seed_pair, lane, px, py, done,
                                                n_passes=nb), n_lanes)
            rad, aux = _readback(*(out if aov_names else (out,)))
            with trace.span("driver.accumulate"):
                bufs.add_batch(rad, nb, m, n_pix, aux, pix_map=pix_map)
            done += nb
        if verbose:
            dt = time.time() - t0
            rate = n_pix * m * (done - start_pass) / dt / 1e6
            print(f"  spp {min(done * m, spp)}/{total_passes * m}  ({dt:.1f}s, {rate:.2f} "
                  f"Mpaths/s)")
        if (checkpoint_cb and checkpoint_interval > 0
                and time.time() - last_ckpt > checkpoint_interval):
            checkpoint_cb(bufs, done)
            last_ckpt = time.time()

    if resume_file:
        if pm.rank(mesh) == 0:
            bufs.save_state(resume_file, scene_hash_value, {"next_pass": done, "res": [w, h]})
        pm.barrier(mesh)
    return bufs


def _tile_error(bufs, w, h):
    """4x4-tile relative error from the two-buffer variance, with a 95th
    percentile clamp and neighbour dilation (PathTraceIntegrator.cpp:44-85)."""
    var = bufs.pixel_variance()
    mean = bufs.color().mean(-1)
    rel = var / np.maximum(mean * mean, 1e-4)
    th, tw = (h + 3) // 4, (w + 3) // 4
    rel = np.pad(rel, ((0, th * 4 - h), (0, tw * 4 - w)))
    tiles = rel.reshape(th, 4, tw, 4).mean((1, 3))
    clamp = np.percentile(tiles, 95)
    tiles = np.minimum(tiles, max(clamp, 1e-20))
    d = np.maximum(tiles, np.roll(tiles, 1, 0))
    d = np.maximum(d, np.roll(tiles, -1, 0))
    d = np.maximum(d, np.roll(tiles, 1, 1))
    d = np.maximum(d, np.roll(tiles, -1, 1))
    return d + 1e-12


def _sample_pixels_by_tile(tile_p, w, h, rng, budget):
    """`budget` pixel indices: a tile drawn by tile_p, then a pixel of it."""
    tw = (w + 3) // 4
    tiles = rng.choice(len(tile_p), size=budget, p=tile_p)
    ty, tx = tiles // tw, tiles % tw
    x = np.minimum(tx * 4 + rng.integers(0, 4, len(tiles)), w - 1)
    y = np.minimum(ty * 4 + rng.integers(0, 4, len(tiles)), h - 1)
    return (y * w + x).astype(np.int64)


def render_flat(scene: FlatScene, spp: int | None = None, seed: int = DEFAULT_SEED,
                verbose: bool = False, mesh=None, samples_per_pass: int = 1,
                passes_per_batch: int = 32, adaptive: bool = False,
                wavefront: str = "auto") -> np.ndarray:
    """Render and return the linear HDR framebuffer (H, W, 3) float32.
    mesh: shard the lanes over the ranks; the image is bit for bit the
    one-process lockstep render's."""
    return render_buffers(scene, spp=spp, seed=seed, verbose=verbose, mesh=mesh,
                          samples_per_pass=samples_per_pass, passes_per_batch=passes_per_batch,
                          adaptive=adaptive, wavefront=wavefront).color()


def render_light_traced(scene: FlatScene, spp: int | None = None, seed: int = DEFAULT_SEED,
                        verbose: bool = False, mesh=None,
                        passes_per_batch: int = 8) -> np.ndarray:
    """Light-traced render (render.py:277-319): spp passes of W*H light
    paths each. The splat estimator has E[splat_j per path] = I_j, so the
    image is the splat sum over the number of light paths. mesh: the light
    paths shard over the ranks, the splat buffer is summed."""
    from ..integrators.light_tracer import trace_light_batch

    meta = scene.meta
    spp = spp if spp is not None else meta.spp
    w, h = meta.res_x, meta.res_y
    n = w * h
    scene = pm.replicate(mesh, scene)
    lane_ids = pm.shard_lanes(mesh, torch.arange(n, device=scene.shade_pack.device))
    acc, done = None, 0
    while done < spp:
        nb = max(1, min(passes_per_batch, spp - done))
        buf = trace_light_batch(scene, (seed & 0xFFFFFFFF, 0), lane_ids, done, n_passes=nb)
        acc = buf if acc is None else acc + buf
        done += nb
        if verbose:
            print(f"  lt spp {done}/{spp}")
    return pm.all_reduce_sum(mesh, acc).cpu().numpy().reshape(h, w, 3) / (spp * float(n))


def _bdpt_lanes(meta, dev):
    """One lane a pixel in row-major order: (lane ids, px, py) (render.py:340-342)."""
    w, h = meta.res_x, meta.res_y
    px = torch.arange(w, device=dev).repeat(h)
    py = torch.arange(h, device=dev).repeat_interleave(w)
    return torch.arange(w * h, device=dev), px, py


def render_bdpt(scene: FlatScene, spp: int | None = None, seed: int = DEFAULT_SEED,
                verbose: bool = False, mesh=None, passes_per_batch: int = 4) -> np.ndarray:
    """BDPT render (render.py:322-364): the eye techniques accumulate per
    pixel, the t = 1 techniques splat and are normalized per light path
    (BidirectionalPathTracer.cpp:21-68): eye / spp + splat / (spp * W * H).
    mesh: the eye lanes shard over the ranks; the eye sums are gathered, the
    splat buffer summed."""
    from ..integrators.bdpt import trace_bdpt_batch

    meta = scene.meta
    spp = spp if spp is not None else meta.spp
    w, h = meta.res_x, meta.res_y
    scene = pm.replicate(mesh, scene)
    lane_ids, px, py = pm.shard_lanes(mesh, *_bdpt_lanes(meta, scene.shade_pack.device))
    eye_acc = splat_acc = None
    done = 0
    while done < spp:
        nb = max(1, min(passes_per_batch, spp - done))
        eye, splat = trace_bdpt_batch(scene, (seed & 0xFFFFFFFF, 0), lane_ids, px, py, done,
                                      n_passes=nb)
        eye_acc = eye if eye_acc is None else eye_acc + eye
        splat_acc = splat if splat_acc is None else splat_acc + splat
        done += nb
        if verbose:
            print(f"  bdpt spp {done}/{spp}")
    img = pm.all_gather_lanes(mesh, eye_acc, w * h).cpu().numpy().reshape(h, w, 3) / spp
    splat = pm.all_reduce_sum(mesh, splat_acc).cpu().numpy().reshape(h, w, 3)
    return img + splat / (spp * float(w * h))


def render_bdpt_pyramid(scene: FlatScene, spp: int | None = None, seed: int = DEFAULT_SEED,
                        verbose: bool = False):
    """BDPT render with the per-technique (s, t) image stack (the
    reference's ImagePyramid, ImagePyramid.cpp:20-40; render.py:367-409):
    returns (image, {(s, t): (H, W, 3)}), each t = 1 image weighted
    1 / (spp * W * H), the others 1 / spp, so that the stack sums to the
    image. One pass a sample, under trace_bdpt_batch's pass seeds."""
    from ..integrators.bdpt import BDPT_PASS_SEED, trace_bdpt_pass_pyramid

    meta = scene.meta
    spp = spp if spp is not None else meta.spp
    w, h = meta.res_x, meta.res_y
    n = w * h
    lane_ids, px, py = _bdpt_lanes(meta, scene.shade_pack.device)
    eye_acc = splat_acc = None
    pyr_acc = {}
    for it in range(spp):
        eye, splat, pyr = trace_bdpt_pass_pyramid(
            scene, (seed & 0xFFFFFFFF, BDPT_PASS_SEED + it), lane_ids, px, py)
        eye_acc = eye if eye_acc is None else eye_acc + eye
        splat_acc = splat if splat_acc is None else splat_acc + splat
        for k, v in pyr.items():
            pyr_acc[k] = v if k not in pyr_acc else pyr_acc[k] + v
        if verbose:
            print(f"  bdpt-pyramid spp {it + 1}/{spp}")
    img = eye_acc.cpu().numpy().reshape(h, w, 3) / spp
    img = img + splat_acc.cpu().numpy().reshape(h, w, 3) / (spp * float(n))
    stack = {}
    for (s, t), v in sorted(pyr_acc.items()):
        weight = 1.0 / (spp * float(n)) if t == 1 else 1.0 / spp
        stack[(s, t)] = v.cpu().numpy().reshape(h, w, 3) * weight
    return img, stack


def _scene_diagonal(scene: FlatScene) -> float:
    """The length of the triangles' bounding box diagonal: the JAX package's
    root BVH box (render.py:450-451), which holds the triangles' corners."""
    tris = scene.tris
    corners = torch.cat([tris.v0, tris.v0 + tris.e1, tris.v0 + tris.e2])
    ext = trace.to_host("sync.sppm.diagonal",
                        corners.amax(0) - corners.amin(0)).numpy().astype(np.float32)
    return float(np.linalg.norm(ext))


@trace.spanned("frame")
def render_sppm(scene: FlatScene, spp: int | None = None, seed: int = DEFAULT_SEED,
                photons_per_iter: int = 1 << 18, initial_radius: float | None = None,
                volume_radius: float | None = None, alpha: float = 0.3, verbose: bool = False,
                mesh=None, volume_photon_type: str = "points",
                gather_count: int | None = None) -> np.ndarray:
    """Stochastic progressive photon mapping (render.py:406-552): each
    iteration one photon pass (seeds (seed, 0x30000 + it)), its hash grids
    and one camera gather pass (seeds (seed, 0x40000 + it)); the radius
    shrinks by gamma = (it + 1 + alpha) / (it + 2) an iteration
    (ProgressivePhotonMapIntegrator.cpp:58-76): r^2 for the surfaces, r for
    the beams and planes, cbrt(gamma) on r for the volume points.
    initial_radius defaults to 5e-3 of the scene's diagonal, volume_radius
    to 4 x initial_radius. volume_photon_type: points, beams, planes (the
    0D plane estimator beside the single-scatter beams) or planes_1d
    (PhotonMapSettings.hpp:16-23). gather_count: the kNN radius (the
    gather_count-th nearest photon's, capped at the radius), None for the
    fixed radius. The photons folded into their cell's first MAX_PER_CELL
    rows (energy kept) are summed into render_sppm.last_overflow.

    mesh: the photon lanes shard over the ranks. Every rank all-gathers
    the photon, beam and plane records in global lane order and builds the
    one-process grids from them. The camera lanes shard too (their
    radiance gathered), except in a scene with media: there the camera
    pass's volume walks take one round count over all of its lanes (the
    reference's global DDA loop, ROADMAP §3), so every rank runs the whole
    camera pass. Unlike the JAX package, which pads the photon count to a
    multiple of the devices (render.py:447), the port keeps the caller's
    photon count (no padding lane traces), so a sharded render is the
    one-process estimator at any rank count."""
    from ..integrators.photon_map import (VOLUME_PHOTON_TYPES, build_beam_grid,
                                          build_photon_grid, build_plane_list, gather_pass,
                                          trace_photons)

    if volume_photon_type not in VOLUME_PHOTON_TYPES:
        raise ValueError(f"volume_photon_type {volume_photon_type!r}: one of "
                         f"{VOLUME_PHOTON_TYPES}")
    meta = scene.meta
    iters = spp if spp is not None else meta.spp
    w, h = meta.res_x, meta.res_y
    n = w * h
    scene = pm.replicate(mesh, scene)
    dev = scene.shade_pack.device
    cam_mesh = None if meta.has_media else mesh  # the camera lanes' mesh
    lane_cam, px, py = pm.shard_lanes(cam_mesh, torch.arange(n, device=dev),
                                      torch.arange(w, device=dev).repeat(h),
                                      torch.arange(h, device=dev).repeat_interleave(w))
    lane_ph = pm.shard_lanes(mesh, torch.arange(photons_per_iter, device=dev))

    def gathered(recs, per_lane):
        """A record tuple of this rank's photons over every rank's, in global
        lane order (None stays None)."""
        if recs is None:
            return recs
        return tuple(pm.all_gather_lanes(mesh, r, photons_per_iter, per_lane) for r in recs)

    diag = _scene_diagonal(scene)
    if initial_radius is None:
        initial_radius = diag * 5e-3
    if volume_radius is None:
        volume_radius = initial_radius * 4.0
    r2 = initial_radius * initial_radius
    r_vol = volume_radius
    planes = volume_photon_type in ("planes", "planes_1d")
    k_ph = min(meta.max_bounces, 6)
    acc = None
    ovf_total = 0
    for it in range(iters):
        with trace.span("sppm.iter"):
            surf, vol, beams, plane_recs = trace_photons(
                scene, (seed & 0xFFFFFFFF, 0x30000 + it), lane_ph, k_max=k_ph, want_planes=planes)
            surf, vol, beams = (gathered(r, k_ph) for r in (surf, vol, beams))
            plane_recs = gathered(plane_recs, k_ph * 2)
            radius = float(np.sqrt(r2))
            pack, starts, counts, ovf = build_photon_grid(*surf[:4], radius, bounce=surf[4])
            ovf_total += trace.to_host("sync.sppm.overflow", ovf)
            vargs = {}
            if vol is not None and volume_photon_type == "points":
                vpack, vstarts, vcounts, ovf_v = build_photon_grid(*vol[:4], 2.0 * r_vol,
                                                                   bounce=vol[4])
                ovf_total += trace.to_host("sync.sppm.overflow", ovf_v)
                vargs = dict(vpack=vpack, vstarts=vstarts, vcounts=vcounts, v_radius=r_vol,
                             scene_far=diag * 2.0)
            elif beams is not None:
                bpack, bstarts, bcounts, ovf_b, _ = build_beam_grid(*beams, r_vol)
                ovf_total += trace.to_host("sync.sppm.overflow", ovf_b)
                vargs = dict(bpack=bpack, bstarts=bstarts, bcounts=bcounts, b_radius=r_vol,
                             scene_far=diag * 2.0)
                if plane_recs is not None:
                    # beyond MAX_PLANES the table is thinned with power
                    # compensation (unbiased): nothing is lost to report
                    prows, pmask, _ = build_plane_list(*plane_recs, seed=it)
                    vargs.update(prows=prows, pmask=pmask)
                    if volume_photon_type == "planes_1d":
                        vargs.update(p1d_radius=r_vol)
            img = gather_pass(scene, (seed & 0xFFFFFFFF, 0x40000 + it), lane_cam, px, py, pack,
                              starts, counts, radius, photons_per_iter, knn_count=gather_count,
                              **vargs)
            img = pm.all_gather_lanes(cam_mesh, img, n)
            acc = img if acc is None else acc + img
            gamma_it = (it + 1 + alpha) / (it + 2)
            r2 = r2 * gamma_it
            if volume_photon_type in ("beams", "planes", "planes_1d"):
                r_vol = r_vol * gamma_it
            else:
                r_vol = r_vol * gamma_it ** (1.0 / 3.0)
            if verbose:
                print(f"  sppm iter {it + 1}/{iters} r={radius:.4f} r_vol={r_vol:.4f}")
    if ovf_total and verbose:
        print(f"  note: {ovf_total} photons beyond MAX_PER_CELL were folded into their cell's "
              f"kept photons (energy-preserving compensation)")
    render_sppm.last_overflow = int(ovf_total)
    return _readback(acc)[0].reshape(h, w, 3) / iters


render_sppm.last_overflow = 0


def render_scene(doc_or_path, device, spp=None, seed=DEFAULT_SEED, verbose=False,
                 wavefront: str = "auto"):
    """Load + flatten + render on `device`; returns (linear_hdr, tonemapped_ldr01)."""
    doc = load_scene(doc_or_path) if isinstance(doc_or_path, str) else doc_or_path
    scene = flatten_scene(doc, device)
    hdr = render_flat(scene, spp=spp, seed=seed, verbose=verbose, wavefront=wavefront)
    ldr = tonemap(scene.meta.tonemap, torch.as_tensor(hdr)).numpy()
    return hdr, np.clip(ldr, 0.0, 1.0)
