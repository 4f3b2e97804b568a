"""The renderer's command line on the card: the path tracer, light tracer,
bidirectional path tracer and photon map branches of tools/tungsten.py
(:20-131, 171-239), the analog of src/tungsten/tungsten.cpp.

    python -m tungsten_tpu_torch.tools.tungsten scene.json [scene2.json ...] [options]

Renders a queue of Tungsten scene files (schema unmodified) with the same
flags: spp / seed / resolution-scale overrides, adaptive sampling
(`adaptive_sampling`), AOV output buffers, checkpoints (`checkpoint_interval`
or -c) and resume (`enable_resume_render`, `resume_render_file`; -r starts
afresh). It runs on the CUDA card, and raises where there is none; --cpu
runs it on the CPU. The path_tracer, light_tracer,
bidirectional_path_tracer (with its `image_pyramid`: one
<output>-s=S-t=T.png a technique), photon_map and progressive_photon_map
integrators are ported; another integrator type raises
NotImplementedError naming it. SPPM reads `photon_count` (at most 2^20),
`alpha`, `volume_photon_type` and, for photon_map only, the kNN
`gather_photon_count` (20 by default). The light tracer, BDPT and SPPM
write the LDR and HDR images only, as the JAX CLI does. A failed scene is
reported and the queue goes on; with one scene the error is raised.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch


PORTED = ("path_tracer", "light_tracer", "bidirectional_path_tracer", "photon_map",
          "progressive_photon_map")
PHOTON_CAP = 1 << 20  # photons an SPPM iteration at most (tools/tungsten.py:178)


def parse_duration(v) -> float:
    """Seconds of "90", "30s", "5m" or "2h"; 0 for none."""
    if v in (None, "", "0", 0):
        return 0.0
    v = str(v)
    mult = {"s": 1, "m": 60, "h": 3600}.get(v[-1], None)
    return float(v[:-1]) * mult if mult else float(v)


def _args(argv):
    ap = argparse.ArgumentParser(description="tungsten-tpu renderer (PyTorch + CUDA port)")
    ap.add_argument("scenes", nargs="+", help="scene JSON files")
    ap.add_argument("-o", "--output", help="override output file")
    ap.add_argument("-e", "--hdr-output", help="override HDR output file")
    ap.add_argument("-s", "--spp", type=int, help="override sample count")
    ap.add_argument("--seed", type=int, default=0xBA5EBA11)
    ap.add_argument("--scale", type=float, default=1.0, help="resolution scale factor")
    ap.add_argument("--cpu", action="store_true", help="render on the CPU")
    ap.add_argument("-r", "--restart", action="store_true", help="ignore saved resume state")
    ap.add_argument("-c", "--checkpoint", type=float, default=None,
                    help="checkpoint interval in seconds (0 disables)")
    ap.add_argument("-d", "--output-directory", help="override output directory")
    ap.add_argument("--samples-per-pass", type=int, default=1)
    ap.add_argument("--passes-per-batch", type=int, default=16)
    ap.add_argument("-q", "--quiet", action="store_true")
    return ap.parse_args(argv)


def main(argv=None):
    args = _args(argv)
    from .. import device
    from ..io.imageio import save_image
    from ..models.cameras.tonemap import tonemap
    from ..renderer.framebuffer import scene_hash
    from ..renderer.render import (render_bdpt, render_bdpt_pyramid, render_buffers,
                                   render_light_traced, render_sppm)
    from ..scene.flatten import flatten_scene
    from ..scene.load import load_scene

    dev = device("cpu" if args.cpu else "cuda")
    for scene_path in args.scenes:
        try:
            t0 = time.time()
            doc = load_scene(scene_path)
            itype = doc.integrator.get("type", "path_tracer")
            if itype not in PORTED:
                raise NotImplementedError(f"integrator {itype!r} is not ported")
            if args.scale != 1.0:
                rx, ry = doc.camera.get("resolution", [1000, 563])
                doc.camera["resolution"] = [max(1, int(rx * args.scale)),
                                            max(1, int(ry * args.scale))]
            scene = flatten_scene(doc, dev)
            meta = scene.meta
            out_dir = args.output_directory or os.path.dirname(scene_path) or "."

            def outpath(name):
                return name if os.path.isabs(name) else os.path.join(out_dir, name)

            if not args.quiet:
                print(f"[{scene_path}] {scene.tris.v0.shape[0]} tris, {meta.n_lights} lights, "
                      f"{meta.res_x}x{meta.res_y}, {args.spp or meta.spp} spp on {dev.type}")
            resume_file = None
            if doc.renderer.get("enable_resume_render") and not args.restart:
                resume_file = outpath(doc.renderer.get("resume_render_file", "RenderState.dat"))
            ckpt_interval = (args.checkpoint if args.checkpoint is not None
                             else parse_duration(doc.renderer.get("checkpoint_interval", "0")))

            def write_outputs(bufs, suffix=""):
                hdr = bufs.color()
                out = outpath(args.output or doc.renderer.get("output_file", "TungstenRender.png"))
                if suffix:
                    stem, ext = os.path.splitext(out)
                    out = stem + suffix + ext
                save_image(out, np.clip(tonemap(meta.tonemap, torch.as_tensor(hdr)).numpy(), 0, 1))
                hdr_out = args.hdr_output or doc.renderer.get("hdr_output_file", "")
                if hdr_out:
                    save_image(outpath(hdr_out), hdr)
                for aov_type, ldr_file, hdr_file in meta.aovs:
                    img = bufs.aov(aov_type)
                    if img.shape[-1] == 1:
                        img = np.repeat(img, 3, -1)
                    if aov_type == "depth":
                        img = img / max(img.max(), 1e-9)
                    if ldr_file:
                        save_image(outpath(ldr_file), np.clip(img, 0, 1))
                    if hdr_file:
                        save_image(outpath(hdr_file), img)
                return out

            def ldr(hdr):
                return np.clip(tonemap(meta.tonemap, torch.as_tensor(hdr)).numpy(), 0, 1)

            def save_simple(hdr):
                out = outpath(args.output or doc.renderer.get("output_file", "TungstenRender.png"))
                save_image(out, ldr(hdr))
                hdr_out = args.hdr_output or doc.renderer.get("hdr_output_file", "")
                if hdr_out:
                    save_image(outpath(hdr_out), np.asarray(hdr, np.float32))
                return out

            if itype == "bidirectional_path_tracer" and doc.integrator.get("image_pyramid"):
                # the per-technique stack, <out>-s=%d-t=%d.png (ImagePyramid.cpp:36)
                hdr, stack = render_bdpt_pyramid(scene, spp=args.spp, seed=args.seed,
                                                 verbose=not args.quiet)
                out = save_simple(hdr)
                base = os.path.splitext(out)[0]
                for (s, t), im in stack.items():
                    save_image(f"{base}-s={s}-t={t}.png", ldr(im))
            elif itype == "bidirectional_path_tracer":
                out = save_simple(render_bdpt(scene, spp=args.spp, seed=args.seed,
                                              verbose=not args.quiet))
            elif itype in ("photon_map", "progressive_photon_map"):
                pm = doc.integrator
                out = save_simple(render_sppm(
                    scene, spp=args.spp, seed=args.seed,
                    photons_per_iter=min(int(pm.get("photon_count", 1 << 18)), PHOTON_CAP),
                    alpha=float(pm.get("alpha", 0.3)),
                    volume_photon_type=pm.get("volume_photon_type", "points"),
                    # photon_map gathers by count (kNN, gatherCount 20 by
                    # default, PhotonMapSettings.hpp:43); progressive keeps
                    # the radius schedule
                    gather_count=(int(pm.get("gather_photon_count", 20))
                                  if itype == "photon_map" else None),
                    verbose=not args.quiet))
            elif itype == "light_tracer":
                out = save_simple(render_light_traced(scene, spp=args.spp, seed=args.seed))
            else:
                bufs = render_buffers(
                    scene, spp=args.spp, seed=args.seed, verbose=not args.quiet,
                    samples_per_pass=args.samples_per_pass,
                    passes_per_batch=args.passes_per_batch,
                    adaptive=bool(doc.renderer.get("adaptive_sampling", False)),
                    resume_file=resume_file, scene_hash_value=scene_hash(doc),
                    checkpoint_cb=(lambda b, p: write_outputs(b, "_checkpoint"))
                    if ckpt_interval > 0 else None,
                    checkpoint_interval=ckpt_interval)
                out = write_outputs(bufs)
            if not args.quiet:
                print(f"  wrote {out} in {time.time() - t0:.1f}s")
        except Exception as e:  # the queue goes on; one scene re-raises
            print(f"[{scene_path}] FAILED: {e}", file=sys.stderr)
            if len(args.scenes) == 1:
                raise


if __name__ == "__main__":
    main()
