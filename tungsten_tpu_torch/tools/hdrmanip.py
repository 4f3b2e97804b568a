"""HDR manipulation on the host: tools/hdrmanip.py (:1-89), the analog of
src/hdrmanip/hdrmanip.cpp.

    python -m tungsten_tpu_torch.tools.hdrmanip a.pfm [b.pfm ...] [options]

Tonemap and exposure conversion (-t, -e), --merge (the mean of renders
from several machines), the error metrics --mse / --rmse / --ssim REF
(hdrmanip.cpp:204-223) and the heat maps --mse-map / --rmse-map REF
(hdrmanip.cpp:114-152). Its work is on the host, as the JAX tool pins
itself to the CPU: the metrics and the tonemap run on CPU tensors.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

RAMP = np.array([[0, 0, 1], [0, 1, 1], [0, 1, 0], [1, 1, 0], [1, 0, 0]], np.float32)


def _args(argv):
    ap = argparse.ArgumentParser(description="tungsten-tpu hdrmanip (PyTorch port)")
    ap.add_argument("files", nargs="+")
    ap.add_argument("-o", "--output", help="output file")
    ap.add_argument("--merge", action="store_true", help="average the input images")
    ap.add_argument("--mse", nargs=1, metavar="REF", help="print MSE vs reference image")
    ap.add_argument("--rmse", nargs=1, metavar="REF", help="print RMSE vs reference image")
    ap.add_argument("--ssim", nargs=1, metavar="REF", help="print SSIM vs reference image")
    ap.add_argument("--mse-map", nargs=1, metavar="REF",
                    help="write squared-error heat map (hdrmanip.cpp:114-138)")
    ap.add_argument("--rmse-map", nargs=1, metavar="REF",
                    help="write relative-squared-error heat map (hdrmanip.cpp:140-152)")
    ap.add_argument("-t", "--tonemap", default=None,
                    choices=["linear", "gamma", "reinhard", "filmic", "pbrt"])
    ap.add_argument("-e", "--exposure", type=float, default=0.0, help="EV adjustment")
    return ap.parse_args(argv)


def heat_map(err):
    """(relative) squared error x 50 -> the colour ramp, normalized by the
    80%-energy tail's maximum (hdrmanip.cpp:114-199, 330-357)."""
    err = err * 50.0
    flat = np.sort(err.ravel())
    total = max(flat.sum(), 1e-30)
    csum = np.cumsum(flat[::-1])
    tail = len(flat) - 1 - int(np.searchsorted(csum / total, 0.8))
    vmax = max(flat[max(tail, 0)], 1e-30)
    t = np.clip(err / vmax, 0.0, 1.0)
    lo = np.clip((t * 4.0).astype(np.int32), 0, 3)
    frac = (t * 4.0 - lo)[..., None]
    return RAMP[lo] * (1.0 - frac) + RAMP[lo + 1] * frac


def main(argv=None):
    args = _args(argv)
    from ..io.imageio import load_image, save_image
    from ..models.cameras.tonemap import tonemap
    from ..utils.compare import mse, rmse, ssim

    imgs = [load_image(f, gamma_correct=False) for f in args.files]

    for flag, fn in (("mse", mse), ("rmse", rmse), ("ssim", ssim)):
        refarg = getattr(args, flag)
        if refarg:
            ref = load_image(refarg[0], gamma_correct=False)
            for f, img in zip(args.files, imgs):
                print(f"{flag.upper()}({f}) = {fn(img, ref):.6f}")
            return

    if args.mse_map or args.rmse_map:
        ref = load_image((args.mse_map or args.rmse_map)[0], gamma_correct=False)[..., :3]
        a = imgs[0][..., :3]
        d2 = (a - ref) ** 2
        err = (d2 / (a * a + 1e-3)).mean(-1) if args.rmse_map else d2.mean(-1)
        save_image(args.output or "mse_map.png", np.clip(heat_map(err), 0, 1))
        return

    img = np.mean(imgs, axis=0) if args.merge else imgs[0]
    if args.exposure:
        img = img * (2.0 ** args.exposure)
    if args.tonemap:
        img = np.clip(tonemap(args.tonemap, torch.as_tensor(img)).numpy(), 0, 1)
    save_image(args.output or "out.png", img)


if __name__ == "__main__":
    main()
