"""The post-process denoiser's command line on the card: tools/denoiser.py
(:1-98), the analog of src/denoiser (NFOR).

    python -m tungsten_tpu_torch.tools.denoiser --state render_state.npz -o out.pfm
    python -m tungsten_tpu_torch.tools.denoiser color.pfm -o out.pfm \\
        [--albedo albedo.pfm] [--normal normal.pfm] [--depth depth.pfm] [--variance var.pfm]

With --state it runs the full NFOR (utils/nfor.py; denoiser.cpp:38-133)
from a renderer state file, which carries the colour halves, the Welford
variance and the two-buffer AOVs; with loose images it runs the regression
core (utils/denoise.py). It runs on the CUDA card, and raises where there
is none; --cpu runs it on the CPU. The state's header extra must carry
`res` ([w, h]): the port's render_buffers writes it (the JAX package's
renderer does not, so its denoiser cannot read its own renderer's state
files); a state without it is refused with the JAX tool's message.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

FEATURES = ("albedo", "normal", "depth")


def nfor_from_state(path, device):
    """The full NFOR of a state file (the JAX tool's _nfor_from_state,
    :27-61) on `device`; returns (H, W, 3) float32 on the host."""
    from ..utils.nfor import nfor

    with np.load(path) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        res = (header.get("extra") or {}).get("res")
        if res is None:
            raise SystemExit("state file lacks 'res' in its header extra; re-render with a "
                             "current build or pass loose images instead")
        arrays = {k: torch.as_tensor(z[k], device=device) for k in z.files if k != "__header__"}
    h, w = int(res[1]), int(res[0])
    ca = torch.clamp(arrays["count_a"], min=1)[:, None].to(torch.float64)
    cb = torch.clamp(arrays["count_b"], min=1)[:, None].to(torch.float64)
    a = (arrays["sum_a"] / ca).reshape(h, w, 3)
    b = (arrays["sum_b"] / cb).reshape(h, w, 3)
    var = (arrays["m2"] / max(header["passes"] - 1, 1)).reshape(h, w, 3)
    var = var / torch.clamp(arrays["count"], min=1).reshape(h, w, 1)
    feats = []
    for k in FEATURES:
        if f"aova_{k}" in arrays:
            fa = (arrays[f"aova_{k}"] / ca).reshape(h, w, -1)
            fb = (arrays[f"aovb_{k}"] / cb).reshape(h, w, -1)
            feats.append({"buffer_a": fa, "buffer_b": fb, "variance": (fa - fb) ** 2 * 0.25})
    return nfor(a, b, var, feats).to(torch.float32).cpu().numpy()


def _args(argv):
    ap = argparse.ArgumentParser(description="tungsten-tpu denoiser (PyTorch + CUDA port)")
    ap.add_argument("color", nargs="?")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--state", help="renderer state .npz: run the full NFOR pipeline")
    ap.add_argument("--albedo")
    ap.add_argument("--normal")
    ap.add_argument("--depth")
    ap.add_argument("--variance")
    ap.add_argument("--radius", type=int, default=5)
    ap.add_argument("--cpu", action="store_true", help="denoise on the CPU")
    return ap.parse_args(argv)


def main(argv=None):
    args = _args(argv)
    from .. import device
    from ..io.imageio import load_image, save_image

    dev = device("cpu" if args.cpu else "cuda")
    if args.state:
        out = nfor_from_state(args.state, dev)
    else:
        if not args.color:
            raise SystemExit("need a color image (or --state)")
        from ..utils.denoise import denoise

        def load(p):
            return load_image(p, gamma_correct=False) if p else None

        out = denoise(load(args.color), albedo=load(args.albedo), normal=load(args.normal),
                      depth=load(args.depth), variance=load(args.variance), radius=args.radius,
                      device=dev).cpu().numpy()
    save_image(args.output, out)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
