"""OBJ -> scene.json + .wo3: tools/obj2json.py (:1-47), the analog of
src/obj2json, on the port's io/meshio.py.

    python -m tungsten_tpu_torch.tools.obj2json mesh.obj scene.json

Writes <stem>.wo3 beside scene.json and a scene that renders it: one
lambert material, a pinhole camera at 1000x563, the path tracer.
"""
from __future__ import annotations

import argparse
import json
import os


def scene_for(stem: str, wo3_name: str) -> dict:
    return {
        "bsdfs": [{"name": stem, "type": "lambert", "albedo": 0.8}],
        "primitives": [{"type": "mesh", "file": wo3_name, "bsdf": stem, "smooth": True}],
        "camera": {
            "type": "pinhole",
            "tonemap": "gamma",
            "resolution": [1000, 563],
            "fov": 60,
            "transform": {"position": [0, 0, 4], "look_at": [0, 0, 0], "up": [0, 1, 0]},
        },
        "integrator": {"type": "path_tracer", "min_bounces": 0, "max_bounces": 16},
        "renderer": {"spp": 32, "output_file": stem + ".png"},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description="OBJ -> scene.json + .wo3")
    ap.add_argument("obj")
    ap.add_argument("json_out")
    args = ap.parse_args(argv)
    from ..io.meshio import load_obj, save_wo3

    mesh = load_obj(args.obj)
    stem = os.path.splitext(os.path.basename(args.obj))[0]
    wo3 = os.path.join(os.path.dirname(args.json_out) or ".", stem + ".wo3")
    save_wo3(wo3, mesh)
    with open(args.json_out, "w") as f:
        json.dump(scene_for(stem, os.path.basename(wo3)), f, indent=4)
    print(f"wrote {args.json_out} + {wo3} ({len(mesh.indices)} tris)")


if __name__ == "__main__":
    main()
