"""tungsten_tpu_torch: the PyTorch + CUDA port of tungsten_tpu.

Counterpart of tungsten_tpu/__init__.py, module for module. The JAX package
stays the reference; this package does everything it does: scene load ->
flatten -> the eight integrators (the regenerating and lockstep path
tracers, the light tracer, BDPT, photon mapping and SPPM, Kelemen,
multiplexed and reversible-jump MLT) -> the framebuffer, with every
surface, light, camera, filter, medium and geometry type, the render
driver and its command line (tools/tungsten.py), the sharded renders over
torch.distributed (parallel/mesh.py), the NFOR denoiser and the image
metrics (utils/), and the denoiser, hdrmanip, render-server and obj2json
tools. It runs in plain torch tensor code with hand-written CUDA kernels
for the walks: the BVH8 walk, exact and fast (ops/bvh8.py +
csrc/bvh8_walk.cu, bvh8_walk_fast.cu), the gather walk (ops/gather_bvh.py
+ csrc/gather_walk.cu), the binary walk (ops/bvh2.py + csrc/bvh2_walk.cu),
the packet walk (ops/bvh.py + csrc/bvh_walk.cu), the streaming brute force
(ops/intersect_stream.py + csrc/intersect_stream.cu), the voxel DDA
(ops/grid_walk.py + csrc/grid_walk.cu) and the photon-grid walk
(ops/photon_walk.py + csrc/photon_walk.cu). The intersector benchmark
(tools/bench_isect.py) times the walks. It imports torch and numpy, never
jax.
"""
import torch as _torch

__version__ = "0.1.0"

# Geometry is f32 end to end. TF32 (the Hopper analog of the TPU's bf16 MXU
# default that tungsten_tpu/__init__.py turns off) would quantize camera-ray
# rotations (`local @ rot.T`) and env lookups (`d @ inv_rot.T`) to ~10
# mantissa bits and shift the image.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")


def device(name: str = "cuda") -> _torch.device:
    """torch.device for `name`; raises when CUDA is asked for and absent
    (the port never falls back to the CPU on its own)."""
    dev = _torch.device(name)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() is False")
    return dev
