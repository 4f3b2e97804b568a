"""tungsten_tpu_torch: the PyTorch + CUDA port of tungsten_tpu.

Counterpart of tungsten_tpu/__init__.py. The JAX package stays the
reference; this package runs its path tracer (scene load -> flatten ->
regenerating or lockstep wavefront path tracer -> framebuffer; every surface
BSDF but the fibers, the wrappers over one level of nesting, forward lobes
through the lockstep tracer's crossing walk, textured parameters, .hdr
images, every light kind but the skydome, every camera and reconstruction
filter, the depth / normal / albedo AOVs; the render driver with samples
per pass, adaptive sampling, resume files and checkpoints, and its command
line, tools/tungsten.py; participating media; the light tracer and the
bidirectional path tracer with its image pyramid) with plain torch tensor
code and
hand-written CUDA kernels for the walks: the BVH8
walk, exact and fast (ops/bvh8.py + csrc/bvh8_walk.cu, bvh8_walk_fast.cu),
the gather walk (ops/gather_bvh.py + csrc/gather_walk.cu), the binary walk
(ops/bvh2.py + csrc/bvh2_walk.cu), the packet walk (ops/bvh.py +
csrc/bvh_walk.cu) and the streaming brute force (ops/intersect_stream.py +
csrc/intersect_stream.cu). The intersector
benchmark (tools/bench_isect.py) times them all. It imports torch and numpy,
never jax.

Package layout mirrors tungsten_tpu/ module for module; what is not ported
yet (the skydome, curves and the fibers, photon mapping and the MLT
integrators) raises NotImplementedError naming the missing piece.
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
