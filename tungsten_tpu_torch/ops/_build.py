"""Build the port's CUDA sources into a shared library and load it.

The kernels have a plain C interface (no PyTorch headers), so one `nvcc`
call builds each in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/tungsten_tpu_torch/lib<name>_<hash>.so csrc/<name>.cu

The library lands in build/tungsten_tpu_torch/ of the checkout, named by a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one is built once per checkout. The sources in csrc/ are the only
input. No default fast-math flags: the BVH8 leaf test relies on IEEE NaN
semantics (bvh8_walk.cu header).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "tungsten_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build csrc/<name>.cu if needed and return the loaded library."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{name}_{key}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.tmp{os.getpid()}"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(out)
