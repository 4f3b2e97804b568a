"""Build the port's CUDA sources into shared libraries, load and call them.

The kernels have a plain C interface (no PyTorch headers), so one `nvcc`
call builds each in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/tungsten_tpu_torch/lib<name>_<hash>.so csrc/<name>.cu

The library lands in build/tungsten_tpu_torch/ of the checkout, named by a
hash of the source, the csrc/ headers it includes (`#include "x.cuh"`, and
the headers those include) and the flags, so an edited source or
header rebuilds the libraries that use it, and an unchanged one is built once
per checkout. The sources in csrc/ are the only input. `build(*names)` starts one
nvcc per missing library, all at once, and waits for them all. ptxas reports
each kernel's registers, shared memory and spills (-Xptxas -v); the report
is kept beside the library (`ptxas_report`). No default fast-math flags: the
plane-form leaf tests rely on IEEE NaN semantics (csrc/bvh8_common.cuh).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "tungsten_tpu_torch")
_LOCAL_INCLUDE = re.compile(rb'^\s*#include\s+"([^"]+)"', re.MULTILINE)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _paths(name: str):
    """(source, library) paths of csrc/<name>.cu."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(src, "rb") as f:
        text = f.read()
    h.update(text)
    todo, seen = _LOCAL_INCLUDE.findall(text), set()
    while todo:
        header = todo.pop(0)
        if header in seen:
            continue
        seen.add(header)
        with open(os.path.join(CSRC_DIR, header.decode()), "rb") as f:
            body = f.read()
        h.update(body)
        todo += _LOCAL_INCLUDE.findall(body)
    return src, os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(*names: str):
    """Build csrc/<name>.cu for each name whose library is missing: one nvcc
    per source, all started together. Raises naming every failed source."""
    procs = []
    for name in names:
        src, out = _paths(name)
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.tmp{os.getpid()}"
        procs.append((src, out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for src, out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {src}:\n{stdout}\n{stderr}")
        else:
            with open(out + ".ptxas.txt", "w") as f:
                f.write(stderr)
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def ptxas_report(name: str) -> str:
    """What ptxas said of csrc/<name>.cu's kernels when it was built:
    registers, shared memory, stack frame and spills of each."""
    build(name)
    with open(_paths(name)[1] + ".ptxas.txt") as f:
        return "\n".join(line.strip() for line in f if line.strip())


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build csrc/<name>.cu if needed and return the loaded library."""
    build(name)
    return ctypes.CDLL(_paths(name)[1])


def ptr(x):
    """A tensor's device pointer as a ctypes argument (None -> NULL)."""
    return ctypes.c_void_p(x.data_ptr()) if x is not None else ctypes.c_void_p(0)


def stream_of(x):
    """The current CUDA stream of x's device, as a ctypes argument."""
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def check_cuda(name, x, dtype, shape=None, like=None):
    """Raise unless x is a contiguous CUDA tensor of dtype (and shape, and on
    like's device): the kernels take nothing else."""
    if not x.is_cuda or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name}: need a contiguous CUDA {dtype} tensor, got "
                         f"{x.device} {x.dtype} contiguous={x.is_contiguous()}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)} != {tuple(shape)}")
    if like is not None and x.device != like.device:
        raise ValueError(f"{name} is on {x.device}, rays on {like.device}")
