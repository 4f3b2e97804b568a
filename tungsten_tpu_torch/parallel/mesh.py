"""Device-mesh parallelism for the sample megabatch, on torch.distributed.

Port of tungsten_tpu/parallel/mesh.py. The JAX package runs one controller
over a 1-D mesh with a "shard" axis: lane arrays are placed in contiguous
blocks, the scene is replicated, and the partitioner turns scatter-adds
into cross-device sums. PyTorch's idiom for the same design is one process
per device:

 - `make_mesh` builds a one-dimensional DeviceMesh named "shard" over the
   process group the caller started (for example under torchrun, which sets
   the env:// rendezvous variables); rank r renders on
   cuda:{local_rank % device_count}, or on the CPU;
 - `shard_lanes` gives this rank its contiguous block of the global lanes.
   Lane ids stay global, so the stateless counter RNG gives every lane the
   same stream at any rank count;
 - `replicate` moves this rank's scene (every rank flattens the same
   document) to the rank's device and checks, through an all-gather of a
   digest of its tensors, that every rank holds the same scene;
 - the renders reduce with `all_gather_lanes` (per-lane results, put
   together in rank order, so the host adds them in the single-process
   order) and `all_reduce_sum` (splat buffers), and return the whole image
   on every rank, as a JAX global array is.

Every function here takes mesh=None as one process: it hands its input
back unchanged (rank 0 of 1, a barrier that does nothing), so a render
calls them the same way with or without a mesh.

A block is ceil(n / ranks) lanes; the last ranks hold fewer (or none), so
no padding lane is ever traced. `pad_to_devices` is kept for callers that
size their own arrays. Under the gloo backend a CUDA tensor's collectives
stage through the host. `start_ranks` / `join_ranks` spawn the ranks of a
one-host group and collect what each returns, with a deadline.
"""
from __future__ import annotations

import dataclasses
import datetime
import hashlib
import os
import queue
import socket
import time
import traceback
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXIS = "shard"
ADDITIVE = ("splat",)  # the chain state's buffers that sum over the ranks


def make_mesh(device_type: str = "cuda", backend: str | None = None) -> DeviceMesh:
    """The one-dimensional "shard" mesh over every rank of the default
    process group. Where no group is started yet, one is started from the
    env:// variables (torchrun's) with `backend`: nccl for CUDA and gloo for
    the CPU unless named. With CUDA the rank's device is set first:
    cuda:{LOCAL_RANK (else the rank) % device_count}."""
    if not dist.is_initialized():
        dist.init_process_group(backend or ("nccl" if device_type == "cuda" else "gloo"))
    if device_type == "cuda":
        torch.cuda.set_device(_local_rank() % torch.cuda.device_count())
        torch.cuda.current_device()  # the context exists before the mesh looks
    return DeviceMesh(device_type, list(range(dist.get_world_size())), mesh_dim_names=(AXIS,))


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank renders on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def size(mesh: DeviceMesh | None) -> int:
    return 1 if mesh is None else mesh.size()


def rank(mesh: DeviceMesh | None) -> int:
    return 0 if mesh is None else mesh.get_local_rank(AXIS)


def pad_to_devices(n: int, n_dev: int) -> int:
    return ((n + n_dev - 1) // n_dev) * n_dev


def lane_block(mesh: DeviceMesh, n: int) -> tuple[int, int]:
    """[start, stop) of this rank's contiguous block of n lanes."""
    chunk = pad_to_devices(n, size(mesh)) // size(mesh)
    start = min(rank(mesh) * chunk, n)
    return start, min(start + chunk, n)


def shard_lanes(mesh: DeviceMesh | None, *tensors):
    """This rank's block of each lane-major tensor (leading axis n, the same
    n for all), on the rank's device. One tensor in, one out."""
    if mesh is None:
        out = tensors
    else:
        start, stop = lane_block(mesh, tensors[0].shape[0])
        dev = mesh_device(mesh)
        out = tuple(t[start:stop].to(dev) for t in tensors)
    return out if len(out) > 1 else out[0]


def _group(mesh: DeviceMesh):
    return mesh.get_group(AXIS)


def _staged(mesh: DeviceMesh, t: torch.Tensor) -> torch.Tensor:
    """t where the backend can take it: on the host under gloo."""
    if t.is_cuda and dist.get_backend(_group(mesh)) == "gloo":
        return t.cpu()
    return t


def all_gather_lanes(mesh: DeviceMesh | None, x: torch.Tensor, n: int, per_lane: int = 1):
    """The global lane-major tensor from every rank's block x (its rows
    per_lane to a lane, of n lanes in all), in rank order, on x's device."""
    if mesh is None:
        return x
    chunk = (pad_to_devices(n, size(mesh)) // size(mesh)) * per_lane
    flag = x.dtype == torch.bool
    y = _staged(mesh, x.to(torch.uint8) if flag else x)
    if y.shape[0] < chunk:  # a short last block: padded here, trimmed below
        y = torch.cat([y, y.new_zeros((chunk - y.shape[0],) + tuple(y.shape[1:]))])
    parts = [torch.empty_like(y) for _ in range(size(mesh))]
    dist.all_gather(parts, y.contiguous(), group=_group(mesh))
    out = torch.cat(parts)[: n * per_lane].to(x.device)
    return out.bool() if flag else out


def all_reduce_sum(mesh: DeviceMesh | None, x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the ranks, on x's device (x is not changed)."""
    if mesh is None:
        return x
    y = _staged(mesh, x).clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=_group(mesh))
    return y.to(x.device)


def barrier(mesh: DeviceMesh | None) -> None:
    if mesh is not None:
        dist.barrier(group=_group(mesh))


def _tree_map(fn, obj):
    """obj with fn applied to every tensor inside its dataclasses, named
    tuples, tuples, lists and dicts."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        kw = {f.name: _tree_map(fn, getattr(obj, f.name))
              for f in dataclasses.fields(obj) if f.init}
        return dataclasses.replace(obj, **kw)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_tree_map(fn, v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_tree_map(fn, v) for v in obj)
    if isinstance(obj, dict):
        return {k: _tree_map(fn, v) for k, v in obj.items()}
    return obj


def scene_digest(scene) -> bytes:
    """SHA-256 over every tensor of the scene (dtype, shape and bytes, in
    field order) and its meta's repr. Computed once per scene object and
    kept on it: a scene is not changed in place once flattened, and
    dataclasses.replace makes a new object, which is hashed anew."""
    cached = getattr(scene, "_mesh_digest", None)
    if cached is not None:
        return cached
    h = hashlib.sha256()

    def eat(t):
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        if t.numel():
            h.update(t.detach().contiguous().cpu().view(-1).view(torch.uint8).numpy())
        return t

    _tree_map(eat, scene)
    h.update(repr(getattr(scene, "meta", "")).encode())
    object.__setattr__(scene, "_mesh_digest", h.digest())
    return scene._mesh_digest


def replicate(mesh: DeviceMesh | None, scene):
    """This rank's scene on the rank's device, after a check that every rank
    holds the same one (an all-gather of the digests); raises RuntimeError
    naming the ranks that differ from rank 0."""
    if mesh is None:
        return scene
    dev = mesh_device(mesh)
    digest = scene_digest(scene)
    scene = _tree_map(lambda t: t.to(dev), scene)
    mine = _staged(mesh, torch.tensor(list(digest), dtype=torch.uint8, device=dev))
    parts = [torch.empty_like(mine) for _ in range(size(mesh))]
    dist.all_gather(parts, mine, group=_group(mesh))
    differ = [r for r, p in enumerate(parts) if not torch.equal(p.cpu(), parts[0].cpu())]
    if differ:
        raise RuntimeError(f"replicate: the scene of rank(s) {differ} differs from rank 0's "
                           f"(every rank must flatten the same document the same way)")
    return scene


def shard_chain_state(mesh: DeviceMesh | None, state: dict, n_chains: int) -> dict:
    """An MLT chain state for this rank: the additive buffers (ADDITIVE, the
    splat framebuffer) stay whole, rank 0 keeping its value and the other
    ranks starting from zeros, so that `gather_chain_state` (one sum) gives
    the single-process buffer; every other tensor is per chain and is cut
    to the rank's block of chains. The buffers are picked by key, never by
    shape: a (W * H, 3) splat buffer has n_chains rows where n_chains is
    the pixel count."""
    if mesh is None:
        return state
    start, stop = lane_block(mesh, n_chains)
    dev = mesh_device(mesh)
    out = {}
    for k, v in state.items():
        v = v.to(dev)
        if k in ADDITIVE:
            out[k] = v if rank(mesh) == 0 else torch.zeros_like(v)
        else:
            out[k] = v[start:stop]
    return out


def gather_chain_state(mesh: DeviceMesh | None, state: dict, n_chains: int) -> dict:
    """The whole chain state on every rank: the chain blocks all-gathered in
    rank order, the additive buffers (ADDITIVE) summed."""
    if mesh is None:
        return state
    return {k: all_reduce_sum(mesh, v) if k in ADDITIVE else all_gather_lanes(mesh, v, n_chains)
            for k, v in state.items()}


class Ranks(NamedTuple):
    """The spawned ranks of `start_ranks` and the queue they answer on."""
    procs: list
    results: object


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _rank_main(fn, rank_, world, args, device_type, backend, init_method, timeout, threads,
               out_q):
    """One spawned rank: its group and mesh, then fn(mesh, *args) on out_q,
    or the traceback of its failure."""
    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(backend, init_method=init_method, rank=rank_, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        out_q.put((rank_, "ok", fn(make_mesh(device_type, backend), *args)))
    except BaseException:
        out_q.put((rank_, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def start_ranks(fn, world: int, args=(), *, device_type: str = "cpu", backend: str = "gloo",
                init_method: str | None = None, timeout: float = 300.0,
                threads: int | None = None) -> Ranks:
    """Spawn `world` processes, each a rank of a one-host `backend` group at
    init_method (tcp://localhost:<a free port> where None) that runs
    fn(make_mesh(device_type, backend), *args). fn must be a top-level
    function of an importable module (the spawn start method pickles it by
    name), and its result picklable. timeout: every collective's, in
    seconds; threads: torch's thread count in each rank."""
    init_method = init_method or f"tcp://localhost:{free_port()}"
    ctx = torch.multiprocessing.get_context("spawn")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, args, device_type, backend,
                                                  init_method, timeout, threads, out_q))
             for r in range(world)]
    for p in procs:
        p.start()
    return Ranks(procs, out_q)


def join_ranks(ranks: Ranks, deadline: float) -> dict:
    """{rank: fn's result} of every rank by `deadline` (a time.time());
    raises RuntimeError with a failed rank's traceback, or naming the ranks
    that gave no result in time. Every rank is stopped before this
    returns."""
    procs, out_q = ranks
    got = {}
    try:
        while len(got) < len(procs):
            try:
                r, status, payload = out_q.get(timeout=max(deadline - time.time(), 0.1))
            except queue.Empty:
                raise RuntimeError(f"ranks {sorted(set(range(len(procs))) - set(got))} gave no "
                                   f"result within the deadline") from None
            if status != "ok":
                raise RuntimeError(f"rank {r} of {len(procs)} failed:\n{payload}")
            got[r] = payload
        for p in procs:
            p.join(timeout=max(deadline - time.time(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return got
