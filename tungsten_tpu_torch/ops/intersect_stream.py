"""Streaming brute-force closest hit: host pack, the CUDA kernel (K2) and its
twin.

Host half: a numpy copy of `PallasTriScene` (tungsten_tpu/ops/pallas_intersect.py
:171-204), bit for bit: `tris_t` (12, Tpad) with rows [v0 | e1 | e2 | 0 0 0],
Tpad a multiple of CHUNK = 2048 (zero padding triangles), and `clusters`
(n_chunks, 8) = [min3 | max3 | 0 0], the AABB of each chunk's real
triangles. TriPack adds what the CUDA kernels read, built from `tris_t`:
the node-major copy (n_chunks, CHUNK, 9) that the first CUDA form stages
from and the twin reads, the padded copy (Tpad, 12) = [v0 | e1 | e2 | 0 0 0]
per triangle (three 16-byte rows) that the kernel stages from, and the
sub-box table (n_chunks, CHUNK / SUB, 8): the AABB of each run of SUB = 32
consecutive real triangles, with `clusters`' f32 rounding; runs of padding
only hold an empty box (+inf | -inf), which no kernel reads. The triangles
keep their order: the prim id and the tie rule depend on it.

Kernel half: the port of K2, `_mt_kernel` (launched by `_launch`; API
intersect_pallas), as csrc/intersect_stream.cu and `stream_twin`, its plain
PyTorch version. The twin computes, per 256-ray tile and per 2048-triangle
chunk in order: the tile's vote, any live ray hitting the chunk's AABB with
tfar = min(ray tfar, best t so far) (slab test, inv = 1 / (d == 0 ? 1e-30 :
d)); where the tile votes, Moller-Trumbore of every ray of the tile against
every triangle of the chunk with `ray_tri`'s accept rule, the lowest index
winning a tie inside the chunk and a strictly smaller t needed across
chunks. A dead ray (tnear >= tfar) votes no, as the packet walk's `ray_ok`
rule has it (pallas_bvh.py:63): it can hit nothing, but the TPU kernel lets
it vote when its origin lies inside the box. The kernel culls finer, per
warp and per ray: a ray tests the triangles of the sub-boxes its own ray
hits in the chunks its own ray hits, so it agrees with the twin apart from
box-boundary rounding (csrc/intersect_stream.cu); `sub_box_work` counts the
tests that cull leaves, for the kernel's bound. `stream_cuda_v1` launches
the first CUDA form (csrc/intersect_stream_v1.cu, the tile vote of the
twin, bit-equal to it), kept for measurement; no query launches it. `stream`
picks by device: CUDA launches the kernel (or raises), CPU runs the twin;
each keeps a plain launch count.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import _build
from .bvh import mt_leaf
from .bvh8 import box_hit, check_rays, safe_inv
from .intersect import INF, Hit

RAY_TILE = 256  # rays per tile: one CUDA block (pallas_intersect.py RAY_TILE)
CHUNK = 2048  # triangles per chunk (pallas_intersect.py CHUNK)
SUB = 32  # triangles per sub-box of the kernel's cull (kSub in csrc/intersect_stream.cu)
_TWIN_RAYS = 8192  # rays per twin Moller-Trumbore step (bounds memory)


# ---------------------------------------------------------------------------
# host half
# ---------------------------------------------------------------------------

def build_tri_pack(v0, e1, e2) -> dict:
    """Numpy K2 pack in the JAX package's layout: {"tris_t" (12, Tpad),
    "clusters" (n_chunks, 8), "n_tris"}."""
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    t = len(v0)
    pad = (-t) % CHUNK
    if pad:
        z = np.zeros((pad, 3), np.float32)
        v0, e1, e2 = (np.concatenate([a, z]) for a in (v0, e1, e2))
    tp = len(v0)
    n_chunks = tp // CHUNK
    data = np.zeros((12, tp), np.float32)
    data[0:3] = v0.T
    data[3:6] = e1.T
    data[6:9] = e2.T
    p1 = v0 + e1
    p2 = v0 + e2
    lo = np.minimum(np.minimum(v0, p1), p2).reshape(n_chunks, CHUNK, 3)
    hi = np.maximum(np.maximum(v0, p1), p2).reshape(n_chunks, CHUNK, 3)
    cl = np.zeros((n_chunks, 8), np.float32)
    valid = (np.arange(tp).reshape(n_chunks, CHUNK) < t)[..., None]  # no padding in the AABB
    cl[:, 0:3] = np.where(valid, lo, np.inf).min(axis=1)
    cl[:, 3:6] = np.where(valid, hi, -np.inf).max(axis=1)
    return {"tris_t": data, "clusters": cl, "n_tris": t}


def sub_box_table(tris_t, n_tris: int) -> np.ndarray:
    """(n_chunks, CHUNK // SUB, 8) f32 [min3 | max3 | 0 0]: the AABB of each
    run of SUB consecutive triangles of `tris_t` (12, Tpad), rounded as
    `clusters` is (v0 + e1, v0 + e2 in f32), padding left out; a run of
    padding only holds +inf | -inf."""
    tris_t = np.asarray(tris_t, np.float32)
    tp = tris_t.shape[1]
    v0, e1, e2 = tris_t[0:3].T, tris_t[3:6].T, tris_t[6:9].T
    p1, p2 = v0 + e1, v0 + e2
    shape = (tp // CHUNK, CHUNK // SUB, SUB, 3)
    lo = np.minimum(np.minimum(v0, p1), p2).reshape(shape)
    hi = np.maximum(np.maximum(v0, p1), p2).reshape(shape)
    valid = (np.arange(tp) < n_tris).reshape(shape[:3])[..., None]
    table = np.zeros(shape[:2] + (8,), np.float32)
    table[..., 0:3] = np.where(valid, lo, np.inf).min(axis=2)
    table[..., 3:6] = np.where(valid, hi, -np.inf).max(axis=2)
    return table


@dataclass
class TriPack:
    """The K2 pack on one device: the JAX layouts plus the kernels' copies."""

    tris_t: torch.Tensor  # (12, Tpad) f32 rows [v0 | e1 | e2 | 0 0 0]
    clusters: torch.Tensor  # (n_chunks, 8) f32 [min3 | max3 | 0 0]
    tri_c: torch.Tensor  # (n_chunks, CHUNK, 9) f32 [v0 | e1 | e2] per triangle
    tri_p: torch.Tensor  # (Tpad, 12) f32 [v0 | e1 | e2 | 0 0 0] per triangle
    sub_boxes: torch.Tensor  # (n_chunks, CHUNK // SUB, 8) f32 [min3 | max3 | 0 0]
    n_tris: int

    @property
    def n_chunks(self) -> int:
        return self.clusters.shape[0]

    @property
    def n_subs(self):
        """(n_chunks,) the sub-boxes of each chunk that hold real triangles."""
        first = np.arange(self.n_chunks) * CHUNK
        return np.clip(-(-(self.n_tris - first) // SUB), 0, CHUNK // SUB)

    @staticmethod
    def from_arrays(arrays: dict, device) -> "TriPack":
        """From {"tris_t", "clusters", "n_tris"} (build_tri_pack's, or the JAX
        pack's attributes). Raises on shapes the kernels cannot take."""
        tris_t = np.asarray(arrays["tris_t"], np.float32)
        clusters = np.asarray(arrays["clusters"], np.float32)
        n_tris = int(np.asarray(arrays["n_tris"]))
        tp = tris_t.shape[1]
        if tris_t.shape != (12, tp) or tp % CHUNK or clusters.shape != (tp // CHUNK, 8) \
                or not 0 < n_tris <= tp:
            raise ValueError(f"tris_t {tris_t.shape} / clusters {clusters.shape} / "
                             f"n_tris {n_tris}: need (12, k*{CHUNK}), (k, 8), 0 < n_tris <= Tpad")
        tri_c = tris_t[:9].T.reshape(tp // CHUNK, CHUNK, 9)
        tri_p = np.zeros((tp, 12), np.float32)
        tri_p[:, :9] = tris_t[:9].T

        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=device)

        return TriPack(tris_t=t(tris_t), clusters=t(clusters), tri_c=t(tri_c), tri_p=t(tri_p),
                       sub_boxes=t(sub_box_table(tris_t, n_tris)), n_tris=n_tris)


# ---------------------------------------------------------------------------
# kernel half
# ---------------------------------------------------------------------------

def stream_twin(pack: TriPack, o, d, tnear, tfar):
    """Plain PyTorch K2 with the TPU kernel's tile votes and accept rules.
    Returns (t (n,) f32 (INF = miss), prim (n,) i64 (-1 = miss), u, v).
    `stream_twin.work` records the call's slab tests ("box"), the
    ray-triangle tests its rays need ("tri": 2048 per live ray and chunk
    whose box that ray hits) and those the tile cull runs ("tri_tile": 256
    rays x 2048 triangles per tile and chunk it keeps)."""
    stream_twin.launches += 1
    n = o.shape[0]
    dev = o.device
    n_tiles = -(-n // RAY_TILE)
    inv = safe_inv(d)
    best = torch.full((n,), INF, dtype=torch.float32, device=dev)
    prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros((n,), dtype=torch.float32, device=dev)
    bv = torch.zeros((n,), dtype=torch.float32, device=dev)
    alive = tnear < tfar
    edge = torch.zeros((n_tiles * RAY_TILE - n,), dtype=torch.bool, device=dev)  # vote no
    votes = ray_hits = 0
    for j in range(pack.n_chunks):
        lim = torch.minimum(tfar, best)
        hit = box_hit(pack.clusters[j], o, inv, tnear, lim) & alive
        vote = torch.cat([hit, edge]).view(n_tiles, RAY_TILE).any(dim=1)
        lanes = torch.nonzero(vote.repeat_interleave(RAY_TILE)[:n]).squeeze(1)
        votes += int(vote.sum())
        ray_hits += int(hit.sum())
        tri = pack.tri_c[j][None]  # (1, CHUNK, 9)
        for s in range(0, lanes.numel(), _TWIN_RAYS):
            ln = lanes[s:s + _TWIN_RAYS]
            t, u, v, h = mt_leaf(tri, o[ln], d[ln], tnear[ln], lim[ln])
            tb, k = torch.min(torch.where(h, t, INF), dim=1)  # lowest index wins a tie
            take = h.any(dim=1)  # every hit is below lim = min(tfar, best): strictly better
            best[ln] = torch.where(take, tb, best[ln])
            prim[ln] = torch.where(take, j * CHUNK + k, prim[ln])
            bu[ln] = torch.where(take, u.gather(1, k[:, None])[:, 0], bu[ln])
            bv[ln] = torch.where(take, v.gather(1, k[:, None])[:, 0], bv[ln])
    stream_twin.work = {"box": int(alive.sum()) * pack.n_chunks, "tri": ray_hits * CHUNK,
                        "tri_tile": votes * RAY_TILE * CHUNK}
    return best, prim, bu, bv


stream_twin.launches = 0
stream_twin.work = {"box": 0, "tri": 0, "tri_tile": 0}

# the stages at which the kernel's Moller-Trumbore test (csrc/walk_common.cuh
# `mt_exact`) leaves a pair: rejected on |det|, on the sign of u's, v's or t's
# numerator, or run to the end (the reciprocal and the accept rule)
MT_STAGES = ("det", "u", "v", "t", "full")


def _negative_quotient(num, det):
    """`negative_quotient` of csrc/walk_common.cuh: num / det rounds to a
    negative nonzero (the signs differ and |num| > 2^-100 |det|)."""
    return (torch.signbit(num) ^ torch.signbit(det)) & (num.abs() > det.abs() * 2.0 ** -100)


def mt_stage(T, o, d, tnear):
    """(k,) int64: the index in MT_STAGES at which `mt_exact` leaves each of k
    pairs, triangle T (k, 9) = v0 | e1 | e2 against ray (o, d, tnear); each
    operation rounded as the kernel rounds it (none contracted)."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = T.unbind(1)
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    un = tvx * px + tvy * py + tvz * pz
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    vn = dx * qx + dy * qy + dz * qz
    tn = e2x * qx + e2y * qy + e2z * qz
    stage = torch.full_like(tnear, 4, dtype=torch.int64)
    for k, rejected in reversed(list(enumerate((
            ~(det.abs() > 1e-12), _negative_quotient(un, det), _negative_quotient(vn, det),
            (tnear >= 0.0) & _negative_quotient(tn, det))))):
        stage = torch.where(rejected, k, stage)  # the first stage that rejects
    return stage


def sub_box_work(pack: TriPack, o, d, tnear, tfar) -> dict:
    """The tests the kernel's culls leave on these rays, for its bound: each
    live ray walks the chunks in order and slab-tests each chunk's box
    against min(tfar, best) ("box"); in a chunk its box hits, the chunk's
    real sub-boxes against the same limit ("box_sub"); and Moller-Trumbore
    on the real triangles of the sub-boxes it hits ("tri_sub"), split by the
    stage at which `mt_exact` leaves each pair ("mt_det", "mt_u", "mt_v",
    "mt_t", "mt_full"; MT_STAGES). best is the ray's closest hit in the
    chunks before, as the kernel finds it."""
    n = o.shape[0]
    dev = o.device
    inv = safe_inv(d)
    best = torch.full((n,), INF, dtype=torch.float32, device=dev)
    alive = tnear < tfar
    n_subs = pack.n_subs
    real = (torch.arange(pack.n_chunks * CHUNK, device=dev) < pack.n_tris).view(pack.n_chunks,
                                                                                CHUNK)
    work = dict.fromkeys(("box_sub", "tri_sub") + tuple(f"mt_{s}" for s in MT_STAGES), 0)
    work["box"] = int(alive.sum()) * pack.n_chunks
    for j in range(pack.n_chunks):
        lim = torch.minimum(tfar, best)
        hl = torch.nonzero(box_hit(pack.clusters[j], o, inv, tnear, lim) & alive).squeeze(1)
        m = int(n_subs[j])
        work["box_sub"] += hl.numel() * m
        for s in range(0, hl.numel(), _TWIN_RAYS):
            ln = hl[s:s + _TWIN_RAYS]
            h_sub = box_hit(pack.sub_boxes[j, :m], o[ln, None], inv[ln, None], tnear[ln, None],
                            lim[ln, None])  # (k, m)
            pair = torch.zeros((ln.numel(), CHUNK), dtype=torch.bool, device=dev)
            pair[:, :m * SUB] = h_sub.repeat_interleave(SUB, dim=1)
            ri, ti = torch.nonzero(pair & real[j]).unbind(1)
            work["tri_sub"] += ri.numel()
            stage = mt_stage(pack.tri_c[j][ti], o[ln][ri], d[ln][ri], tnear[ln][ri])
            for k, c in enumerate(torch.bincount(stage, minlength=len(MT_STAGES)).tolist()):
                work[f"mt_{MT_STAGES[k]}"] += c
            t, _, _, h = mt_leaf(pack.tri_c[j][ti][:, None], o[ln][ri], d[ln][ri],
                                 tnear[ln][ri], lim[ln][ri])
            tt = torch.full((ln.numel(), CHUNK), INF, dtype=torch.float32, device=dev)
            tt[ri, ti] = torch.where(h[:, 0], t[:, 0], INF)
            best[ln] = torch.minimum(best[ln], tt.min(dim=1).values)
    return work


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str, n_ptrs: int, n_ints: int):
    """csrc/<name>.cu's entry: rays (4 pointers), the pack (n_ptrs pointers,
    then n_ints ints), n, 4 outputs and the stream."""
    fn = getattr(_build.load_library(name), name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * (4 + n_ptrs) + [ctypes.c_int] * (n_ints + 1)
                   + [ctypes.c_void_p] * 5)
    return fn


def _launch(name, o, d, tnear, tfar, pack_ptrs, pack_ints):
    n = o.shape[0]
    out = torch.empty((3, n), dtype=torch.float32, device=o.device)  # t, u, v
    out_prim = torch.empty((n,), dtype=torch.int32, device=o.device)
    p = _build.ptr
    err = _kernel_fn(name, len(pack_ptrs), len(pack_ints))(
        p(o), p(d), p(tnear), p(tfar), *map(p, pack_ptrs), *pack_ints, n, p(out[0]),
        p(out_prim), p(out[1]), p(out[2]), _build.stream_of(o))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out[0], out_prim.long(), out[1], out[2]


def stream_cuda(pack: TriPack, o, d, tnear, tfar):
    """Launch the CUDA K2 (csrc/intersect_stream.cu) on the current stream.
    Returns (t, prim (i64, -1 = miss), u, v), as stream_twin."""
    check_rays(o, d, tnear, tfar)
    _build.check_cuda("pack.tri_p", pack.tri_p, torch.float32, (pack.n_chunks * CHUNK, 12),
                      like=o)
    _build.check_cuda("pack.clusters", pack.clusters, torch.float32, (pack.n_chunks, 8), like=o)
    _build.check_cuda("pack.sub_boxes", pack.sub_boxes, torch.float32,
                      (pack.n_chunks, CHUNK // SUB, 8), like=o)
    out = _launch("intersect_stream", o, d, tnear, tfar,
                  (pack.tri_p, pack.clusters, pack.sub_boxes), (pack.n_chunks, pack.n_tris))
    stream_cuda.launches += 1
    return out


stream_cuda.launches = 0


def stream_cuda_v1(pack: TriPack, o, d, tnear, tfar):
    """Launch the first CUDA form of K2 (csrc/intersect_stream_v1.cu: one
    thread per ray, the twin's tile vote), kept to be measured beside the
    kernel; no query launches it."""
    check_rays(o, d, tnear, tfar)
    _build.check_cuda("pack.tri_c", pack.tri_c, torch.float32, (pack.n_chunks, CHUNK, 9), like=o)
    _build.check_cuda("pack.clusters", pack.clusters, torch.float32, (pack.n_chunks, 8), like=o)
    out = _launch("intersect_stream_v1", o, d, tnear, tfar, (pack.tri_c, pack.clusters),
                  (pack.n_chunks,))
    stream_cuda_v1.launches += 1
    return out


stream_cuda_v1.launches = 0


def stream(pack: TriPack, o, d, tnear, tfar):
    """K2 on the rays' device: CUDA -> the kernel, CPU -> the twin."""
    if o.is_cuda:
        return stream_cuda(pack, o, d, tnear, tfar)
    if o.device.type == "cpu":
        return stream_twin(pack, o, d, tnear, tfar)
    raise ValueError(f"no K2 for device {o.device}")


def hit_from_stream(pack: TriPack, t, prim, u, v) -> Hit:
    """The Hit of a K2 launch's (t, prim, u, v) (intersect_pallas): prim is
    kept where t < INF and prim < n_tris; t = INF on a miss; u and v are the
    kernel's own (not clipped, not recomputed)."""
    prim = torch.where((t < INF) & (prim < pack.n_tris), prim, -1)
    return Hit(t=torch.where(prim >= 0, t, INF), prim=prim, u=u, v=v)


def intersect_stream(pack: TriPack, o, d, tnear, tfar) -> Hit:
    """Closest hit (intersect_pallas) through K2 on the rays' device."""
    return hit_from_stream(pack, *stream(pack, o, d, tnear, tfar))
