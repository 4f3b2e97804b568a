"""The photon-grid walk (K7): the CUDA walk and its twin.

Replaces the candidate loops of the JAX package's SPPM gathers
(tungsten_tpu/integrators/photon_map.py): the surface gather's 27-cell loop
`cell_body` (:1255-1280) with its kNN histogram `hist_body` (:1221-1247),
and the 3D DDA of `_volume_beam_gather` (:966-1035) and `_beam1d_gather`
(:482-577). Those are XLA loops, not Pallas; each of their rounds fetches,
for every lane, the MAX_PER_CELL = 32 photon rows of each of the 27 hash
cells around its cell and runs the accept test and the physics on all
N x 32 candidates. Eager PyTorch would spend some 80 launches on each of
27 cells a round and up to 96 rounds a camera bounce, so the candidate
loops are one kernel here, and the physics runs afterwards in PyTorch on
the accepted pairs only (integrators/photon_map.py).

Modes (per lane, one thread a lane in csrc/photon_walk.cu):

  * "surface": the gather point gp's cell floor(gp / cell), its 27
    neighbours (dx, dy, dz in -1, 0, 1, dz fastest), of each hash cell the
    first min(count, 32) rows from its start; a row is accepted when its
    bounce gate min <= bounce + pb - 1 < max holds and |p - gp|^2 < r2 (the
    lane's r^2: the fixed radius, or the kNN one);
  * "hist": the same candidates against r2 = r^2_max, counted in 32 bins of
    d^2 / r^2_max (the kNN histogram);
  * "points": the DDA along o + t d through cells 2 r wide, every round
    visiting the current cell's 27 neighbours; a volume photon counts
    where its foot point o + t* d, t* = clip((p - o).d, 0, seg), lies in the
    visited cell, |p - foot|^2 < r^2 and the bounce gate holds;
  * "beams": the same DDA over the beam stations; a station counts where
    intersectBeam1D gives perp < r, 0 < t < seg, its beam parameter s in
    [0, len] and in the station's interval [s0, s0 + r), and the gate holds.

The DDA's round count is global, as in the JAX package, whose while_loop
keeps every lane walking while any active lane has t < seg, up to
MAX_VOL_STEPS = 96 rounds: a first pass gives each lane's own count, and
every active lane then walks the largest. In points mode the foot-cell
test makes the extra rounds add nothing but what a foot on a cell boundary
finds there; in beams mode nothing ties a station to the visiting cell, so
a station counts once for each visited cell whose 27-neighbourhood holds
it, and a lane's estimate depends on how far the other lanes walk (a
caveat of the reference that the port reproduces).

Lanes outside `mask` are skipped: the JAX masks zero them (not gathered,
not in a medium, dead). The kernel emits the accepted (lane, row) pairs in
(lane, round, offset, slot) order, with two floats a pair: nothing
(surface), t* and |p - foot|^2 (points), t and 1 / sin (beams); a count
pass, an exclusive scan and a fill pass, so that the pairs repeat bit for
bit run to run. Every product and sum is rounded on its own in the twin's
order, so the kernel equals `walk_twin` bit for bit: pairs, floats and
histogram.

`walk` picks by the device of the lanes (CUDA: the kernel or an error,
never the twin; CPU: the twin). Each keeps a `.launches` count (the
kernel's: its launches, two or three a call; the twin's: its calls), and
the twin `.work` of its last call: "rounds" (the global round count),
"tests" (candidate rows tested), "pairs" and "lanes" (the walking lanes),
from which the kernel's bound is counted.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

MAX_PER_CELL = 32  # the rows a hash cell gives the gather (photon_map.py:36)
GRID_SIZE = 1 << 20  # hash table size (photon_map.py:37)
MAX_VOL_STEPS = 96  # the DDA's rounds at most (photon_map.py:398)
N_BINS = 32  # the kNN histogram's r^2 bins (photon_map.py:1219)
MODES = {"surface": 0, "hist": 1, "points": 2, "beams": 3}
ROW_WIDTH = {"surface": 10, "hist": 10, "points": 10, "beams": 13}
MASK32 = 0xFFFFFFFF
CANDIDATE_CHUNK = 1 << 24  # the twin's candidate rows at once
OFFSETS = tuple((dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1))
_I32_LO, _I32_HI = -2147483648.0, 2147483520.0  # the f32 values that fit int32


def hash_cell(ix, iy, iz):
    """The spatial hash of integer cells (photon_map.py:40-47), int64 in
    [0, GRID_SIZE): the coordinates as uint32 (negative ones wrap), the
    products and the xor mod 2^32."""
    h = (((ix.to(torch.int64) & MASK32) * 73856093) & MASK32) ^ (
        ((iy.to(torch.int64) & MASK32) * 19349663) & MASK32) ^ (
        ((iz.to(torch.int64) & MASK32) * 83492791) & MASK32)
    return h & (GRID_SIZE - 1)


def cell_of(x, size):
    """floor(x / size) as int32, saturated to int32's range (a float beyond
    it is undefined in torch's cast); size a 0-dim tensor on x's device,
    so that the division is IEEE on the card too (a Python scalar there
    becomes a product with its reciprocal)."""
    return torch.clamp(torch.floor(x / size), _I32_LO, _I32_HI).to(torch.int32)


def _f32(v, dev):
    return torch.tensor(float(v), dtype=torch.float32, device=dev)


def _dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _cross3(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _dda_setup(o, d, cell):
    """The DDA's start (photon_map.py:969-975): cell, step, t of the next
    boundary per axis, and the t between boundaries."""
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-12, 1e-12, d)
    stp = torch.where(d >= 0.0, 1, -1).to(torch.int32)
    c0 = cell_of(o, cell)
    nxt = (c0.to(torch.float32) + (d >= 0.0).to(torch.float32)) * cell
    return c0, stp, (nxt - o) * inv_d, torch.abs(cell * inv_d)


def _dda_step(c, stp, tm, tdelta):
    """One round: the axis of the nearest boundary (the first on ties) is
    crossed; returns t there and the new cell and boundaries."""
    ax = torch.zeros(tm.shape[0], dtype=torch.int64, device=tm.device)
    best = tm[:, 0]
    for k in (1, 2):
        take = tm[:, k] < best
        ax = torch.where(take, k, ax)
        best = torch.where(take, tm[:, k], best)
    onehot = torch.nn.functional.one_hot(ax, 3).to(torch.bool)
    c = torch.where(onehot, c + stp, c)
    tm = torch.where(onehot, tm + tdelta, tm)
    return best, c, tm


def _accept(mode, rows, lane_o, lane_d, lim, bounce, c_vis, cell, r, r2, step, min_b, max_b):
    """The accept test of `mode` on candidate rows (K, W) with their lanes'
    quantities; returns (ok (K,), a (K,), b (K,))."""
    pb = rows[:, 10 if mode == "beams" else 9].to(torch.int32)
    full_b = bounce + pb - 1
    gate = (full_b >= min_b) & (full_b < max_b)
    if mode in ("surface", "hist"):
        e = rows[:, 0:3] - lane_o
        d2 = _dot3(e, e)
        return gate & (d2 < lim), d2, None
    if mode == "points":
        p = rows[:, 0:3]
        t_star = torch.minimum(torch.clamp(_dot3(p - lane_o, lane_d), min=0.0), lim)
        foot = lane_o + t_star[:, None] * lane_d
        dedup = torch.all(cell_of(foot, cell) == c_vis, dim=-1)
        e = p - foot
        dist2 = _dot3(e, e)
        return dedup & (dist2 < r2) & gate, t_star, dist2
    b_o, b_d, b_len, b_s0 = rows[:, 0:3], rows[:, 3:6], rows[:, 6], rows[:, 12]
    lv = b_o - lane_o
    c = _cross3(lv, b_d)
    u = c / torch.clamp(torch.sqrt(torch.clamp(_dot3(c, c), min=0.0)), min=1e-12)[:, None]
    nv = _cross3(b_d, u)
    denom = _dot3(nv, lane_d)
    t = _dot3(nv, lv) / torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    hb = (lane_o + lane_d * t[:, None]) - b_o
    cosr = _dot3(lane_d, b_d)
    inv_sin = 1.0 / torch.sqrt(torch.clamp(1.0 - cosr * cosr, min=1e-8))
    perp = torch.abs(_dot3(u, hb))
    s_cr = _dot3(b_d, hb)
    ok = ((perp < r) & (t > 0.0) & (t < lim) & (s_cr >= 0.0) & (s_cr <= b_len)
          & (s_cr >= b_s0) & (s_cr < b_s0 + step) & gate)
    return ok, t, inv_sin


def walk_twin(mode, pack, starts, counts, o, d, lim, bounce, mask, cell, r=0.0,
              min_b=0, max_b=64):
    """The walk in plain PyTorch, lockstep over the lanes of `mask`.

    pack (M, 10 or 13) f32 rows, starts / counts (GRID_SIZE,) int32; o
    (N, 3): the gather points (surface, hist) or ray origins; d (N, 3) the
    ray directions (None for surface and hist); lim (N,) f32: r^2 a lane
    (surface; hist: r^2_max), or the segment length (points, beams; 0
    outside the mask); bounce (N,) int32: the camera bounce; cell: the
    cell size; r: the volume radius (points, beams; the beams' station
    step too). Returns (N, 32) int32 (hist), (lane, row) int64 (surface),
    or (lane, row, a, b) (points: t*, dist^2; beams: t, 1 / sin)."""
    walk_twin.launches += 1
    dev = o.device
    n = o.shape[0]
    cell_t, r_t = _f32(cell, dev), _f32(r, dev)
    r2_t, step_t = r_t * r_t, r_t
    lanes = torch.nonzero(mask).squeeze(1)
    lo, llim, lb = o[lanes], lim[lanes], bounce[lanes].to(torch.int32)
    ld = d[lanes] if d is not None else None
    volume = mode in ("points", "beams")
    if volume:
        c, stp, tm, tdelta = _dda_setup(lo, ld, cell_t)
        # each lane's own rounds, then the global count (photon_map.py:560-562)
        t = torch.zeros_like(llim)
        cc, ctm = c.clone(), tm.clone()
        own = torch.zeros_like(lb)
        for _ in range(MAX_VOL_STEPS):
            need = t < llim
            if not bool(need.any()):
                break
            own += need.to(torch.int32)
            t, cc, ctm = _dda_step(cc, stp, ctm, tdelta)
        rounds = int(own.max()) if own.numel() else 0
    else:
        c = cell_of(lo, cell_t)
        rounds = 1
    offs = torch.tensor(OFFSETS, dtype=torch.int32, device=dev)
    k = lanes.shape[0]
    hist = torch.zeros((n, N_BINS), dtype=torch.int32, device=dev) if mode == "hist" else None
    got_l, got_r, got_a, got_b = [], [], [], []
    tests = 0
    for _ in range(rounds):
        nb = (c[:, None, :] + offs[None]).reshape(-1, 3)  # lane-major, then offset
        h = hash_cell(nb[:, 0], nb[:, 1], nb[:, 2])
        cnt = torch.clamp(counts[h], max=MAX_PER_CELL).to(torch.int64)
        start = starts[h].to(torch.int64)
        ends = torch.cumsum(cnt, 0)
        n_rows = int(ends[-1]) if ends.numel() else 0
        tests += n_rows
        # the (lane, offset) cells in runs of about CANDIDATE_CHUNK rows
        cuts = [] if n_rows <= CANDIDATE_CHUNK else torch.searchsorted(
            ends, torch.arange(CANDIDATE_CHUNK, n_rows, CANDIDATE_CHUNK, device=dev),
            side="right").tolist()
        for lo_c, hi_c in zip([0] + cuts, cuts + [k * 27]):
            if hi_c <= lo_c:
                continue
            sub = torch.arange(lo_c, hi_c, device=dev)
            slot_of = torch.repeat_interleave(sub, cnt[lo_c:hi_c])
            first = ends - cnt
            slot = torch.arange(slot_of.shape[0], device=dev) + first[lo_c] - first[slot_of]
            row = start[slot_of] + slot
            cand = slot_of // 27
            ok, a, b = _accept(mode, pack[row], lo[cand], ld[cand] if volume else None,
                               llim[cand], lb[cand], c[cand], cell_t, r_t, r2_t, step_t, min_b,
                               max_b)
            if mode == "hist":
                bins = torch.clamp((a / llim[cand] * float(N_BINS)).to(torch.int32),
                                   max=N_BINS - 1)
                hist.index_put_((lanes[cand[ok]], bins[ok].to(torch.int64)),
                                torch.ones_like(bins[ok]), accumulate=True)
            else:
                got_l.append(lanes[cand[ok]])
                got_r.append(row[ok])
                if volume:
                    got_a.append(a[ok])
                    got_b.append(b[ok])
        if volume:
            _, c, tm = _dda_step(c, stp, tm, tdelta)
    pairs = sum(int(x.shape[0]) for x in got_l)
    walk_twin.work = {"rounds": rounds if volume else 0, "tests": tests, "pairs": pairs,
                      "lanes": k}
    if mode == "hist":
        return hist
    empty_i = torch.zeros(0, dtype=torch.int64, device=dev)
    lane = torch.cat(got_l) if got_l else empty_i
    order = torch.argsort(lane, stable=True)  # (lane, round, offset, slot)
    row = (torch.cat(got_r) if got_r else empty_i)[order]
    if not volume:
        return lane[order], row
    empty_f = torch.zeros(0, dtype=torch.float32, device=dev)
    return (lane[order], row, (torch.cat(got_a) if got_a else empty_f)[order],
            (torch.cat(got_b) if got_b else empty_f)[order])


walk_twin.launches = 0
walk_twin.work = {"rounds": 0, "tests": 0, "pairs": 0, "lanes": 0}


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """photon_walk(mode, phase, pack, row_w, starts, counts, o, d, lim, bounce,
    mask, n, cell, r, min_b, max_b, rounds, offsets, count_out, lane_out,
    row_out, a_out, b_out, stream) of csrc/photon_walk.cu."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _build.load_library("photon_walk").photon_walk
    fn.restype = i
    fn.argtypes = [i, i, p, i, p, p, p, p, p, p, p, i, f, f, i, i, i, p, p, p, p, p, p, p]
    return fn


def _launch(mode, phase, pack, starts, counts, o, d, lim, bounce, mask, cell, r, min_b, max_b,
            rounds=0, offsets=None, count_out=None, lane_out=None, row_out=None, a_out=None,
            b_out=None):
    p = _build.ptr
    err = _kernel_fn()(MODES[mode], phase, p(pack), pack.shape[1], p(starts), p(counts), p(o),
                       p(d), p(lim), p(bounce), p(mask), o.shape[0], float(cell), float(r),
                       int(min_b), int(max_b), int(rounds), p(offsets), p(count_out),
                       p(lane_out), p(row_out), p(a_out), p(b_out), _build.stream_of(o))
    if err != 0:
        raise RuntimeError(f"photon_walk launch failed: CUDA error {err}")
    walk_cuda.launches += 1


def walk_cuda(mode, pack, starts, counts, o, d, lim, bounce, mask, cell, r=0.0, min_b=0,
              max_b=64):
    """Launch csrc/photon_walk.cu on the current stream: for points and
    beams a rounds pass (then the global count, one sync), then a count
    pass, an exclusive scan (one sync for the total) and a fill pass; for
    hist one pass. Returns as walk_twin."""
    n = o.shape[0]
    dev = o.device
    w = ROW_WIDTH[mode]
    _build.check_cuda("pack", pack, torch.float32, like=o)
    if pack.dim() != 2 or pack.shape[1] != w:
        raise ValueError(f"pack: need (M, {w}) rows for mode {mode!r}, got {tuple(pack.shape)}")
    _build.check_cuda("starts", starts, torch.int32, (GRID_SIZE,), like=o)
    _build.check_cuda("counts", counts, torch.int32, (GRID_SIZE,), like=o)
    _build.check_cuda("o", o, torch.float32, (n, 3))
    volume = mode in ("points", "beams")
    if volume:
        _build.check_cuda("d", d, torch.float32, (n, 3), like=o)
    _build.check_cuda("lim", lim, torch.float32, (n,), like=o)
    _build.check_cuda("bounce", bounce, torch.int32, (n,), like=o)
    lane_mask = mask.to(torch.uint8).contiguous()
    _build.check_cuda("mask", lane_mask, torch.uint8, (n,), like=o)
    args = (pack, starts, counts, o, d if volume else None, lim, bounce, lane_mask, cell, r,
            min_b, max_b)
    if mode == "hist":
        hist = torch.zeros((n, N_BINS), dtype=torch.int32, device=dev)
        _launch(mode, 1, *args, count_out=hist)
        return hist
    rounds = 0
    if volume:
        own = torch.zeros((n,), dtype=torch.int32, device=dev)
        _launch(mode, 0, *args, count_out=own)
        rounds = int(own.max()) if n else 0
    per_lane = torch.zeros((n,), dtype=torch.int32, device=dev)
    _launch(mode, 1, *args, rounds=rounds, count_out=per_lane)
    ends = torch.cumsum(per_lane.to(torch.int64), 0)
    total = int(ends[-1]) if n else 0
    offsets = (ends - per_lane).contiguous()
    lane = torch.empty((total,), dtype=torch.int32, device=dev)
    row = torch.empty((total,), dtype=torch.int32, device=dev)
    a = torch.empty((total,), dtype=torch.float32, device=dev) if volume else None
    b = torch.empty((total,), dtype=torch.float32, device=dev) if volume else None
    if total:
        _launch(mode, 2, *args, rounds=rounds, offsets=offsets, lane_out=lane, row_out=row,
                a_out=a, b_out=b)
    if not volume:
        return lane.to(torch.int64), row.to(torch.int64)
    return lane.to(torch.int64), row.to(torch.int64), a, b


walk_cuda.launches = 0


def walk(mode, pack, starts, counts, o, d, lim, bounce, mask, cell, r=0.0, min_b=0, max_b=64):
    """K7 on the lanes' device: CUDA -> the kernel, CPU -> the twin."""
    if o.is_cuda:
        return walk_cuda(mode, pack, starts, counts, o, d, lim, bounce, mask, cell, r, min_b,
                         max_b)
    if o.device.type == "cpu":
        return walk_twin(mode, pack, starts, counts, o, d, lim, bounce, mask, cell, r, min_b,
                         max_b)
    raise ValueError(f"no K7 walk for device {o.device}")
