"""The exact voxel DDA (K6): the CUDA walk and its twin.

Replaces the JAX package's exact cell walk `_dda_cells` with the folds of
`grid_optical_depth` and `_grid_inverse_exact`
(tungsten_tpu/models/grids/grid.py:156-197, 216-230, 256-290): an XLA
`lax.while_loop`, not Pallas, that walks every lane across the
interpolation cells of a dense grid. Per lane, from the wrapper's oq, dq
(the ray in grid coordinates: grid point = oq + dq t) and its clipped span
[ta, tb]:

  * a round steps to the next cell boundary: the dual cells (boundaries at
    half-integers) of trilinear sampling, or the data cells (integers) of
    nearest sampling, at least 1e-6 beyond the current t, at most tb;
  * it adds the cell's exact optical depth (`segment_tau`): 2-point
    Gauss-Legendre of the trilinear field (exact for its cubic along a
    line), or the midpoint of the constant cell;
  * mode "tau" sums the depth over [ta, tb]; mode "inverse" stops in the
    first cell where the sum reaches tau_target and runs 24 bisection rounds
    on the cell's exact integral, returning t there, or INF where the target
    is never reached;
  * at most MAX_ROUNDS (4,096) rounds a lane (the JAX loop's backstop).

`walk_twin` is that loop in plain PyTorch, lockstep over the lanes still
walking. `walk_cuda` launches csrc/grid_walk.cu: a list pass compacts the
walking lanes on the card, then GROUP (4) threads take each listed lane
and repeat: every thread steps the same boundaries GROUP rounds ahead (no
loads), thread j evaluates round j's segment, and every thread folds the
depths in round order; the found lanes bisect BISECT_DEPTH rounds a step,
a tree of midpoints evaluated at once (`walk_ahead` is that schedule in
plain PyTorch). It rounds every product and sum on its own in the twin's
order and so equals the twin bit for bit, as does the first CUDA form,
`walk_cuda_v1` (csrc/grid_walk_v1.cu, one thread a lane over all lanes),
which only the measurements launch. `walk` picks by the device of the rays
(CUDA: the kernel or an error, never the twin; CPU: the twin). A lane mask
skips the lanes of other media: the JAX package computes them and discards
them with `where`, so skipping them changes no result; a skipped lane
returns 0 (tau) or INF (inverse). Each keeps a `.launches` count (the
kernel's: two a call, the list and the walk); the twin also `.work`, its
lane-rounds ("rounds") and bisection lane-rounds ("bisect") of the last
call, from which the kernel's bound is counted, and the rounds of its
longest lane ("longest").
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

INF = 3.0e38
MAX_ROUNDS = 4096  # _MAX_DDA, the runaway backstop (csrc/grid_walk.cu kMaxRounds)
BISECT_ROUNDS = 24
GROUP = 4  # threads a lane and rounds a step of the kernel (csrc/grid_walk.cu kGroup)
BISECT_DEPTH = 2  # bisection rounds a step of the kernel (kDepth)
_G2 = 0.5 / np.sqrt(3.0)  # Gauss-Legendre 2-point node offset on [0, 1]
# the two Gauss nodes as the f32 values both the twin and the kernel use
GAUSS_OFFS = (float(np.float32(0.5 - _G2)), float(np.float32(0.5 + _G2)))
MODES = {"tau": 0, "inverse": 1}


def sample_nearest(density, q):
    """Nearest sampling of a (nz, ny, nx) grid at grid points q (k, 3);
    0 outside [0, n)."""
    nz, ny, nx = density.shape
    ix = torch.clamp(q[:, 0].to(torch.int32), 0, nx - 1).long()
    iy = torch.clamp(q[:, 1].to(torch.int32), 0, ny - 1).long()
    iz = torch.clamp(q[:, 2].to(torch.int32), 0, nz - 1).long()
    inside = ((q[:, 0] >= 0.0) & (q[:, 0] < nx) & (q[:, 1] >= 0.0) & (q[:, 1] < ny)
              & (q[:, 2] >= 0.0) & (q[:, 2] < nz))
    return torch.where(inside, density.reshape(-1)[(iz * ny + iy) * nx + ix], 0.0)


def sample_linear(arr, q):
    """Trilinear sampling with zero outside, cell centers at integer + 0.5:
    arr (nz, ny, nx) -> (k,), or (nz, ny, nx, c) -> (k, c). The corners add
    in the order z, y, x, each weight the product (wx wy) wz."""
    nz, ny, nx = arr.shape[:3]
    flat = arr.reshape(nz * ny * nx, -1)
    qc = q - 0.5
    i0 = torch.floor(qc).to(torch.int32)
    f = qc - i0
    out = None
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                ix = i0[:, 0] + dx
                iy = i0[:, 1] + dy
                iz = i0[:, 2] + dz
                inb = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) & (iz >= 0) & (iz < nz)
                k = ((torch.clamp(iz, 0, nz - 1).long() * ny + torch.clamp(iy, 0, ny - 1).long())
                     * nx + torch.clamp(ix, 0, nx - 1).long())
                v = flat[k]
                wx = f[:, 0] if dx else 1.0 - f[:, 0]
                wy = f[:, 1] if dy else 1.0 - f[:, 1]
                wz = f[:, 2] if dz else 1.0 - f[:, 2]
                wgt = (wx * wy * wz)[:, None]
                term = torch.where(inb[:, None], v, 0.0) * wgt
                out = term if out is None else out + term
    return out if arr.dim() == 4 else out[:, 0]


def segment_tau(density, linear, t_a, t_b, oq, dq):
    """Exact optical depth of [t_a, t_b] inside ONE interpolation cell:
    Gauss-2 (exact for the trilinear cubic) or the midpoint (exact for the
    constant nearest cell)."""
    h = t_b - t_a
    if linear:
        tau = None
        for off in GAUSS_OFFS:
            t = t_a + h * off
            s = sample_linear(density, oq + dq * t[:, None])
            tau = s if tau is None else tau + s
        return 0.5 * h * tau
    t = t_a + 0.5 * h
    return h * sample_nearest(density, oq + dq * t[:, None])


def walk_twin(density, linear, oq, dq, ta, tb, mode="tau", tau_target=None, mask=None):
    """The DDA in plain PyTorch on the lanes of `mask` (all when None),
    lockstep over the lanes still walking. Returns (N,) f32: the optical
    depth over [ta, tb] (mode "tau"), or the t where it reaches tau_target,
    INF where it does not (mode "inverse")."""
    walk_twin.launches += 1
    inverse = MODES[mode] == 1
    n, dev = oq.shape[0], oq.device
    out = torch.full((n,), INF if inverse else 0.0, device=dev)
    lanes = torch.arange(n, device=dev) if mask is None else torch.nonzero(mask).squeeze(1)
    oq, dq, ta, tb = oq[lanes], dq[lanes], ta[lanes], tb[lanes]
    target = tau_target[lanes] if inverse else None
    shift = 0.5 if linear else 0.0
    small = torch.abs(dq) < 1e-12
    inv_dq = 1.0 / torch.where(small, 1e-12, dq)
    k = lanes.shape[0]
    t_cur = ta.clone()
    tau = torch.zeros((k,), device=dev)
    done = tb <= ta
    seg_a = torch.zeros((k,), device=dev)
    seg_b = torch.zeros((k,), device=dev)
    tau_at_a = torch.zeros((k,), device=dev)
    found = torch.zeros((k,), dtype=torch.bool, device=dev)
    rounds = lane_rounds = 0
    while rounds < MAX_ROUNDS:
        act = torch.nonzero(~done).squeeze(1)
        if act.numel() == 0:
            break
        lane_rounds += act.numel()
        a_oq, a_dq, a_t, a_tb = oq[act], dq[act], t_cur[act], tb[act]
        q = (a_oq + a_dq * a_t[:, None]) - shift
        stepped = torch.where(a_dq > 0.0, torch.floor(q) + 1.0, torch.ceil(q) - 1.0)
        t_ax = (stepped + shift - a_oq) * inv_dq[act]
        t_ax = torch.where(small[act], 3.0e37, t_ax)  # a degenerate axis never wins
        tn = torch.maximum(torch.amin(t_ax, dim=1), a_t + 1e-6)  # monotone progress
        t_next = torch.minimum(tn, a_tb)
        live = t_next > a_t
        dt = torch.where(live, segment_tau(density, linear, a_t, t_next, a_oq, a_dq), 0.0)
        a_tau = tau[act]
        new_done = t_next >= a_tb
        if inverse:
            crosses = live & ~found[act] & (a_tau + dt >= target[act])
            ci = act[crosses]
            seg_a[ci], seg_b[ci], tau_at_a[ci] = a_t[crosses], t_next[crosses], a_tau[crosses]
            found[ci] = True
            new_done = new_done | found[act]
        tau[act] = a_tau + dt
        t_cur[act] = torch.where(live, t_next, a_t)
        done[act] = new_done
        rounds += 1
    bisect = 0
    if inverse:
        fi = torch.nonzero(found).squeeze(1)
        bisect = BISECT_ROUNDS * fi.numel()
        sa, lo, hi = seg_a[fi], seg_a[fi], seg_b[fi]
        ta0, tgt, f_oq, f_dq = tau_at_a[fi], target[fi], oq[fi], dq[fi]
        for _ in range(BISECT_ROUNDS):
            mid = 0.5 * (lo + hi)
            go_hi = ta0 + segment_tau(density, linear, sa, mid, f_oq, f_dq) < tgt
            lo = torch.where(go_hi, mid, lo)
            hi = torch.where(go_hi, hi, mid)
        out[lanes[fi]] = 0.5 * (lo + hi)
    else:
        out[lanes] = tau
    walk_twin.work = {"rounds": lane_rounds, "bisect": bisect, "longest": rounds}
    return out


walk_twin.launches = 0
walk_twin.work = {"rounds": 0, "bisect": 0, "longest": 0}


def walking_lanes(ta, tb, mask=None):
    """The lanes that walk, ascending: in `mask` (all when None) and with
    tb <= ta not true (a NaN span walks, to the backstop). The kernel's
    list pass keeps the same set, in the order its warps append them."""
    walks = ~(tb <= ta)
    if mask is not None:
        walks = walks & mask.to(torch.bool)
    return torch.nonzero(walks).squeeze(1)


def walk_ahead(density, linear, oq, dq, ta, tb, mode="tau", tau_target=None, mask=None,
               ahead=GROUP, depth=BISECT_DEPTH):
    """The kernel's schedule in plain PyTorch, returning as walk_twin: the
    walking lanes (`walking_lanes`) step their boundary sequence `ahead`
    rounds at a time, every live (lane, round) segment of the step is
    evaluated at once, then each lane folds the step's depths in round
    order, stopping where the walk stops (the inverse's first crossing,
    tb, or MAX_ROUNDS); the found lanes then bisect `depth` rounds a step:
    the 2^depth - 1 midpoints of the tree below the current interval (node
    k's path the bits of k below its leading one, 1 = the upper half)
    evaluated at once, then the interval descends through their votes."""
    inverse = MODES[mode] == 1
    n, dev = oq.shape[0], oq.device
    out = torch.full((n,), INF if inverse else 0.0, device=dev)
    lanes = walking_lanes(ta, tb, mask)
    oq, dq, t, tb = oq[lanes], dq[lanes], ta[lanes].clone(), tb[lanes]
    target = tau_target[lanes] if inverse else None
    shift = 0.5 if linear else 0.0
    small = torch.abs(dq) < 1e-12
    inv_dq = 1.0 / torch.where(small, 1e-12, dq)
    k = lanes.shape[0]
    tau = torch.zeros((k,), device=dev)
    seg = torch.zeros((k, 3), device=dev)  # seg_a, seg_b, tau_at_a
    found = torch.zeros((k,), dtype=torch.bool, device=dev)
    active = torch.ones((k,), dtype=torch.bool, device=dev)
    rounds = 0
    while rounds < MAX_ROUNDS and bool(active.any()):
        act = torch.nonzero(active).squeeze(1)
        # (1) the boundaries `ahead` rounds on; a lane stops stepping at tb
        tt = t[act]
        t_a = torch.zeros((act.numel(), ahead), device=dev)
        t_n = torch.zeros((act.numel(), ahead), device=dev)
        valid = torch.zeros((act.numel(), ahead), dtype=torch.bool, device=dev)
        going = torch.ones((act.numel(),), dtype=torch.bool, device=dev)
        for r in range(min(ahead, MAX_ROUNDS - rounds)):
            q = (oq[act] + dq[act] * tt[:, None]) - shift
            stepped = torch.where(dq[act] > 0.0, torch.floor(q) + 1.0, torch.ceil(q) - 1.0)
            t_ax = torch.where(small[act], 3.0e37, (stepped + shift - oq[act]) * inv_dq[act])
            tn = torch.minimum(torch.maximum(torch.amin(t_ax, dim=1), tt + 1e-6), tb[act])
            t_a[:, r], t_n[:, r], valid[:, r] = tt, tn, going
            tt = torch.where(going & (tn > tt), tn, tt)
            going = going & ~(tn >= tb[act])
        # (2) every live segment of the chunk at once
        live = valid & (t_n > t_a)
        li, lr = torch.nonzero(live, as_tuple=True)
        dt = torch.zeros_like(t_a)
        dt[li, lr] = segment_tau(density, linear, t_a[li, lr], t_n[li, lr], oq[act[li]],
                                 dq[act[li]])
        # (3) the fold, in round order
        for r in range(ahead):
            run = valid[:, r] & active[act]
            if not bool(run.any()):
                break
            a = act[run]
            tn, lv, d_r = t_n[run, r], live[run, r], dt[run, r]
            done = tn >= tb[a]
            if inverse:
                cross = lv & ~found[a] & (tau[a] + d_r >= target[a])
                ci = a[cross]
                seg[ci] = torch.stack([t[ci], tn[cross], tau[ci]], dim=1)
                found[ci] = True
                done = done | found[a]
            tau[a] = tau[a] + d_r
            t[a] = torch.where(lv, tn, t[a])
            active[a] = ~done
        rounds += ahead
    if inverse:
        fi = torch.nonzero(found).squeeze(1)
        sa, lo, hi, ta0 = seg[fi, 0], seg[fi, 0], seg[fi, 1], seg[fi, 2]
        for _ in range(0, BISECT_ROUNDS, depth):
            votes = []
            for k in range(1, 1 << depth):  # the tree's nodes, heap order
                lk, hk = lo, hi
                for b in range(k.bit_length() - 2, -1, -1):
                    mid = 0.5 * (lk + hk)
                    lk, hk = (mid, hk) if (k >> b) & 1 else (lk, mid)
                votes.append(ta0 + segment_tau(density, linear, sa, 0.5 * (lk + hk), oq[fi], dq[fi])
                             < target[fi])
            node = torch.ones_like(fi)
            for _ in range(depth):
                go_hi = torch.stack(votes, 1).gather(1, (node - 1)[:, None])[:, 0]
                mid = 0.5 * (lo + hi)
                lo = torch.where(go_hi, mid, lo)
                hi = torch.where(go_hi, hi, mid)
                node = 2 * node + go_hi.to(node.dtype)
        out[lanes[fi]] = 0.5 * (lo + hi)
    else:
        out[lanes] = tau
    return out


def _check_inputs(density, oq, dq, ta, tb, mode, tau_target, mask):
    n = oq.shape[0]
    _build.check_cuda("density", density, torch.float32, like=oq)
    if density.dim() != 3:
        raise ValueError(f"density: need (nz, ny, nx), got {tuple(density.shape)}")
    _build.check_cuda("oq", oq, torch.float32, (n, 3))
    _build.check_cuda("dq", dq, torch.float32, (n, 3), like=oq)
    _build.check_cuda("ta", ta, torch.float32, (n,), like=oq)
    _build.check_cuda("tb", tb, torch.float32, (n,), like=oq)
    if MODES[mode] == 1:
        _build.check_cuda("tau_target", tau_target, torch.float32, (n,), like=oq)
    lane_mask = None
    if mask is not None:
        lane_mask = mask.to(torch.uint8).contiguous()
        _build.check_cuda("mask", lane_mask, torch.uint8, (n,), like=oq)
    return lane_mask


@functools.lru_cache(maxsize=None)
def _kernel_fn(name):
    """grid_walk(density, nx, ny, nz, linear, oq, dq, ta, tb, target, mask,
    mode, g0, g1, n, out, list, count, stream) of csrc/grid_walk.cu, or
    grid_walk_v1(... n, out, stream) of csrc/grid_walk_v1.cu."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = getattr(_build.load_library(name), name)
    fn.restype = i
    fn.argtypes = [p, i, i, i, i] + [p] * 6 + [i, f, f, i, p] + (
        [p, p, p] if name == "grid_walk" else [p])
    return fn


def walk_cuda(density, linear, oq, dq, ta, tb, mode="tau", tau_target=None, mask=None):
    """Launch csrc/grid_walk.cu (the list pass and the walk) on the current
    stream; returns as walk_twin."""
    lane_mask = _check_inputs(density, oq, dq, ta, tb, mode, tau_target, mask)
    n, m = oq.shape[0], MODES[mode]
    nz, ny, nx = density.shape
    out = torch.empty((n,), dtype=torch.float32, device=oq.device)
    scratch = torch.empty((n + 1,), dtype=torch.int32, device=oq.device)  # list, count
    p = _build.ptr
    err = _kernel_fn("grid_walk")(
        p(density), nx, ny, nz, int(bool(linear)), p(oq), p(dq), p(ta), p(tb),
        p(tau_target if m == 1 else None), p(lane_mask), m, GAUSS_OFFS[0], GAUSS_OFFS[1], n,
        p(out), p(scratch), ctypes.c_void_p(scratch.data_ptr() + 4 * n), _build.stream_of(oq))
    if err != 0:
        raise RuntimeError(f"grid_walk launch failed: CUDA error {err}")
    walk_cuda.launches += 2 if n else 0
    return out


walk_cuda.launches = 0


def walk_cuda_v1(density, linear, oq, dq, ta, tb, mode="tau", tau_target=None, mask=None):
    """Launch the first CUDA form, csrc/grid_walk_v1.cu (one thread a lane
    over all lanes), on the current stream; returns as walk_twin. For
    measurement only: no render calls it."""
    lane_mask = _check_inputs(density, oq, dq, ta, tb, mode, tau_target, mask)
    n, m = oq.shape[0], MODES[mode]
    nz, ny, nx = density.shape
    out = torch.empty((n,), dtype=torch.float32, device=oq.device)
    p = _build.ptr
    err = _kernel_fn("grid_walk_v1")(
        p(density), nx, ny, nz, int(bool(linear)), p(oq), p(dq), p(ta), p(tb),
        p(tau_target if m == 1 else None), p(lane_mask), m, GAUSS_OFFS[0], GAUSS_OFFS[1], n,
        p(out), _build.stream_of(oq))
    if err != 0:
        raise RuntimeError(f"grid_walk_v1 launch failed: CUDA error {err}")
    walk_cuda_v1.launches += 1 if n else 0
    return out


walk_cuda_v1.launches = 0


def walk(density, linear, oq, dq, ta, tb, mode="tau", tau_target=None, mask=None):
    """K6 on the rays' device: CUDA -> the kernel, CPU -> the twin."""
    if oq.is_cuda:
        return walk_cuda(density, linear, oq, dq, ta, tb, mode, tau_target, mask)
    if oq.device.type == "cpu":
        return walk_twin(density, linear, oq, dq, ta, tb, mode, tau_target, mask)
    raise ValueError(f"no K6 walk for device {oq.device}")
