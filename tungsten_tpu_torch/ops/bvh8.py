"""8-wide BVH: host-side pack build, the two CUDA walks (K3 exact and
K3-fast) and their plain twins.

Host half: numpy copies of `_woop_planes` (tungsten_tpu/ops/pallas_bvh2.py)
and `_collapse8` / `build_bvh_pack8` (tungsten_tpu/ops/pallas_bvh8.py), so the
pack (boxes, kid, order, planes, prim_map) is identical to the JAX package's,
and so is the bf16 split of the planes (hi = bf16(p), lo = bf16(p - f32(hi)),
round to nearest even) that the fast walk reads.

Kernel half: the port of K3, `_walk_kernel8` (pallas_bvh8.py), in its two
forms, both walking inner nodes per thread and leaves per warp (the skeleton
of csrc/walk_common.cuh: a warp stages each leaf its rays want into shared
memory once and tests it for all of them). fast=False is csrc/bvh8_walk.cu
(`walk_cuda`: the 128 slots split across the lanes, per-ray latch).
fast=True is csrc/bvh8_walk_fast.cu (`walk_fast_cuda`): the same traversal
with the bf16x3 leaf product c.r ~ c_hi.r_hi + c_hi.r_lo + c_lo.r_hi (the
lo.lo term dropped) as one tensor-core product, slack on the edge tests, on
t and on the prune; closest hit only, never latched. `walk_twin` and
`walk_fast_twin` are their plain PyTorch versions: the same walk vectorised
over the lanes still walking, with the stack as an (n, DEPTH) tensor. `walk`
and `walk_fast` pick by the tensors' device: CUDA launches the kernel (or
raises), CPU runs the twin. Each keeps a plain integer launch count
(`walk_cuda.launches`, ...) so a run can show which one served it. The exact
kernel and its twin agree to rounding; the fast kernel's tensor core sums in
its own order, so it agrees with its twin statistically.

`walk_cuda_v1` and `walk_fast_cuda_v1` launch the one-thread-per-ray forms
(csrc/bvh8_walk_v1.cu, csrc/bvh8_walk_fast_v1.cu), kept only so that a run
can measure old and new on one card: the intersector benchmark and
chip_smoke.py launch them, no query does. The exact v1 shares the slot test
and the node visits of the new kernel, so the two agree bit for bit; the fast
v1 adds in the twin's order and equals `walk_fast_twin` bit for bit.
`order_key`, `coop_leaf_step`, `coop_merge`, `ray_words` and
`mma_leaf_products` emulate the new kernels' leaf-step bookkeeping and
tensor-core operands in plain torch for the CPU tests; nothing else uses them.

The public queries keep the JAX package's semantics: `intersect` is
intersect_bvh_pallas8, fast=True by default as there: the fast walk's winner
is validated by an exact f32 Moller-Trumbore with ray_tri's accept rule, and
the lanes whose winner was a phantom (a slot accepted only through the
slack, which may have pruned a real hit behind it) are walked again by the
exact kernel, in one launch over all lanes with tfar = 0 on every lane that
needs no repair. (Gathering the repair lanes instead would need their count
on the host, one sync per query, to save a launch whose dead lanes return at
once; the all-lanes launch keeps the query free of syncs.) `occluded` is
occluded_bvh_pallas8 and `intersect_mixed` latches the lanes flagged in
`latch` (the rule of intersect_bvh_gather_mixed); both stay on the exact
kernel, since a bf16 phantom would occlude falsely.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..accel.bvh import BvhArrays, build_bvh_best
from . import _build
from .intersect import INF, Hit

LEAF = 128
DEPTH = 160  # per-ray stack bound: ~ (binary depth / 3) * 8 pushes
_TWIN_LEAF_CHUNK = 16384  # leaf lanes evaluated per twin step (bounds memory)


# ---------------------------------------------------------------------------
# host half
# ---------------------------------------------------------------------------

def _woop_planes(v0, e1, e2):
    """Per-triangle affine plane functionals (t/u/v barycentric planes).
    Degenerate triangles get all-zero planes -> t = -0/0 = nan -> no hit."""
    n = np.cross(e1, e2)
    n2 = np.einsum("ij,ij->i", n, n)
    ok = n2 > 1e-30
    n2s = np.where(ok, n2, 1.0)
    U = np.cross(e2, n) / n2s[:, None]
    V = np.cross(n, e1) / n2s[:, None]
    nc = -np.einsum("ij,ij->i", n, v0)
    uc = -np.einsum("ij,ij->i", U, v0)
    vc = -np.einsum("ij,ij->i", V, v0)
    N4 = np.concatenate([n, nc[:, None]], axis=1)
    U4 = np.concatenate([U, uc[:, None]], axis=1)
    V4 = np.concatenate([V, vc[:, None]], axis=1)
    z = ~ok
    N4[z] = 0.0
    U4[z] = 0.0
    V4[z] = 0.0
    return N4.astype(np.float32), U4.astype(np.float32), V4.astype(np.float32)


def _collapse8(bvh, leaf_ids):
    """Collapse the binary skip-BVH into 8-ary nodes (greedy largest-volume
    3-level expansion). Returns (boxes (M8*8, 8), kid (8, M8), order (8, M8))."""
    count = bvh.count
    skip = bvh.skip
    nmin, nmax = bvh.node_min, bvh.node_max
    area = np.prod(np.maximum(nmax - nmin, 0.0), axis=1)

    def children(b):
        left = b + 1
        return left, int(skip[left])

    nodes8 = []
    memo = {}

    def build8(b):
        if b in memo:
            return memo[b]
        id8 = len(nodes8)
        nodes8.append(None)
        memo[b] = id8
        if count[b] > 0:
            slots = [b]
        else:
            slots = list(children(b))
            while len(slots) < 8:
                inner = [s for s in slots if count[s] == 0]
                if not inner:
                    break
                s = max(inner, key=lambda x: area[x])
                slots.remove(s)
                slots.extend(children(s))
        nodes8[id8] = slots
        return id8

    build8(0)
    i = 0
    while i < len(nodes8):
        for s in list(nodes8[i]):
            if count[s] == 0:
                build8(s)
        i += 1

    m8 = len(nodes8)
    # the per-ray stack must hold 8 pushes per level of the 8-ary tree
    depth8 = np.zeros(m8, np.int32)
    for id8 in range(m8 - 1, -1, -1):
        kids8 = [memo[sq] for sq in nodes8[id8] if count[sq] == 0]
        depth8[id8] = 1 + max((int(depth8[kq]) for kq in kids8), default=0)
    if 8 * int(depth8[0]) > DEPTH:
        raise ValueError(
            f"BVH8 depth {int(depth8[0])} needs {8 * int(depth8[0])} stack slots "
            f"> DEPTH={DEPTH}")
    boxes = np.zeros((m8, 8, 8), np.float32)
    boxes[:, :, 0:3] = np.float32(3e38)  # absent: inverted box, never hits
    boxes[:, :, 3:6] = np.float32(-3e38)
    kid = np.full((8, m8), -1, np.int32)
    order = np.zeros((8, m8), np.int32)
    centers = 0.5 * (nmin + nmax)
    sgn = np.array(
        [[1 if o & 4 else -1, 1 if o & 2 else -1, 1 if o & 1 else -1] for o in range(8)],
        np.float32,
    )  # octant bit layout: x<<2 | y<<1 | z
    for id8, slots in enumerate(nodes8):
        cs = []
        for c, s in enumerate(slots):
            boxes[id8, c, 0:3] = nmin[s]
            boxes[id8, c, 3:6] = nmax[s]
            kid[c, id8] = -(int(leaf_ids[s]) + 2) if count[s] > 0 else memo[s]
            cs.append(centers[s])
        cs = np.asarray(cs, np.float32)
        for o in range(8):
            key = cs @ sgn[o]
            perm = list(np.argsort(key, kind="stable")) + list(range(len(slots), 8))
            packed = 0
            for k, c in enumerate(perm):
                packed |= int(c) << (3 * k)
            order[o, id8] = packed
    return boxes.reshape(m8 * 8, 8), kid, order


def tri_tree(v0, e1, e2, leaf_size: int = LEAF) -> BvhArrays:
    """The binary SAH tree over the triangles' bounds. The BVH8 pack, the
    binary pack (ops/bvh2.py) and the packet pack (ops/bvh.py) of a scene
    are all built from this one tree, as the JAX package's disk-cached
    builder makes them share one."""
    v0 = np.asarray(v0, np.float32)
    p1 = v0 + np.asarray(e1, np.float32)
    p2 = v0 + np.asarray(e2, np.float32)
    lo = np.minimum(np.minimum(v0, p1), p2)
    hi = np.maximum(np.maximum(v0, p1), p2)
    return build_bvh_best(lo, hi, leaf_size=leaf_size)


def build_bvh_pack8(v0, e1, e2, bvh: BvhArrays, leaf_size: int = LEAF) -> dict:
    """Numpy BVH8 pack in the JAX package's layout, from the triangles'
    tri_tree `bvh` (built with the same leaf_size):
    {"boxes" (M8*8, 8), "kid" (8, M8), "order" (8, M8),
     "planes" (n_leaves*8, 3*leaf), "prim_map" (n_leaves*leaf,)}."""
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)

    leaf_mask = bvh.count > 0
    leaf_ids = np.cumsum(leaf_mask) - 1
    n_leaves = int(leaf_mask.sum())

    N4, U4, V4 = _woop_planes(v0, e1, e2)
    L = leaf_size
    planes = np.zeros((n_leaves * 8, 3 * L), np.float32)
    prim_map = np.full((n_leaves * L,), -1, np.int32)
    for n in np.where(leaf_mask)[0]:
        s = int(leaf_ids[n])
        f, c = int(bvh.first[n]), int(bvh.count[n])
        gid = bvh.prim_order[f: f + c]
        r = s * 8
        planes[r: r + 4, 0:c] = N4[gid].T
        planes[r: r + 4, L: L + c] = U4[gid].T
        planes[r: r + 4, 2 * L: 2 * L + c] = V4[gid].T
        prim_map[s * L: s * L + c] = gid

    boxes, kid, order = _collapse8(bvh, leaf_ids)
    return {"boxes": boxes, "kid": kid, "order": order, "planes": planes,
            "prim_map": prim_map}


@dataclass
class Bvh8Pack:
    """The BVH8 pack on one device: the JAX layouts (boxes, kid, order,
    planes, prim_map) plus the walk's own layouts, made once per scene."""

    boxes: torch.Tensor  # (M8*8, 8) f32 child boxes [min3 | max3 | 0 0]
    kid: torch.Tensor  # (8, M8) i32 child code (>=0 node, <=-2 leaf, -1 none)
    order: torch.Tensor  # (8, M8) i32 per-octant push order, 3 bits/slot
    planes: torch.Tensor  # (n_leaves*8, 3*leaf) f32 Woop plane slabs
    prim_map: torch.Tensor  # (n_leaves*leaf,) i32 slot -> scene tri id
    kid_t: torch.Tensor  # (M8, 8) i32, node-major
    order_t: torch.Tensor  # (M8, 8) i32, [node, octant]
    tri_planes: torch.Tensor  # (n_leaves, leaf, 12) f32: N4 | U4 | V4 per slot
    tri_planes_hi: torch.Tensor  # (n_leaves, leaf, 12) bf16: bf16(tri_planes)
    tri_planes_lo: torch.Tensor  # (n_leaves, leaf, 12) bf16: bf16(planes - f32(hi))
    leaf: int = LEAF

    @staticmethod
    def from_arrays(arrays: dict, device) -> "Bvh8Pack":
        """From the JAX pack's arrays as numpy. `planes_hi` / `planes_lo`,
        where given, are the JAX pack's bf16 tables in the layout of
        `planes`, carried as their bit patterns: uint16 arrays, or any
        two-byte type that is viewed as such (numpy itself has no bf16);
        without them the split is made here, by the same rounding."""
        a = {k: np.asarray(arrays[k]) for k in ("boxes", "kid", "order", "planes", "prim_map")}
        L = a["planes"].shape[1] // 3
        n_leaves = a["planes"].shape[0] // 8

        def per_slot(planes):
            return np.ascontiguousarray(planes.reshape(n_leaves, 8, 3, L)[:, :4]
                                        .transpose(0, 3, 2, 1).reshape(n_leaves, L, 12))

        def t(x, dtype):
            return torch.as_tensor(np.array(x, dtype, order="C"), device=device)

        tri = per_slot(a["planes"])
        if arrays.get("planes_hi") is not None:
            hi, lo = (torch.as_tensor(per_slot(np.asarray(arrays[k]).view(np.uint16)).view(np.int16),
                                      device=device).view(torch.bfloat16)
                      for k in ("planes_hi", "planes_lo"))
        else:
            hi, lo = (x.to(device) for x in split_bf16(torch.as_tensor(tri)))

        return Bvh8Pack(
            boxes=t(a["boxes"], np.float32), kid=t(a["kid"], np.int32),
            order=t(a["order"], np.int32), planes=t(a["planes"], np.float32),
            prim_map=t(a["prim_map"], np.int32),
            kid_t=t(a["kid"].T, np.int32), order_t=t(a["order"].T, np.int32),
            tri_planes=t(tri, np.float32), tri_planes_hi=hi, tri_planes_lo=lo, leaf=L,
        )


def split_bf16(x):
    """(hi, lo) bf16 halves of an f32 tensor: hi = bf16(x), lo = bf16(x -
    f32(hi)), both round to nearest even (build_bvh_pack8's planes_hi /
    planes_lo; `_leaf_tuv_bf16x3` splits the rays the same way)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# kernel half
# ---------------------------------------------------------------------------

def box_hit(b, o, inv, tnear, lim):
    """Slab test with `_box_test`'s rule (pallas_bvh2.py):
    (tmin <= tmax) & (tmax > tnear) & (tmin < lim), for boxes b[..., min3 |
    max3 ...] against rays (o, inv = 1 / d, tnear, lim) broadcast to them.
    fmin / fmax drop NaN, as CUDA's fminf / fmaxf do in the kernels."""
    t0 = (b[..., 0:3] - o) * inv
    t1 = (b[..., 3:6] - o) * inv
    lo, hi = torch.fmin(t0, t1), torch.fmax(t0, t1)
    tmin = torch.fmax(torch.fmax(lo[..., 0], lo[..., 1]), lo[..., 2])
    tmax = torch.fmin(torch.fmin(hi[..., 0], hi[..., 1]), hi[..., 2])
    return (tmin <= tmax) & (tmax > tnear) & (tmin < lim)


def plane_leaf(P, o, d, tnear, lim):
    """k rays against their leaves' plane slabs P (k, L, 12) = N4 | U4 | V4
    per slot (`_leaf_tuv` and its accept rule): (t (k, L), hit (k, L)).
    All-zero (empty, degenerate) slots give t = NaN and never hit."""
    ox, oy, oz = (o[:, j:j + 1] for j in range(3))
    dx, dy, dz = (d[:, j:j + 1] for j in range(3))
    ao = P[..., 0] * ox + P[..., 1] * oy + P[..., 2] * oz + P[..., 3]
    ad = P[..., 0] * dx + P[..., 1] * dy + P[..., 2] * dz
    t = -ao / ad
    u = ((P[..., 4] * ox + P[..., 5] * oy + P[..., 6] * oz + P[..., 7])
         + t * (P[..., 4] * dx + P[..., 5] * dy + P[..., 6] * dz))
    w = ((P[..., 8] * ox + P[..., 9] * oy + P[..., 10] * oz + P[..., 11])
         + t * (P[..., 8] * dx + P[..., 9] * dy + P[..., 10] * dz))
    h = ((u >= 0.0) & (w >= 0.0) & (u + w <= 1.0)
         & (t > tnear[:, None]) & (t < lim[:, None]))
    return t, h


# slack of the fast walk (pallas_bvh8.py:211-214, 233-256), each the f32
# value the kernel's literal has (0.02f, 1.02f, 0.999f, 1.001f)
E_EDGE = float(np.float32(2e-2))
ONE_PLUS_E_EDGE = float(np.float32(1.0 + 2e-2))
ONE_MINUS_E_T = float(np.float32(1.0 - 1e-3))
ONE_PLUS_E_T = float(np.float32(1.0 + 1e-3))


def _dot3(ch, cl, rh, rl, affine):
    """bf16x3 product of plane rows (k, L, 4), given as f32 values of their
    bf16 halves (ch, cl), with the ray vectors r = [x y z w], w = 1 if
    affine else 0, given as the halves (rh, rl) (k, 3) of x y z:
    (ch.rh + ch.rl) + cl.rh, each pass summed x, y, z, w in that order, the
    cl.rl pass left out (`_leaf_tuv_bf16x3`). Every product of two bf16
    values is exact in f32, so only the order of the additions matters; the
    kernel keeps this one."""
    def dot(c, r):
        return c[..., 0] * r[:, 0:1] + c[..., 1] * r[:, 1:2] + c[..., 2] * r[:, 2:3]

    a, b, c = dot(ch, rh), dot(ch, rl), dot(cl, rh)
    if affine:  # w: r_hi = 1, r_lo = 0
        a = a + ch[..., 3]
        c = c + cl[..., 3]
    return (a + b) + c


def plane_leaf_fast(Ph, Pl, oh, ol, dh, dl, tnear_s, lim_s):
    """The fast leaf: k rays against their leaves' bf16 plane halves Ph, Pl
    (k, L, 12), the rays' origins and directions as bf16 halves (oh, ol, dh,
    dl) in f32, with the slack accept rule (pallas_bvh8.py:252-256) against
    tnear_s = tnear (1 - e_t) and lim_s = min(tfar, best) (1 + e_t):
    (t (k, L), hit (k, L)). All-zero slots give t = NaN and never hit."""
    Ph, Pl = Ph.float(), Pl.float()
    ao = [_dot3(Ph[..., j:j + 4], Pl[..., j:j + 4], oh, ol, True) for j in (0, 4, 8)]
    ad = [_dot3(Ph[..., j:j + 4], Pl[..., j:j + 4], dh, dl, False) for j in (0, 4, 8)]
    t = -ao[0] / ad[0]
    u = ao[1] + t * ad[1]
    w = ao[2] + t * ad[2]
    h = ((u >= -E_EDGE) & (w >= -E_EDGE) & (u + w <= ONE_PLUS_E_EDGE)
         & (t > tnear_s[:, None]) & (t < lim_s[:, None]))
    return t, h


def safe_inv(d):
    """1 / d with d == 0 read as 1e-30, as every walk does."""
    return 1.0 / torch.where(d == 0.0, 1e-30, d)


def _latch_mode(latch):
    """(mode, per-lane tensor): 0 = none latched, 1 = all, 2 = per lane."""
    if latch is None:
        return 0, None
    if latch is True:
        return 1, None
    return 2, latch


def _walk_plain(pack: Bvh8Pack, o, d, tnear, tfar, latch, fast):
    """The BVH8 walk in plain PyTorch with the kernels' exact per-ray
    semantics: fast=False is bvh8_walk.cu, fast=True bvh8_walk_fast.cu.
    Returns (t, local slot, {"box": child-box tests, "tri": leaf slot tests})."""
    n = o.shape[0]
    dev = o.device
    mode, lane_latch = _latch_mode(latch)
    if mode == 0:
        latched = torch.zeros(n, dtype=torch.bool, device=dev)
    elif mode == 1:
        latched = torch.ones(n, dtype=torch.bool, device=dev)
    else:
        latched = lane_latch.to(torch.bool)
    tfar = torch.clamp(tfar, max=INF)
    inv = safe_inv(d)
    octant = (((d[:, 0] >= 0).long() << 2) | ((d[:, 1] >= 0).long() << 1)
              | (d[:, 2] >= 0).long())
    best = torch.full((n,), INF, dtype=torch.float32, device=dev)
    local = torch.full((n,), -1, dtype=torch.int64, device=dev)
    stack = torch.zeros((n, DEPTH), dtype=torch.int32, device=dev)  # root = node 0
    sp = (tnear < tfar).long()  # dead lanes start with an empty stack
    push_k = torch.arange(7, -1, -1, device=dev) * 3  # slot k = 7 pushed first
    L = pack.leaf
    if fast:
        (oh, ol), (dh, dl) = ([h.float() for h in split_bf16(x)] for x in (o, d))
        tnear_s = tnear * ONE_MINUS_E_T
    boxes = slots = 0
    while True:
        act = torch.nonzero(sp > 0).squeeze(1)
        if act.numel() == 0:
            break
        top = sp[act] - 1
        v = stack[act, top].long()
        sp[act] = top
        is_inner = v >= 0

        ia = act[is_inner]
        if ia.numel():
            node = v[is_inner]
            b = pack.boxes.view(-1, 8, 8)[node]  # (k, 8, 8)
            # the fast walk's best may be an underestimate: prune with slack
            prune = best[ia] * ONE_PLUS_E_T if fast else best[ia]
            lim = torch.minimum(tfar[ia], prune)[:, None]
            hit = box_hit(b, o[ia][:, None, :], inv[ia][:, None, :], tnear[ia][:, None],
                          lim)  # (k, 8) by slot
            perm = pack.order_t[node, octant[ia]].long()
            cs = (perm[:, None] >> push_k[None, :]) & 7  # slot pushed at step j
            kv = pack.kid_t[node[:, None], cs]
            push = hit.gather(1, cs) & (kv != -1)
            pos = sp[ia][:, None] + torch.cumsum(push.long(), 1) - 1
            rows = ia[:, None].expand_as(pos)
            stack[rows[push], pos[push]] = kv[push]
            sp[ia] += push.sum(1)

        la = act[~is_inner]
        blk_all = -(v[~is_inner] + 2)
        boxes += ia.numel() * 8
        slots += la.numel() * L
        for c0 in range(0, la.numel(), _TWIN_LEAF_CHUNK):
            lanes = la[c0:c0 + _TWIN_LEAF_CHUNK]
            blk = blk_all[c0:c0 + _TWIN_LEAF_CHUNK]
            cur = best[lanes]
            lim = torch.minimum(tfar[lanes], cur)
            if fast:
                t, h = plane_leaf_fast(pack.tri_planes_hi[blk], pack.tri_planes_lo[blk],
                                       oh[lanes], ol[lanes], dh[lanes], dl[lanes],
                                       tnear_s[lanes], lim * ONE_PLUS_E_T)
            else:
                t, h = plane_leaf(pack.tri_planes[blk], o[lanes], d[lanes], tnear[lanes], lim)
            best[lanes], local[lanes], done = leaf_merge(t, h, latched[lanes], cur,
                                                         local[lanes], blk * L)
            sp[lanes] = torch.where(done, 0, sp[lanes])
    return best, local, {"box": boxes, "tri": slots}


def leaf_merge(t, h, latched, best, local, base):
    """The walks' rule for one leaf visit of k rays: their slot results t, h
    (k, L), latch flags, current best and local slot, and the leaf's first
    slot id `base` -> (best, local, done). Within the leaf the lowest slot
    among the least t wins; a latched ray takes its lowest hitting slot,
    best = 0, and is done; a leaf's winner replaces the best only when
    strictly nearer (always so in the exact walk; the fast accept rule has
    slack)."""
    tb, slot = torch.min(torch.where(h, t, INF), dim=1)
    first = torch.argmax(h.to(torch.uint8), dim=1)
    any_h = h.any(dim=1)
    take_latch = latched & any_h
    take_best = ~latched & any_h & (tb < best)
    return (torch.where(take_latch, 0.0, torch.where(take_best, tb, best)),
            torch.where(take_latch, base + first, torch.where(take_best, base + slot, local)),
            take_latch)


def walk_twin(pack: Bvh8Pack, o, d, tnear, tfar, latch=None):
    """Plain PyTorch version of the exact walk (csrc/bvh8_walk.cu). Returns
    (t (n,) f32, local slot (n,) i64; -1 = miss). `walk_twin.work` records
    the call's child-box tests ("box") and leaf slot tests ("tri")."""
    walk_twin.launches += 1
    t, local, walk_twin.work = _walk_plain(pack, o, d, tnear, tfar, latch, fast=False)
    return t, local


walk_twin.launches = 0
walk_twin.work = {"box": 0, "tri": 0}


def walk_fast_twin(pack: Bvh8Pack, o, d, tnear, tfar):
    """Plain PyTorch version of the fast walk (csrc/bvh8_walk_fast.cu): the
    raw winner, a phantom included, and its bf16x3 t. `.work` as walk_twin."""
    walk_fast_twin.launches += 1
    t, local, walk_fast_twin.work = _walk_plain(pack, o, d, tnear, tfar, None, fast=True)
    return t, local


walk_fast_twin.launches = 0
walk_fast_twin.work = {"box": 0, "tri": 0}


def check_rays(o, d, tnear, tfar):
    """Raise unless the rays are contiguous CUDA f32 (n, 3), (n, 3), (n,), (n,)."""
    n = o.shape[0]
    _build.check_cuda("o", o, torch.float32, (n, 3))
    _build.check_cuda("d", d, torch.float32, (n, 3), like=o)
    _build.check_cuda("tnear", tnear, torch.float32, (n,), like=o)
    _build.check_cuda("tfar", tfar, torch.float32, (n,), like=o)


def check_leaf(pack: Bvh8Pack):
    """Raise unless the pack's leaves are LEAF wide: the warp-cooperative
    kernels unroll their leaf loops over exactly that many slots."""
    if pack.leaf != LEAF:
        raise ValueError(f"the BVH8 kernels take leaves of {LEAF} slots; the pack's are "
                         f"{pack.leaf} wide")


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str, fast: bool, v1: bool):
    """The C entry point `name` of csrc/<name>.cu, typed: the rays (o, d,
    tnear, tfar), the exact walk's latch and its mode, the pack (boxes, kid,
    order, then planes, or planes_hi and planes_lo), n, a v1 kernel's leaf
    width, out_t, out_local and the stream."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = getattr(_build.load_library(name), name)
    fn.restype = i
    fn.argtypes = ([p] * 4 + ([] if fast else [p, i]) + [p] * (5 if fast else 4) + [i]
                   + ([i] if v1 else []) + [p] * 3)
    return fn


def _launch(name, pack: Bvh8Pack, o, d, tnear, tfar, *, fast, v1, latch=None):
    """Check the inputs and launch csrc/<name>.cu on the current stream (the
    fast walk's or the exact walk's arguments; a v1 kernel takes the leaf
    width, the new ones only 128): (t (n,) f32, local slot (n,) i64; -1 = miss)."""
    n = o.shape[0]
    if not v1:
        check_leaf(pack)
    check_rays(o, d, tnear, tfar)
    if fast:
        tables = (("tri_planes_hi", torch.bfloat16), ("tri_planes_lo", torch.bfloat16))
        extra = []
    else:
        tables = (("tri_planes", torch.float32),)
        mode, lane_latch = _latch_mode(latch)
        if mode == 2:
            lane_latch = lane_latch.to(torch.uint8).contiguous()
            _build.check_cuda("latch", lane_latch, torch.uint8, (n,), like=o)
        extra = [_build.ptr(lane_latch), mode]
    for name_t, dtype in (("boxes", torch.float32), ("kid_t", torch.int32),
                          ("order_t", torch.int32)) + tables:
        _build.check_cuda(f"pack.{name_t}", getattr(pack, name_t), dtype, like=o)
    out_t = torch.empty((n,), dtype=torch.float32, device=o.device)
    out_local = torch.empty((n,), dtype=torch.int32, device=o.device)
    p = _build.ptr
    args = ([p(o), p(d), p(tnear), p(tfar)] + extra + [p(pack.boxes), p(pack.kid_t),
            p(pack.order_t)] + [p(getattr(pack, t)) for t, _ in tables] + [n]
            + ([pack.leaf] if v1 else []) + [p(out_t), p(out_local), _build.stream_of(o)])
    err = _kernel_fn(name, fast, v1)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out_t, out_local.long()


def walk_cuda(pack: Bvh8Pack, o, d, tnear, tfar, latch=None):
    """Launch the CUDA BVH8 walk (csrc/bvh8_walk.cu) on the current stream.
    Returns (t (n,) f32, local slot (n,) i64; -1 = miss)."""
    out = _launch("bvh8_walk", pack, o, d, tnear, tfar, fast=False, v1=False, latch=latch)
    walk_cuda.launches += 1
    return out


walk_cuda.launches = 0


def walk_cuda_v1(pack: Bvh8Pack, o, d, tnear, tfar, latch=None):
    """Launch the one-thread-per-ray BVH8 walk (csrc/bvh8_walk_v1.cu), kept
    for comparison: the result of walk_cuda, bit for bit."""
    out = _launch("bvh8_walk_v1", pack, o, d, tnear, tfar, fast=False, v1=True, latch=latch)
    walk_cuda_v1.launches += 1
    return out


walk_cuda_v1.launches = 0


def walk(pack: Bvh8Pack, o, d, tnear, tfar, latch=None):
    """BVH8 walk on the rays' device: CUDA -> the kernel, CPU -> the twin."""
    if o.is_cuda:
        return walk_cuda(pack, o, d, tnear, tfar, latch)
    if o.device.type == "cpu":
        return walk_twin(pack, o, d, tnear, tfar, latch)
    raise ValueError(f"no BVH8 walk for device {o.device}")


def walk_fast_cuda(pack: Bvh8Pack, o, d, tnear, tfar):
    """Launch the fast CUDA BVH8 walk (csrc/bvh8_walk_fast.cu) on the current
    stream. Returns (t (n,) f32, local slot (n,) i64; -1 = miss): the raw
    winner, to be validated by the caller."""
    out = _launch("bvh8_walk_fast", pack, o, d, tnear, tfar, fast=True, v1=False)
    walk_fast_cuda.launches += 1
    return out


walk_fast_cuda.launches = 0


def walk_fast_cuda_v1(pack: Bvh8Pack, o, d, tnear, tfar):
    """Launch the one-thread-per-ray fast walk (csrc/bvh8_walk_fast_v1.cu),
    kept for comparison: the result of walk_fast_twin, bit for bit."""
    out = _launch("bvh8_walk_fast_v1", pack, o, d, tnear, tfar, fast=True, v1=True)
    walk_fast_cuda_v1.launches += 1
    return out


walk_fast_cuda_v1.launches = 0


def walk_fast(pack: Bvh8Pack, o, d, tnear, tfar):
    """Fast BVH8 walk on the rays' device: CUDA -> the kernel, CPU -> the twin."""
    if o.is_cuda:
        return walk_fast_cuda(pack, o, d, tnear, tfar)
    if o.device.type == "cpu":
        return walk_fast_twin(pack, o, d, tnear, tfar)
    raise ValueError(f"no BVH8 walk for device {o.device}")


# ---------------------------------------------------------------------------
# the new kernels' leaf step, emulated for the CPU tests
# ---------------------------------------------------------------------------

NONE_KEY = 0xFFFFFFFF  # "no slot" in the warp's minimum reductions
WARP = 32


def order_key(t):
    """The kernels' unsigned 32-bit key of f32 t, as int64: ordered as t is
    by < (-0 read as +0), so a minimum over keys is a minimum over t."""
    b = (t + 0.0).view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(b >= 0x80000000, b ^ 0xFFFFFFFF, b | 0x80000000)


def coop_leaf_step(t, h, latched):
    """The exact kernel's leaf step (bvh8_common.cuh `ExactLeaf::test`) on
    k member rays' slot results t, h (k, LEAF): lane l holds slots l, l+32,
    l+64, l+96 and keeps its lowest hit with that hit's t, and the lowest
    slot among its least t; two minima over the warp take the least key,
    then the least slot with that key (the lowest hit under the latch); the
    winner's t comes from the lane that holds it (a latched ray's: the t of
    its lowest hit slot). Returns (t (k,), slot (k,), -1 = none)."""
    k = t.shape[0]
    tl = t.reshape(k, LEAF // WARP, WARP)  # [ray, j, lane] = slot lane + 32 j
    hl = h.reshape(k, LEAF // WARP, WARP)
    slot = (torch.arange(LEAF).reshape(LEAF // WARP, WARP)).expand(k, -1, -1)
    tb = torch.full((k, WARP), INF)
    tfirst = torch.full((k, WARP), INF)
    sb = torch.full((k, WARP), NONE_KEY, dtype=torch.int64)
    first = torch.full((k, WARP), NONE_KEY, dtype=torch.int64)
    for j in range(LEAF // WARP):  # the lane's loop, in slot order
        hit = hl[:, j]
        new_first = hit & (first == NONE_KEY)
        first = torch.where(new_first, slot[:, j], first)
        tfirst = torch.where(new_first, tl[:, j], tfirst)
        take = hit & (tl[:, j] < tb)
        tb = torch.where(take, tl[:, j], tb)
        sb = torch.where(take, slot[:, j], sb)
    key = torch.where(sb != NONE_KEY, order_key(tb), NONE_KEY)
    kmin = key.min(dim=1, keepdim=True).values
    win_c = torch.where((sb != NONE_KEY) & (key == kmin), sb, NONE_KEY).min(dim=1).values
    win_l = first.min(dim=1).values
    win = torch.where(latched, win_l, win_c)
    t_c = tb.gather(1, (win_c & (WARP - 1))[:, None]).squeeze(1)
    t_l = tfirst.gather(1, (win_l & (WARP - 1))[:, None]).squeeze(1)
    t_win = torch.where(latched, t_l, t_c)
    return torch.where(win == NONE_KEY, INF, t_win), torch.where(win == NONE_KEY, -1, win)


def coop_merge(t_win, slot, latched, best, local, base, fast):
    """A member's write-back after the leaf step: a latched ray with a hit
    takes the slot, best = 0, and is done; otherwise a hit replaces the best
    (the exact kernel: every accepted t is below the ray's limit, so always;
    the fast kernel only when strictly nearer). -> (best, local, done)."""
    hit = slot >= 0
    take_latch = latched & hit
    take = ~latched & hit & ((t_win < best) if fast else torch.ones_like(hit))
    return (torch.where(take_latch, 0.0, torch.where(take, t_win, best)),
            torch.where(take_latch | take, base + slot, local), take_latch)


def _bf16_bits(x):
    return x.contiguous().view(torch.int16).long() & 0xFFFF


def _words(x16):
    """(..., 2m) bf16 -> (..., m) int64 words, element 2i in the low half."""
    b = _bf16_bits(x16)
    return b[..., 0::2] | (b[..., 1::2] << 16)


def ray_words(o, d):
    """Each ray's B-column words, as the fast kernel writes them to shared
    memory: (k, 8) int64 = [o_hi.xy, o_hi.z 1, o_lo.xy, o_lo.z 0, d_hi.xy,
    d_hi.z 0, d_lo.xy, d_lo.z 0] (bf16 pairs, the first in the low half)."""
    k = o.shape[0]
    one, zero = torch.ones(k, 1), torch.zeros(k, 1)
    (oh, ol), (dh, dl) = split_bf16(o), split_bf16(d)
    vecs = [torch.cat([oh.float(), one], 1), torch.cat([ol.float(), zero], 1),
            torch.cat([dh.float(), zero], 1), torch.cat([dl.float(), zero], 1)]
    return torch.cat([_words(v.to(torch.bfloat16)) for v in vecs], 1)


def _unpack(w):
    """int64 words -> (..., 2) f32 values of their two bf16 halves."""
    b = torch.stack([w & 0xFFFF, w >> 16], -1) << 16
    return torch.where(b >= 2 ** 31, b - 2 ** 32, b).to(torch.int32).view(torch.float32)


def mma_leaf_products(ph, pl, words):
    """The fast kernel's tensor-core leaf products for one leaf and a group
    of up to 4 rays, emulated from its fragment indexing: ph, pl (LEAF, 12)
    bf16 tables, words (k <= 4, 8) from ray_words. Lane (g, q) loads its A
    words from the tables and its B words from the rays' words as
    bvh8_walk_fast.cu does, the fragments are placed by the PTX m16n8k16
    layout, the 16 x 16 by 16 x 8 product is taken in f64 and rounded once,
    and the accumulators are read back as the kernel reads them.
    Returns (ao, ad), each (k, 3, LEAF): rows N, U, V of every slot against
    [o, 1] and [d, 0]."""
    H, L = _words(ph).reshape(-1), _words(pl).reshape(-1)
    k = words.shape[0]
    lane = torch.arange(WARP)
    g, q = lane // 4, lane % 4
    src = torch.where(g // 2 < k, g // 2, 0)
    b0 = torch.where(g // 2 < k, words[src, (g % 2) * 4 + q], 0)
    b1 = torch.where(q < 2, b0, 0)
    B = torch.zeros(16, 8, dtype=torch.float64)
    B[2 * q[:, None] + torch.arange(2), g[:, None]] = _unpack(b0).double()
    B[8 + 2 * q[:, None] + torch.arange(2), g[:, None]] = _unpack(b1).double()
    ao = torch.zeros(k, 3, LEAF)
    ad = torch.zeros(k, 3, LEAF)
    pair = torch.arange(2)
    for sg in range(LEAF // 16):
        for c in range(3):
            wi = (sg * 16 + g) * 6 + 2 * c + (q & 1)
            a = [H[wi], H[wi + 48], torch.where(q < 2, L[wi], 0), torch.where(q < 2, L[wi + 48], 0)]
            A = torch.zeros(16, 16, dtype=torch.float64)
            for r, (row, col) in enumerate(((g, 2 * q), (g + 8, 2 * q), (g, 8 + 2 * q),
                                            (g + 8, 8 + 2 * q))):
                A[row[:, None], col[:, None] + pair] = _unpack(a[r]).double()
            C = (A @ B).float()  # [row, col]
            for hh in range(2):  # lane (g, q): slot 16 sg + 8 hh + g, ray q
                s, ray = sg * 16 + 8 * hh + g, q
                live = ray < k
                ao[ray[live], c, s[live]] = C[8 * hh + g[live], 2 * q[live]]
                ad[ray[live], c, s[live]] = C[8 * hh + g[live], 2 * q[live] + 1]
    return ao, ad


def _moller_trumbore(tris, o, d, prim):
    """Exact f32 Moller-Trumbore against triangle max(prim, 0) of each lane:
    raw (u, v, t, det), 0 where |det| <= 1e-12."""
    tri = torch.clamp(prim, min=0)
    a, ee1, ee2 = tris.v0[tri], tris.e1[tri], tris.e2[tri]
    p = torch.linalg.cross(d, ee2, dim=-1)
    det = torch.sum(ee1 * p, dim=-1)
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tv = o - a
    u = torch.sum(tv * p, dim=-1) * inv_det
    q = torch.linalg.cross(tv, ee1, dim=-1)
    v = torch.sum(d * q, dim=-1) * inv_det
    t = torch.sum(ee2 * q, dim=-1) * inv_det
    return u, v, t, det


def _clip01(ok, x):
    return torch.where(ok, torch.clamp(x, 0.0, 1.0), 0.0)


def _recompute_uv(tris, o, d, prim):
    """Exact f32 recomputation for the winning prim (pallas_bvh2.py
    _recompute_uv): clipped barycentrics of the winner, 0 for misses, and
    its t, INF for a miss or t <= 0."""
    u, v, t, _ = _moller_trumbore(tris, o, d, prim)
    ok = prim >= 0
    return _clip01(ok, u), _clip01(ok, v), torch.where(ok & (t > 0.0), t, INF)


def _exact_validate(tris, o, d, prim, tnear, tfar):
    """The winner held to ray_tri's accept rule in exact f32
    (pallas_bvh8.py _exact_validate): (u clipped, v clipped, t, ok)."""
    u, v, t, det = _moller_trumbore(tris, o, d, prim)
    ok = ((prim >= 0) & (torch.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t > tnear) & (t < tfar))
    return _clip01(ok, u), _clip01(ok, v), t, ok


def _prim_of(prim_map, local):
    return torch.where(
        local >= 0, prim_map[torch.clamp(local, 0, prim_map.shape[0] - 1)].long(), -1)


def hit_from_slots(prim_map, tris, o, d, t, local) -> Hit:
    """The Hit of an exact walk's (t, local slot): slot -> scene tri id
    through prim_map, u/v recomputed in exact f32, t = INF on a miss."""
    prim = _prim_of(prim_map, local)
    u, v, _ = _recompute_uv(tris, o, d, prim)
    return Hit(t=torch.where(prim >= 0, t, INF), prim=prim, u=u, v=v)


def intersect(pack: Bvh8Pack, tris, o, d, tnear, tfar, fast: bool = True,
              walks=(walk_fast, walk)) -> Hit:
    """Closest hit (intersect_bvh_pallas8); prim = scene tri id. fast=True:
    the bf16x3 walk's winner validated in exact f32, the phantom lanes walked
    again by the exact walk in one launch over all lanes (tfar = 0 where no
    repair is needed), the two merged as pallas_bvh8.py:560-615 merges them
    (module docstring). `walks` is the (fast walk, exact walk) pair: by
    default the two that pick kernel or twin by device; the benchmark passes
    the kernels or the twins themselves."""
    walk_fast_fn, walk_fn = walks
    if not fast:
        t, local = walk_fn(pack, o, d, tnear, tfar)
        return hit_from_slots(pack.prim_map, tris, o, d, t, local)
    _, local = walk_fast_fn(pack, o, d, tnear, tfar)
    prim = _prim_of(pack.prim_map, local)
    u, v, t_exact, ok = _exact_validate(tris, o, d, prim, tnear, tfar)
    need = (prim >= 0) & ~ok
    _, local_r = walk_fn(pack, o, d, tnear, torch.where(need, tfar, 0.0))
    prim_r = torch.where(need, _prim_of(pack.prim_map, local_r), -1)
    u_r, v_r, t_r = _recompute_uv(tris, o, d, prim_r)
    return Hit(t=torch.where(ok, t_exact, torch.where(prim_r >= 0, t_r, INF)),
               prim=torch.where(ok, prim, prim_r),
               u=torch.where(ok, u, u_r), v=torch.where(ok, v, v_r))


def intersect_mixed(pack: Bvh8Pack, tris, o, d, tnear, tfar, latch) -> Hit:
    """ONE walk for a mixed wavefront: lanes with latch=True stop at their
    first hit (only prim >= 0 is meaningful), the rest run closest-hit."""
    t, local = walk(pack, o, d, tnear, tfar, latch)
    return hit_from_slots(pack.prim_map, tris, o, d, t, local)


def occluded(pack: Bvh8Pack, o, d, tnear, tfar):
    """Any-hit query -> bool per ray (occluded_bvh_pallas8)."""
    _, local = walk(pack, o, d, tnear, tfar, True)
    return local >= 0
