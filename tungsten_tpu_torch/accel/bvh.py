"""Host-side binned-SAH BVH build producing a flat, skip-pointer layout.

Numpy copy of tungsten_tpu/accel/bvh.py: the same build, so the tree (and
with it the triangle permutation and the BVH8 pack) is identical to the JAX
package's. It loads the same native/libtungsten_native.so by path when it has
been built (make -C native) and builds in numpy otherwise. Unlike the
JAX package it keeps no disk cache: the port writes nothing outside its
checkout.

Nodes are stored in DFS preorder so that

    hit inner node  -> next = i + 1        (first child is adjacent)
    leaf or miss    -> next = skip[i]      (skips the whole subtree)
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

LEAF_SIZE = 4
N_BINS = 16


@dataclass
class BvhArrays:
    node_min: np.ndarray  # (M, 3) f32
    node_max: np.ndarray  # (M, 3) f32
    first: np.ndarray  # (M,) i32  leaf: first prim; inner: 0
    count: np.ndarray  # (M,) i32  leaf: prim count; inner: 0
    skip: np.ndarray  # (M,) i32  next node when missed / after leaf
    prim_order: np.ndarray  # (T,) i32  permutation old->new position: prims[prim_order]


class _Node:
    __slots__ = ("bmin", "bmax", "start", "count", "left", "right")

    def __init__(self, bmin, bmax, start, count):
        self.bmin, self.bmax = bmin, bmax
        self.start, self.count = start, count
        self.left = self.right = None


def _surface(bmin, bmax):
    d = np.maximum(bmax - bmin, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


def build_bvh(bb_min: np.ndarray, bb_max: np.ndarray, leaf_size: int = LEAF_SIZE) -> BvhArrays:
    """bb_min/bb_max: (T, 3) per-primitive bounds. Returns flat arrays."""
    n = len(bb_min)
    if n == 0:
        return BvhArrays(
            node_min=np.zeros((1, 3), np.float32),
            node_max=np.full((1, 3), -1.0, np.float32),
            first=np.zeros(1, np.int32),
            count=np.zeros(1, np.int32),
            skip=np.ones(1, np.int32),
            prim_order=np.zeros(0, np.int32),
        )
    bb_min = np.asarray(bb_min, np.float32)
    bb_max = np.asarray(bb_max, np.float32)
    centroid = 0.5 * (bb_min + bb_max)
    order = np.arange(n, dtype=np.int64)

    root = _Node(bb_min.min(0), bb_max.max(0), 0, n)
    stack = [root]
    while stack:
        node = stack.pop()
        if node.count <= leaf_size:
            continue
        s, c = node.start, node.count
        idx = order[s : s + c]
        cent = centroid[idx]
        cmin = cent.min(0)
        cmax = cent.max(0)
        extent = cmax - cmin

        best = None  # (cost, axis, bin_split)
        for axis in range(3):
            if extent[axis] <= 0.0:
                continue
            rel = (cent[:, axis] - cmin[axis]) / extent[axis]
            bins = np.minimum((rel * N_BINS).astype(np.int32), N_BINS - 1)
            # per-bin bounds + counts
            counts = np.bincount(bins, minlength=N_BINS)
            bmin_b = np.full((N_BINS, 3), np.inf, np.float32)
            bmax_b = np.full((N_BINS, 3), -np.inf, np.float32)
            for k in range(3):
                np.minimum.at(bmin_b[:, k], bins, bb_min[idx][:, k])
                np.maximum.at(bmax_b[:, k], bins, bb_max[idx][:, k])
            # prefix/suffix sweep
            lmin = np.minimum.accumulate(bmin_b, 0)
            lmax = np.maximum.accumulate(bmax_b, 0)
            rmin = np.minimum.accumulate(bmin_b[::-1], 0)[::-1]
            rmax = np.maximum.accumulate(bmax_b[::-1], 0)[::-1]
            lcount = np.cumsum(counts)
            rcount = c - lcount
            # split after bin i (i in 0..N_BINS-2)
            la = _surface(lmin[:-1], lmax[:-1])
            ra = _surface(rmin[1:], rmax[1:])
            cost = la * lcount[:-1] + ra * rcount[:-1]
            cost = np.where((lcount[:-1] == 0) | (rcount[:-1] == 0), np.inf, cost)
            bi = int(np.argmin(cost))
            if np.isfinite(cost[bi]) and (best is None or cost[bi] < best[0]):
                best = (cost[bi], axis, bi, bins)

        if best is None:
            # all centroids coincide: median split on the largest bb axis
            axis = int(np.argmax(node.bmax - node.bmin))
            key = np.argsort(cent[:, axis], kind="stable")
            order[s : s + c] = idx[key]
            mid = c // 2
        else:
            _, axis, bi, bins = best
            left_mask = bins <= bi
            key = np.argsort(~left_mask, kind="stable")
            order[s : s + c] = idx[key]
            mid = int(left_mask.sum())
            if mid == 0 or mid == c:
                mid = c // 2

        li = order[s : s + mid]
        ri = order[s + mid : s + c]
        node.left = _Node(bb_min[li].min(0), bb_max[li].max(0), s, mid)
        node.right = _Node(bb_min[ri].min(0), bb_max[ri].max(0), s + mid, c - mid)
        stack.append(node.right)
        stack.append(node.left)

    # flatten in DFS preorder with skip pointers
    nodes = []
    _flatten_iter(root, nodes)

    m = len(nodes)
    node_min = np.zeros((m, 3), np.float32)
    node_max = np.zeros((m, 3), np.float32)
    first = np.zeros(m, np.int32)
    count = np.zeros(m, np.int32)
    skip = np.zeros(m, np.int32)

    # skip[i] = index just past i's subtree (preorder position + subtree size)
    sizes = {}
    _size_iter(root, sizes)
    for i, nd in enumerate(nodes):
        node_min[i] = nd.bmin
        node_max[i] = nd.bmax
        skip[i] = i + sizes[id(nd)]
        if nd.left is None:
            first[i] = nd.start
            count[i] = nd.count

    return BvhArrays(
        node_min=node_min,
        node_max=node_max,
        first=first,
        count=count,
        skip=skip,
        prim_order=order.astype(np.int32),
    )


def _flatten_iter(root, out):
    stack = [root]
    while stack:
        nd = stack.pop()
        out.append(nd)
        if nd.left is not None:
            stack.append(nd.right)
            stack.append(nd.left)


def _size_iter(root, sizes):
    # post-order iterative subtree-size computation
    stack = [(root, False)]
    while stack:
        nd, done = stack.pop()
        if nd.left is None:
            sizes[id(nd)] = 1
            continue
        if done:
            sizes[id(nd)] = 1 + sizes[id(nd.left)] + sizes[id(nd.right)]
        else:
            stack.append((nd, True))
            stack.append((nd.left, False))
            stack.append((nd.right, False))


def build_bvh_best(bb_min: np.ndarray, bb_max: np.ndarray, leaf_size: int = LEAF_SIZE) -> BvhArrays:
    """Native build when the library exists, numpy build otherwise (the JAX
    package's build_bvh_cached without its disk cache)."""
    bvh = build_bvh_native(bb_min, bb_max, leaf_size)
    if bvh is None:
        bvh = build_bvh(bb_min, bb_max, leaf_size)
    return bvh


# ---------------------------------------------------------------------------
# Native (C++) build: same flat skip-pointer contract, ~100x faster host
# build for large meshes. Falls back to the numpy build when the shared
# library hasn't been built (make -C native).
# ---------------------------------------------------------------------------

_NATIVE = None


def _load_native():
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE
    import ctypes

    lib_path = os.path.join(
        os.path.dirname(__file__), "..", "..", "native", "libtungsten_native.so"
    )
    try:
        lib = ctypes.CDLL(os.path.abspath(lib_path))
        fn = lib.tungsten_build_bvh
        fn.restype = ctypes.c_int32
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        _NATIVE = fn
    except OSError:
        _NATIVE = False
    return _NATIVE


def build_bvh_native(bb_min: np.ndarray, bb_max: np.ndarray, leaf_size: int = LEAF_SIZE):
    """C++ binned-SAH build (native/bvh_builder.cpp); None if unavailable."""
    import ctypes

    fn = _load_native()
    if not fn:
        return None
    n = len(bb_min)
    if n == 0:
        return build_bvh(bb_min, bb_max, leaf_size)
    bb_min = np.ascontiguousarray(bb_min, np.float32)
    bb_max = np.ascontiguousarray(bb_max, np.float32)
    cap = 2 * n
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    first = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    skip = np.empty(cap, np.int32)
    order = np.empty(n, np.int32)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    m = fn(
        ptr(bb_min, ctypes.c_float), ptr(bb_max, ctypes.c_float),
        np.int32(n), np.int32(leaf_size),
        ptr(node_min, ctypes.c_float), ptr(node_max, ctypes.c_float),
        ptr(first, ctypes.c_int32), ptr(count, ctypes.c_int32),
        ptr(skip, ctypes.c_int32), ptr(order, ctypes.c_int32),
    )
    return BvhArrays(
        node_min=node_min[:m].copy(),
        node_max=node_max[:m].copy(),
        first=first[:m].copy(),
        count=count[:m].copy(),
        skip=skip[:m].copy(),
        prim_order=order,
    )
