// The BVH8 walks' own pieces (bvh8_walk.cu, bvh8_walk_fast.cu, and the
// one-thread-per-ray kernel kept for comparison, bvh8_walk_v1.cu) and K4's
// (bvh2_walk.cu): the walk state, the node visit, the exact plane-form slot
// test, its warp-cooperative leaf step `ExactLeaf`, and `walk_warp`,
// the BVH8 walk on the traversal skeleton of walk_common.cuh (whose names
// this namespace takes in).

#pragma once

#include "walk_common.cuh"

namespace bvh8 {

using namespace walk;

constexpr int kDepth = 160;  // == DEPTH in ops/bvh8.py

// One ray's walk state, held by its lane.
struct Walker {
  float ox, oy, oz, dx, dy, dz;  // the ray
  float idx, idy, idz;           // 1 / d, d == 0 read as 1e-30
  float tnear, tfar, best;
  int octant, local, sp, parked;  // parked: a leaf waiting for the warp, or -1

  __device__ __forceinline__ void leave() { sp = 0; }
  // A latched member's hit: K3's latch reports best = 0 (not the hit's t,
  // which ExactLeaf then neither keeps nor shuffles) and leaves.
  static constexpr bool kLatchT = false;
  __device__ __forceinline__ void latch_hit(float) {
    best = 0.0f;
    leave();
  }
};

// The ray of lane i (or an empty walk for a lane past n or a dead ray).
__device__ __forceinline__ Walker make_walker(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tnear_in, const float* __restrict__ tfar_in, int i, int n) {
  Walker w{};
  w.best = kInf;
  w.local = -1;
  w.parked = -1;
  w.sp = 0;
  if (i >= n) return w;
  w.ox = o[3 * i], w.oy = o[3 * i + 1], w.oz = o[3 * i + 2];
  w.dx = d[3 * i], w.dy = d[3 * i + 1], w.dz = d[3 * i + 2];
  w.tnear = tnear_in[i];
  w.tfar = fminf(tfar_in[i], kInf);
  w.idx = 1.0f / (w.dx == 0.0f ? 1e-30f : w.dx);
  w.idy = 1.0f / (w.dy == 0.0f ? 1e-30f : w.dy);
  w.idz = 1.0f / (w.dz == 0.0f ? 1e-30f : w.dz);
  w.octant = ((w.dx >= 0.0f) << 2) | ((w.dy >= 0.0f) << 1) | (w.dz >= 0.0f);
  w.sp = w.tnear < w.tfar ? 1 : 0;  // dead lane: no work
  return w;
}

// Slab-test node v's 8 child boxes with K3's rule
// (tmin <= tmax) & (tmax > tnear) & (tmin < lim) and push the hit children
// far-to-near by the node's order word for the ray's octant (slot k = 7
// pushed first, so the nearest child pops first).
__device__ __forceinline__ void visit_node(
    const float* __restrict__ boxes, const int* __restrict__ kid,
    const int* __restrict__ order, int v, const Walker& w, float lim, int* stack, int& sp) {
  const float* b = boxes + v * 64;
  unsigned hitmask = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(b + 8 * c));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(b + 8 * c + 4));
    // lo = (minx, miny, minz, maxx), hi = (maxy, maxz, 0, 0)
    const float t0x = (lo.x - w.ox) * w.idx, t1x = (lo.w - w.ox) * w.idx;
    const float t0y = (lo.y - w.oy) * w.idy, t1y = (hi.x - w.oy) * w.idy;
    const float t0z = (lo.z - w.oz) * w.idz, t1z = (hi.y - w.oz) * w.idz;
    const float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
    if ((tmin <= tmax) && (tmax > w.tnear) && (tmin < lim)) hitmask |= 1u << c;
  }
  const int perm = __ldg(order + v * 8 + w.octant);
#pragma unroll
  for (int k = 7; k >= 0; --k) {
    const int c = (perm >> (3 * k)) & 7;
    const int kv = __ldg(kid + v * 8 + c);
    if (((hitmask >> c) & 1u) && kv != -1) stack[sp++] = kv;
  }
}

// The exact plane-form slot test, shared by bvh8_walk.cu and bvh8_walk_v1.cu
// so that both round alike: t = -(N.o + nc) / (N.d), u = (U.o + uc) + t (U.d),
// v likewise; accept u >= 0, v >= 0, u + v <= 1, t > tnear, t < lim. Every
// operation is a non-contracting intrinsic in the twin's order of additions
// (products fused into the running sum). All-zero slots give t = -0/0 = NaN,
// which no comparison accepts, so no file including this may be built with
// --use_fast_math.
__device__ __forceinline__ float dot_exact(float4 c, float x, float y, float z) {
  return __fmaf_rn(c.z, z, __fmaf_rn(c.y, y, __fmul_rn(c.x, x)));
}

__device__ __forceinline__ bool slot_exact(float4 N, float4 U, float4 V, float ox, float oy,
                                           float oz, float dx, float dy, float dz, float tnear,
                                           float lim, float& t) {
  const float ao = __fadd_rn(dot_exact(N, ox, oy, oz), N.w);
  const float ad = dot_exact(N, dx, dy, dz);
  t = __fdiv_rn(-ao, ad);
  const float u = __fadd_rn(__fadd_rn(dot_exact(U, ox, oy, oz), U.w),
                            __fmul_rn(t, dot_exact(U, dx, dy, dz)));
  const float v = __fadd_rn(__fadd_rn(dot_exact(V, ox, oy, oz), V.w),
                            __fmul_rn(t, dot_exact(V, dx, dy, dz)));
  return (u >= 0.0f) && (v >= 0.0f) && (__fadd_rn(u, v) <= 1.0f) && (t > tnear) && (t < lim);
}

constexpr int kLeafVec = kLeaf * 3;  // float4 rows of one plane leaf (N, U, V a slot)

// The exact plane-form leaf step of the warp-cooperative walks over the BVH8
// pack's planes (K3, bvh8_walk.cu; K4's three modes, bvh2_walk.cu): the
// leaf policy of `warp_leaf_rounds`. stage() copies a leaf into the warp's
// buffer (12 cp.async of 16 bytes a lane, coalesced). test() takes the
// members of a leaf one after the other, each by the whole warp: the
// member's ray is broadcast with __shfl_sync, lane l tests slots l, l+32,
// l+64 and l+96 with `slot_exact` from shared memory (conflict-free 16-byte
// reads) against the member's lim = min(tfar, best) at this step, keeping
// its lowest hit and the lowest slot among its least t; two redux.sync
// minima over (order_key(t), slot) give the serial loop's winner. A latched
// member takes its lowest hit slot and leaves its walk through the walker's
// latch_hit(t): K3's Walker writes best = 0; K4-any's BinWalker (kLatchT)
// writes best = t, the slot's own t, each lane keeping the t of its lowest
// hit and the member taking it from the winning slot's lane.
// The walker W supplies the ray (ox oy oz dx dy dz tnear), tfar, best, local,
// parked, kLatchT and latch_hit(t), which ends its walk.
struct ExactLeaf {
  const float4* planes;  // (n_leaves, 128, 3): N, U, V (x y z c)
  float4* smem;          // this warp's [2][kLeafVec]
  unsigned latched;      // ballot of the latched lanes
  int lane;

  __device__ __forceinline__ float prune(float best) const { return best; }

  __device__ __forceinline__ void stage(int leaf, int buf) {
    const float4* src = planes + static_cast<size_t>(leaf) * kLeafVec;
    float4* dst = smem + buf * kLeafVec;
#pragma unroll
    for (int k = 0; k < kLeafVec / 32; ++k) cp_async16(dst + lane + 32 * k, src + lane + 32 * k);
  }

  template <class W>
  __device__ __forceinline__ void test(W& w, unsigned members, int leaf, int buf) {
    const float4* p = smem + buf * kLeafVec;
    const float lim_own = fminf(w.tfar, w.best);
    while (members) {
      const int src = __ffs(members) - 1;
      members &= members - 1;
      const float ox = __shfl_sync(kFull, w.ox, src), oy = __shfl_sync(kFull, w.oy, src);
      const float oz = __shfl_sync(kFull, w.oz, src), dx = __shfl_sync(kFull, w.dx, src);
      const float dy = __shfl_sync(kFull, w.dy, src), dz = __shfl_sync(kFull, w.dz, src);
      const float tnear = __shfl_sync(kFull, w.tnear, src);
      const float lim = __shfl_sync(kFull, lim_own, src);
      const bool latch = (latched >> src) & 1u;
      float tb = kInf, tfirst = kInf;
      unsigned sb = kNone, first = kNone;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = lane + 32 * j;
        float t;
        if (slot_exact(p[3 * s], p[3 * s + 1], p[3 * s + 2], ox, oy, oz, dx, dy, dz, tnear, lim,
                       t)) {
          if (first == kNone) {
            first = s;
            tfirst = t;  // read only where W::kLatchT
          }
          if (t < tb) {
            tb = t;
            sb = s;
          }
        }
      }
      unsigned win;
      float t_win = 0.0f;
      if (latch) {
        win = __reduce_min_sync(kFull, first);
        if constexpr (W::kLatchT) t_win = __shfl_sync(kFull, tfirst, win & 31u);
      } else {
        win = warp_min_slot(tb, sb, t_win);
      }
      if (lane == src && win != kNone) {
        w.local = leaf * kLeaf + static_cast<int>(win);
        if (latch) {
          w.latch_hit(t_win);  // any-hit: leave the walk
        } else {
          w.best = t_win;
        }
      }
    }
    if (w.parked == leaf) w.parked = -1;
  }
};

// The BVH8 walk of one warp: per-thread inner nodes from the private stack
// (a leaf is pushed as -(leaf + 2)), cooperative leaf steps; the leaf step
// also supplies the prune limit, prune(best).
template <class Leaf>
__device__ __forceinline__ void walk_warp(Leaf& leaf_step, Walker& w, int* stack,
                                          const float* __restrict__ boxes,
                                          const int* __restrict__ kid,
                                          const int* __restrict__ order) {
  if (w.sp > 0) stack[0] = 0;  // the root
  warp_leaf_rounds(w, [&](Walker& w) {
    while (w.parked < 0 && w.sp > 0) {
      const int v = stack[--w.sp];
      if (v >= 0) {
        visit_node(boxes, kid, order, v, w, fminf(w.tfar, leaf_step.prune(w.best)), stack, w.sp);
      } else {
        w.parked = -(v + 2);
      }
    }
  }, leaf_step);
}

}  // namespace bvh8
