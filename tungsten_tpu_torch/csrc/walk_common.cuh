// The pieces the warp-cooperative walks share: the BVH8 walks (bvh8_walk.cu,
// bvh8_walk_fast.cu, through bvh8_common.cuh), the skip-BVH walk
// (bvh_walk.cu) and the streaming brute force (intersect_stream.cu).
//
// The traversal skeleton. Inner nodes are walked per thread, exactly as the
// one-thread-per-ray kernels walk them: the same slab test, the same prune
// limit, the same visiting order (K3: per-octant push order and a private
// stack; K5: the stackless skip pointers), so every ray visits its nodes and
// leaves in the same order. Leaves are tested per warp ("while-while"): a
// thread walks inner nodes until it reaches a leaf and parks it; once every
// lane of the warp has parked a leaf or finished, the warp runs cooperative
// leaf steps until no lane is parked:
//   * the leader is the lowest lane with a parked leaf; its leaf id is
//     broadcast, and the members are the lanes parked on that same leaf;
//   * the whole warp copies the leaf into its slice of shared memory with
//     16-byte cp.async copies, coalesced, once whatever number of its rays
//     want the leaf; the slice is double-buffered, so the next leader's leaf
//     is in flight while the current one is tested;
//   * the kernel's leaf step tests the leaf for the members, writes their
//     results back and clears their parked leaf; their lanes then resume.
// `warp_leaf_rounds` is that loop for any traversal: the kernel supplies the
// per-thread descent (until the lane parks a leaf or its walk ends) and its
// leaf step as a policy with stage(leaf, buf) and test(walker, members,
// leaf, buf); `bvh8::walk_warp` is the BVH8 walk on it.
//
// Besides: the (t, slot) minimum of a warp, the cp.async copies, and the
// exact Moller-Trumbore test of K5's leaves and K2's triangles.
//
// The leaves are kLeaf = 128 slots wide (the JAX packs' width, set by the
// TPU's lanes); the wrappers refuse any other width, so the loops unroll.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace walk {

constexpr int kLeaf = 128;  // == LEAF in ops/bvh8.py and ops/bvh.py
constexpr float kInf = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // "no slot" in a warp reduction

// An unsigned key that orders f32 values as < does (all but NaN, which no
// accept rule lets through; -0 is read as +0, so the two tie as they
// compare): the warp's (t, slot) minimum reduces keys, and the winner's t
// is taken from the lane that holds it.
__device__ __forceinline__ unsigned order_key(float t) {
  const unsigned b = __float_as_uint(__fadd_rn(t, 0.0f));
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// 16-byte asynchronous global -> shared copy, and its group fences.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// The lexicographic (t, slot) minimum over the warp of each lane's best
// (tb, sb) (sb = kNone: no hit): the least order key, then the least slot
// holding it, as the serial slot loop's strict t < tb picks it. Returns the
// winning slot (kNone if no lane hit) and its t, taken from the lane that
// holds it (slot s lives in lane s % 32). Every lane of the warp calls it.
__device__ __forceinline__ unsigned warp_min_slot(float tb, unsigned sb, float& t_win) {
  const unsigned key = sb != kNone ? order_key(tb) : kNone;
  const unsigned kmin = __reduce_min_sync(kFull, key);
  const unsigned win = __reduce_min_sync(kFull, (sb != kNone && key == kmin) ? sb : kNone);
  t_win = __shfl_sync(kFull, tb, win & 31u);
  return win;
}

// The cooperative leaf rounds of one warp over any traversal. `descend(w)`
// walks the lane's inner nodes until it parks a leaf (w.parked >= 0) or its
// walk ends; every lane of the warp calls this, live or not (the leaf steps
// are warp collectives), and a lane with nothing to do has an empty walk.
template <class W, class Descend, class Leaf>
__device__ __forceinline__ void warp_leaf_rounds(W& w, Descend&& descend, Leaf& leaf_step) {
  while (true) {
    descend(w);
    unsigned want = __ballot_sync(kFull, w.parked >= 0);
    if (want == 0) return;  // every lane's walk is over
    int leaf = __shfl_sync(kFull, w.parked, __ffs(want) - 1);
    int buf = 0;
    leaf_step.stage(leaf, buf);
    cp_async_commit();
    while (want) {
      const unsigned members = __ballot_sync(kFull, w.parked == leaf);
      const unsigned rest = want & ~members;
      int next = -1;
      if (rest) {
        next = __shfl_sync(kFull, w.parked, __ffs(rest) - 1);
        leaf_step.stage(next, buf ^ 1);
      }
      cp_async_commit();
      cp_async_wait<1>();  // this leaf's copy has landed (the next may be in flight)
      __syncwarp();
      leaf_step.test(w, members, leaf, buf);
      __syncwarp();  // buf is free for the leaf after next
      want = rest;
      leaf = next;
      buf ^= 1;
    }
  }
}

// Moller-Trumbore of one ray against one triangle (v0, e1, e2) in
// `_walk_kernel2`'s order of operations (pallas_bvh.py; `_mt_kernel` has the
// same), every product and sum rounded on its own through __fmul_rn /
// __fadd_rn / __fsub_rn, which nvcc never contracts into fused multiply-adds
// (u = (tv . p) / det cancels, and a fused form differs from the twins'
// ops/bvh.py `mt_leaf` by up to 6e-4 in u on small triangles far from the
// origin), and the quotients through the IEEE reciprocal 1 / det. Accepts
// with `ray_tri`'s rule: |det| > 1e-12, u >= 0, v >= 0, u + v <= 1,
// t > tnear, t < lim; t, u and v are then the twins' bit for bit.
//
// The cheap rejects run first and pay no division: |det|, then the signs of
// u's, v's and (for tnear >= 0) t's numerators against det's. Each drops
// only pairs the rule itself rejects, rounding included: `negative_quotient`
// holds only where num * (1 / det) rounds to a negative nonzero (a product
// that underflows to -0 would pass u >= 0, so a tiny numerator is left to
// the full test).
__device__ __forceinline__ float cross1(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}
__device__ __forceinline__ float dot3(float a, float b, float c, float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), __fmul_rn(c, z));
}

// num / det (as RN(num * RN(1 / det)), |det| > 1e-12) is negative and
// nonzero: the signs differ and |num| > 2^-100 |det| (the threshold rounds
// by at most 2^-150 in the subnormal range), so |num / det| > 2^-102, far
// above f32's underflow at 2^-150. NaN or zero numerators are never dropped.
__device__ __forceinline__ bool negative_quotient(float num, float det) {
  return ((__float_as_uint(num) ^ __float_as_uint(det)) & 0x80000000u) &&
         fabsf(num) > __fmul_rn(0x1p-100f, fabsf(det));
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ bool mt_exact(const Ray& r, float v0x, float v0y, float v0z,
                                         float e1x, float e1y, float e1z, float e2x, float e2y,
                                         float e2z, float tnear, float lim, float& t, float& u,
                                         float& v) {
  const float px = cross1(r.dy, e2z, r.dz, e2y);
  const float py = cross1(r.dz, e2x, r.dx, e2z);
  const float pz = cross1(r.dx, e2y, r.dy, e2x);
  const float det = dot3(e1x, e1y, e1z, px, py, pz);
  if (!(fabsf(det) > 1e-12f)) return false;
  const float tvx = __fsub_rn(r.ox, v0x), tvy = __fsub_rn(r.oy, v0y), tvz = __fsub_rn(r.oz, v0z);
  const float un = dot3(tvx, tvy, tvz, px, py, pz);
  if (negative_quotient(un, det)) return false;
  const float qx = cross1(tvy, e1z, tvz, e1y);
  const float qy = cross1(tvz, e1x, tvx, e1z);
  const float qz = cross1(tvx, e1y, tvy, e1x);
  const float vn = dot3(r.dx, r.dy, r.dz, qx, qy, qz);
  if (negative_quotient(vn, det)) return false;
  const float tn = dot3(e2x, e2y, e2z, qx, qy, qz);
  if (tnear >= 0.0f && negative_quotient(tn, det)) return false;
  const float inv_det = __frcp_rn(det);
  u = __fmul_rn(un, inv_det);
  v = __fmul_rn(vn, inv_det);
  t = __fmul_rn(tn, inv_det);
  return (u >= 0.0f) && (v >= 0.0f) && (__fadd_rn(u, v) <= 1.0f) && (t > tnear) && (t < lim);
}

}  // namespace walk
