// BVH8 walk for Hopper (sm_90a): inner nodes per thread, leaves per warp.
// Closest hit, any hit and mixed through a per-ray latch.
//
// Replaces the TPU kernel K3: `_walk_kernel8` in tungsten_tpu/ops/pallas_bvh8.py
// (launched by `_launch8`; APIs intersect_bvh_pallas8 / occluded_bvh_pallas8).
// It computes what K3 computes with fast=False, not block by block:
//   * node visit: slab-test the node's 8 child boxes with exactly K3's rule
//     (tmin <= tmax) & (tmax > tnear) & (tmin < min(tfar, best)) & (tnear < tfar),
//     inv = 1 / (d == 0 ? 1e-30 : d); push the hit children far-to-near by the
//     node's per-octant order word (the octant of the ray's own direction;
//     K3 takes one octant per ray tile, which changes only the visiting order);
//   * leaf: 128 triangles in Woop plane form (bvh8_common.cuh `slot_exact`);
//     within a leaf the lowest slot among the least t wins, across leaves a
//     strictly smaller t is needed. Empty and degenerate slots are all-zero
//     planes: t = -0/0 = NaN and every comparison is false, so the file must
//     not be built with --use_fast_math;
//   * latch: a latched ray records its first hit (the lowest slot that hits,
//     best = 0) and leaves.
// The plain PyTorch twin `walk_twin` (ops/bvh8.py) defines the function; the
// one-thread-per-ray kernel bvh8_walk_v1.cu computes it with the same slot
// test, node visits and visiting order, so the two agree bit for bit.
//
// What bounds it on the H100: latency. The pack of an 80k-triangle scene
// (~5.5 MB of f32 planes, <1 MB of nodes) sits in the 50 MB L2, so the walk is
// no HBM stream; the one-thread-per-ray kernel waited on its leaf loads: 384
// 16-byte loads a leaf visit in a serial loop, at addresses that differ
// between the lanes of a warp once rays diverge (up to 32 line requests a
// load), each ray reading its 6 KB leaf alone. The design here:
//   * the traversal skeleton of walk_common.cuh: once every lane has parked a
//     leaf or finished, the warp copies each wanted leaf once into shared
//     memory (12 cp.async of 16 bytes a lane, coalesced, double-buffered so
//     the next leaf's copy overlaps this leaf's tests);
//   * the members of a leaf are tested one after the other, each by the whole
//     warp (bvh8_common.cuh `ExactLeaf`, shared with K4's closest-hit
//     walks): the member's ray is broadcast with __shfl_sync, lane l tests
//     slots l, l+32, l+64 and l+96 from shared memory (conflict-free 16-byte
//     reads), keeping the lowest slot among its least t (or its lowest hit
//     under the latch), and two redux.sync minima over (order_key(t), slot)
//     give the lexicographic winner the serial loop gives;
//   * 4 warps a block, 12 KB of dynamic shared memory a warp (two leaf
//     buffers of 128 x 3 float4).
// What is left: the stack (160 ints) stays in local memory, a warp waits for
// its longest traversal before each round of leaf steps, and a coherent warp
// (32 rays on one leaf) runs 32 member steps of 4 slots a lane where the
// serial loop ran 128 slots a lane once.
//
// Plain C interface, loaded with ctypes; bvh8_walk launches on the given
// stream and returns cudaGetLastError().

#include "bvh8_common.cuh"

namespace {

using namespace bvh8;

constexpr int kWarps = 4;                        // warps a block
constexpr int kSmemPerWarp = 2 * kLeafVec * 16;  // two leaf buffers
constexpr int kSmem = kWarps * kSmemPerWarp;

__global__ void __launch_bounds__(kWarps * 32) bvh8_walk_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tnear_in, const float* __restrict__ tfar_in,
    const uint8_t* __restrict__ latch_in, int latch_mode,
    const float* __restrict__ boxes,    // (m8, 8, 8): child box [min3 | max3 | 0 0]
    const int* __restrict__ kid,        // (m8, 8): >=0 node, <=-2 leaf, -1 none
    const int* __restrict__ order,      // (m8, 8): per-octant order word
    const float4* __restrict__ planes,  // (n_leaves, 128, 3): N, U, V (x y z c)
    int n, float* __restrict__ out_t, int* __restrict__ out_local) {
  extern __shared__ float4 smem_all[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  Walker w = make_walker(o, d, tnear_in, tfar_in, i, n);
  const bool latched =
      i < n && (latch_mode == 1 || (latch_mode == 2 && latch_in[i] != 0));
  ExactLeaf leaf_step{planes, smem_all + (threadIdx.x >> 5) * 2 * kLeafVec,
                      __ballot_sync(kFull, latched), lane};
  int stack[kDepth];
  walk_warp(leaf_step, w, stack, boxes, kid, order);
  if (i < n) {
    out_t[i] = w.best;
    out_local[i] = w.local;
  }
}

}  // namespace

extern "C" int bvh8_walk(
    const float* o, const float* d, const float* tnear, const float* tfar,
    const uint8_t* latch, int latch_mode,
    const float* boxes, const int* kid, const int* order, const float* planes,
    int n, float* out_t, int* out_local, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(bvh8_walk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = kWarps * 32;
  const int blocks = (n + threads - 1) / threads;
  bvh8_walk_kernel<<<blocks, threads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      o, d, tnear, tfar, latch, latch_mode, boxes, kid, order,
      reinterpret_cast<const float4*>(planes), n, out_t, out_local);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks a multiprocessor (registers and shared memory permitting).
extern "C" int bvh8_walk_blocks_per_sm() {
  int blocks = 0;
  cudaFuncSetAttribute(bvh8_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bvh8_walk_kernel, kWarps * 32, kSmem);
  return blocks;
}
