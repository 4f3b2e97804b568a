// Skip-BVH walk with Moller-Trumbore leaves for Hopper (sm_90a): inner nodes
// per thread (stackless), leaves per warp, in two modes.
//
// Replaces both versions of the TPU kernel K5 in tungsten_tpu/ops/pallas_bvh.py
// (API intersect_bvh_pallas, which picks by its module constant V2):
//   * prune = 1: K5-v2, `_walk_kernel2` (launched by `_launch2`), whose box
//     tests use the ray's best hit so far: lim = min(tfar, best);
//   * prune = 0: K5-v1, `_walk_kernel` (launched by `_launch`), whose box
//     tests use the ray's own tfar (`_walk_kernel`:103-105) while its leaf
//     test still uses min(tfar, best) (:148).
// It computes what K5 computes, not block by block:
//   * walk: a hit inner node goes to ptr + 1, a leaf or a miss to skip[ptr],
//     until ptr >= M; boxes are tested with `_box_test`'s rule against the
//     mode's lim, inv = 1 / (d == 0 ? 1e-30 : d) (fminf / fmaxf, as the
//     twin's torch.fmin / fmax);
//   * leaf: the 128 slots in Moller-Trumbore form with `ray_tri`'s accept
//     rule (walk_common.cuh `mt_exact`): |det| > 1e-12, u >= 0, v >= 0,
//     u + v <= 1, t > tnear, t < min(tfar, best); the lowest slot wins a tie
//     inside a leaf, and across leaves a strictly smaller t is needed. u and
//     v are the winning slot's. Padding slots are all-zero triangles
//     (det = 0) and never win, although prim_map sends them to triangle 0;
//   * K5 walks a 512-ray tile in lockstep: the tile descends where any lane
//     hits, so a lane may test leaves its own ray misses. This walk is per
//     ray and tests fewer leaves; the closest hit is the same apart from
//     box-boundary rounding.
// Every product and sum of the leaf is its own IEEE f32 operation in
// `_walk_kernel2`'s order, so t, u and v equal the twin's (`walk_packet_twin`,
// ops/bvh.py) bit for bit, and those of bvh_walk_v1.cu, the first CUDA form
// (one thread per ray, a serial slot loop), which visits the same nodes and
// leaves in the same order. The node fields leaf_blk, count and skip are
// exact f32 in the JAX layout; BvhPack.from_arrays converts them once into
// an int4 row per node. Dead lanes (tnear >= tfar) do no work and report a
// miss.
//
// What bounds it on the H100: latency. The pack of an 80k-triangle scene
// (~4 MB of triangles) sits in L2; the first form waited on its leaf loads:
// 4.5 KB a leaf visit, 9 scalar loads a slot in a serial loop of 128, at
// addresses that differ between the lanes of a warp once rays diverge. The
// design here is K3's (bvh8_walk.cu; walk_common.cuh `warp_leaf_rounds`):
//   * per thread, the skip walk runs until it reaches a leaf its box test
//     hits and parks it; the leaf's lim is min(tfar, best) when the warp
//     tests it, which is the visit's (best moves only in a leaf step);
//   * once every lane has parked or finished, the warp stages each wanted
//     leaf once in shared memory (128 x 9 floats = 4,608 B: 9 cp.async of 16
//     bytes a lane, coalesced, double-buffered so that the next leaf's copy
//     overlaps this one's tests);
//   * the members of a leaf are tested one after the other by the whole warp:
//     the member's ray is broadcast with __shfl_sync, lane l tests slots l,
//     l+32, l+64 and l+96 (the 9-float stride is odd, so the scalar reads
//     are free of bank conflicts), keeping the lowest slot among its least t,
//     and two redux.sync minima over (order_key(t), slot) give the serial
//     loop's winner; the member takes t, u, v and the slot from the winner's
//     lane;
//   * the cheap rejects of `mt_exact` (|det|, the signs of u's, v's and t's
//     numerators) run before the reciprocal;
//   * 4 warps a block, 9 KB of dynamic shared memory a warp.
// What is left: the warp waits for its longest traversal before each round
// of leaf steps, and a coherent warp (32 rays on one leaf) runs 32 member
// steps of 4 slots a lane where the serial loop ran 128 slots a lane once.
//
// Plain C interface, loaded with ctypes; bvh_walk launches on the given
// stream and returns cudaGetLastError(). Built without fast-math.

#include "walk_common.cuh"

namespace {

using namespace walk;

constexpr int kWarps = 4;                        // warps a block
constexpr int kLeafFloats = kLeaf * 9;           // one leaf: 128 slots of v0 | e1 | e2
constexpr int kLeafVec = kLeafFloats / 4;        // its float4 copies (288)
constexpr int kSmemPerWarp = 2 * kLeafFloats * 4;  // two leaf buffers
constexpr int kSmem = kWarps * kSmemPerWarp;
static_assert(kSmem <= 48 * 1024, "within the default dynamic shared memory limit");

// One ray's skip walk, held by its lane.
struct SkipWalker {
  Ray r;
  float idx, idy, idz;  // 1 / d, d == 0 read as 1e-30
  float tnear, tfar, best, bu, bv;
  int ptr, local, parked;  // parked: a leaf waiting for the warp, or -1
};

struct MtLeaf {
  const float4* tris;  // (n_leaves, 128, 9) as float4: v0, e1, e2
  float* smem;         // this warp's [2][kLeafFloats]
  int lane;

  __device__ __forceinline__ void stage(int leaf, int buf) {
    const float4* src = tris + static_cast<size_t>(leaf) * kLeafVec;
    float4* dst = reinterpret_cast<float4*>(smem + buf * kLeafFloats);
#pragma unroll
    for (int k = 0; k < kLeafVec / 32; ++k) cp_async16(dst + lane + 32 * k, src + lane + 32 * k);
  }

  __device__ __forceinline__ void test(SkipWalker& w, unsigned members, int leaf, int buf) {
    const float* p = smem + buf * kLeafFloats;
    const float lim_own = fminf(w.tfar, w.best);
    while (members) {
      const int src = __ffs(members) - 1;
      members &= members - 1;
      Ray r;
      r.ox = __shfl_sync(kFull, w.r.ox, src), r.oy = __shfl_sync(kFull, w.r.oy, src);
      r.oz = __shfl_sync(kFull, w.r.oz, src), r.dx = __shfl_sync(kFull, w.r.dx, src);
      r.dy = __shfl_sync(kFull, w.r.dy, src), r.dz = __shfl_sync(kFull, w.r.dz, src);
      const float tnear = __shfl_sync(kFull, w.tnear, src);
      const float lim = __shfl_sync(kFull, lim_own, src);
      float tb = kInf, ub = 0.0f, vb = 0.0f;
      unsigned sb = kNone;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = lane + 32 * j;
        const float* tr = p + 9 * s;
        float t, u, v;
        if (mt_exact(r, tr[0], tr[1], tr[2], tr[3], tr[4], tr[5], tr[6], tr[7], tr[8], tnear,
                     lim, t, u, v) &&
            t < tb) {
          tb = t;
          ub = u;
          vb = v;
          sb = s;
        }
      }
      float t_win;
      const unsigned win = warp_min_slot(tb, sb, t_win);
      const float u_win = __shfl_sync(kFull, ub, win & 31u);
      const float v_win = __shfl_sync(kFull, vb, win & 31u);
      if (lane == src && win != kNone) {
        w.best = t_win;  // below lim = min(tfar, best): always nearer
        w.bu = u_win;
        w.bv = v_win;
        w.local = leaf * kLeaf + static_cast<int>(win);
      }
    }
    if (w.parked == leaf) w.parked = -1;
  }
};

__global__ void __launch_bounds__(kWarps * 32) bvh_walk_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tnear_in, const float* __restrict__ tfar_in,
    const float4* __restrict__ box,  // (m, 2) float4: [min3 maxx | maxy maxz 0 0]
    const int4* __restrict__ ni,     // (m,) [leaf_blk, count, skip, 0]
    const float4* __restrict__ tris,  // (n_leaves, kLeaf, 9): v0, e1, e2
    int m_nodes, int n, int prune,
    float* __restrict__ out_t, int* __restrict__ out_local,
    float* __restrict__ out_u, float* __restrict__ out_v) {
  extern __shared__ float4 smem_all[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  SkipWalker w{};
  w.best = kInf;
  w.local = -1;
  w.parked = -1;
  w.ptr = m_nodes;  // a lane past n or a dead ray: no walk
  if (i < n) {
    w.r.ox = o[3 * i], w.r.oy = o[3 * i + 1], w.r.oz = o[3 * i + 2];
    w.r.dx = d[3 * i], w.r.dy = d[3 * i + 1], w.r.dz = d[3 * i + 2];
    w.tnear = tnear_in[i];
    w.tfar = tfar_in[i];
    w.idx = 1.0f / (w.r.dx == 0.0f ? 1e-30f : w.r.dx);
    w.idy = 1.0f / (w.r.dy == 0.0f ? 1e-30f : w.r.dy);
    w.idz = 1.0f / (w.r.dz == 0.0f ? 1e-30f : w.r.dz);
    if (w.tnear < w.tfar) w.ptr = 0;
  }
  MtLeaf leaf_step{tris, reinterpret_cast<float*>(smem_all + (threadIdx.x >> 5) *
                                                                 (kSmemPerWarp / 16)),
                   lane};
  warp_leaf_rounds(w, [&](SkipWalker& w) {
    while (w.parked < 0 && w.ptr < m_nodes) {
      const int4 nd = __ldg(ni + w.ptr);
      const float box_lim = prune ? fminf(w.tfar, w.best) : w.tfar;
      const float4 lo = __ldg(box + 2 * w.ptr);
      const float4 hi = __ldg(box + 2 * w.ptr + 1);
      const float t0x = (lo.x - w.r.ox) * w.idx, t1x = (lo.w - w.r.ox) * w.idx;
      const float t0y = (lo.y - w.r.oy) * w.idy, t1y = (hi.x - w.r.oy) * w.idy;
      const float t0z = (lo.z - w.r.oz) * w.idz, t1z = (hi.y - w.r.oz) * w.idz;
      const float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
      const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
      const bool h = (tmin <= tmax) && (tmax > w.tnear) && (tmin < box_lim);
      if (h && nd.y > 0) w.parked = nd.x;  // the leaf waits for the warp
      w.ptr = (h && nd.y == 0) ? w.ptr + 1 : nd.z;
    }
  }, leaf_step);
  if (i < n) {
    out_t[i] = w.best;
    out_local[i] = w.local;
    out_u[i] = w.bu;
    out_v[i] = w.bv;
  }
}

}  // namespace

extern "C" int bvh_walk(
    const float* o, const float* d, const float* tnear, const float* tfar,
    const float* box, const int* ni, const float* tris, int m_nodes, int n, int prune,
    float* out_t, int* out_local, float* out_u, float* out_v, void* stream) {
  if (n <= 0) return 0;
  const int threads = kWarps * 32;
  const int blocks = (n + threads - 1) / threads;
  bvh_walk_kernel<<<blocks, threads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      o, d, tnear, tfar, reinterpret_cast<const float4*>(box),
      reinterpret_cast<const int4*>(ni), reinterpret_cast<const float4*>(tris), m_nodes, n,
      prune, out_t, out_local, out_u, out_v);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks a multiprocessor (registers and shared memory permitting).
extern "C" int bvh_walk_blocks_per_sm() {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bvh_walk_kernel, kWarps * 32, kSmem);
  return blocks;
}
