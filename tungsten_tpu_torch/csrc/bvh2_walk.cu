// Binary skip-BVH walk for Hopper (sm_90a), three modes. Closest hit
// ("ordered", "skip"): inner nodes per thread, leaves per warp. Any hit:
// one thread per ray.
//
// Replaces the TPU kernel K4, the three walks that `_launch3` selects in
// tungsten_tpu/ops/pallas_bvh2.py:
//   mode 0 "ordered"  `_walk_kernel4` (intersect_bvh_pallas3's default):
//                     near child first, the far one pushed on a stack;
//   mode 1 "skip"     `_walk_kernel3` (_launch3(ordered=False)): stackless
//                     skip-pointer closest hit;
//   mode 2 "any"      `_walk_kernel3_any` (occluded_bvh_pallas3): the skip
//                     walk, leaving at the first hit in (tnear, tfar).
// It computes what K4 computes, not block by block:
//   * box test: `_box_test`'s rule (tmin <= tmax) & (tmax > tnear) &
//     (tmin < lim), inv = 1 / (d == 0 ? 1e-30 : d), lim = min(tfar, best) in
//     the closest-hit modes and tfar in "any". fminf / fmaxf drop NaN where
//     the JAX kernels' jnp.minimum / maximum keep it; the twin in
//     ops/bvh2.py uses torch.fmin / fmax to follow this kernel;
//   * skip walk: a hit inner node goes to ptr + 1, a leaf or a miss to
//     skip[ptr], until ptr >= M;
//   * ordered walk: at an inner node test both children (left = ptr + 1,
//     right = skip[left]); when both hit push the far one and descend into
//     the near one. Near is chosen from the node's ordcode (2 * axis + left
//     is low) against the sign of the RAY's own direction on that axis;
//     `_walk_kernel4` votes with the ray tile's summed direction. That
//     changes only the visiting order, not the closest hit. A leaf is
//     evaluated when its own box is hit (hitS). The stack holds kStack
//     entries; Bvh3Pack.from_arrays refuses a tree deeper than that, which
//     the JAX package never checks;
//   * leaf: 128 triangles in Woop plane form read from the BVH8 pack's
//     plane slabs (`_leaf_tuv`): t = -(N.o + nc) / (N.d),
//     u = (U.o + uc) + t (U.d), v likewise; accept u >= 0, v >= 0,
//     u + v <= 1, t > tnear, t < lim. The lowest slot wins a tie inside a
//     leaf; across leaves a strictly smaller t is needed. Empty and
//     degenerate slots are all-zero planes: t = -0/0 = NaN and every
//     comparison is false, so the file is built without fast-math;
//   * "any" keeps the first hit slot of the first leaf that has one, with
//     its t, and leaves.
// Dead lanes (tnear >= tfar) do no work and report a miss.
//
// What bounds it on the H100: latency. A binary node is 32 bytes of box
// plus 16 of integer fields; a leaf visit reads 128 plane triples (6 KB).
// The pack of an 80k-triangle scene is ~5.5 MB of planes and <0.1 MB of
// nodes, so it lives in the 50 MB L2. The first form (bvh2_walk_v1.cu, one
// thread per ray) waited on its leaf loads: 384 16-byte loads a leaf visit
// in a serial loop, at addresses that differ between the lanes of a warp
// once rays diverge, each ray reading its 6 KB leaf alone. The closest-hit
// modes here take K3's and K5's design (walk_common.cuh `warp_leaf_rounds`):
//   * per thread, the walk runs its inner nodes with the first form's rules
//     until it reaches a leaf whose box it hits, and parks it. The skip walk
//     then moves its pointer to skip[ptr]; the ordered walk pops the next
//     pointer from its stack (kStack ints in local memory). Neither tests
//     the next node's box before the leaf step has run, so each visit's
//     limit min(tfar, best) is the first form's, and so is the visiting
//     order;
//   * once every lane has parked or finished, the warp stages each wanted
//     leaf once in shared memory and tests it for its members with K3's
//     leaf step (bvh8_common.cuh `ExactLeaf`: the 128 slots split across
//     the lanes, `slot_exact`, the warp's (t, slot) minimum), double-
//     buffered, with no lane latched;
//   * 4 warps a block, 12 KB of dynamic shared memory a warp (two leaf
//     buffers of 128 x 3 float4), 48 KB a block.
// The leaf's arithmetic is `slot_exact`'s, which rounds as K3 does, not as
// the first form's compiler-contracted expressions did: the two agree by
// bars, not bits. "any" keeps the first form's per-thread body and its
// arithmetic, as a kernel of its own.
// What is left: the warp waits for its longest traversal before each round
// of leaf steps, and a coherent warp (32 rays on one leaf) runs 32 member
// steps of 4 slots a lane where the serial loop ran 128 slots a lane once.
//
// Plain C interface, loaded with ctypes; bvh2_walk launches on the given
// stream and returns cudaGetLastError().

#include "bvh8_common.cuh"

namespace {

using namespace bvh8;

constexpr int kStack = 96;  // == STACK_DEPTH in ops/bvh2.py
constexpr int kWarps = 4;   // warps a block (closest-hit modes)
constexpr int kSmemPerWarp = 2 * kLeafVec * 16;  // two leaf buffers
constexpr int kSmem = kWarps * kSmemPerWarp;
static_assert(kSmem <= 48 * 1024, "within the default dynamic shared memory limit");

// One ray's binary walk, held by its lane (the fields ExactLeaf reads).
struct BinWalker {
  float ox, oy, oz, dx, dy, dz;  // the ray
  float ix, iy, iz;              // 1 / d, d == 0 read as 1e-30
  float tnear, tfar, best;
  int ptr, sp, local, parked;  // ptr: the next node, -1 when the walk is over

  __device__ __forceinline__ void leave() {
    ptr = -1;
    sp = 0;
  }
};

// The slab test of node v's box against the ray r (a BinWalker, or the
// any-hit kernel's AnyRay: fields ox..oz, ix..iz, tnear).
template <class R>
__device__ __forceinline__ bool box_hit(const float4* __restrict__ box, int v, const R& r,
                                        float lim) {
  const float4 lo = __ldg(box + 2 * v);      // minx miny minz maxx
  const float4 hi = __ldg(box + 2 * v + 1);  // maxy maxz 0 0
  const float t0x = (lo.x - r.ox) * r.ix, t1x = (lo.w - r.ox) * r.ix;
  const float t0y = (lo.y - r.oy) * r.iy, t1y = (hi.x - r.oy) * r.iy;
  const float t0z = (lo.z - r.oz) * r.iz, t1z = (hi.y - r.oz) * r.iz;
  const float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return (tmin <= tmax) && (tmax > r.tnear) && (tmin < lim);
}

// The closest-hit walks: kOrdered = mode 0, else mode 1.
template <bool kOrdered>
__global__ void __launch_bounds__(kWarps * 32) bvh2_walk_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tnear_in, const float* __restrict__ tfar_in,
    const float4* __restrict__ box,     // (m, 2) float4: [min3 maxx | maxy maxz 0 0]
    const int4* __restrict__ ni,        // (m,) [leaf_blk, count, skip, ordcode]
    const float4* __restrict__ planes,  // (n_leaves, 128, 3): N, U, V (x y z c)
    int m_nodes, int n, float* __restrict__ out_t, int* __restrict__ out_local) {
  extern __shared__ float4 smem_all[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  BinWalker w{};
  w.best = kInf;
  w.local = -1;
  w.parked = -1;
  w.ptr = -1;  // a lane past n or a dead ray: no walk
  if (i < n) {
    w.ox = o[3 * i], w.oy = o[3 * i + 1], w.oz = o[3 * i + 2];
    w.dx = d[3 * i], w.dy = d[3 * i + 1], w.dz = d[3 * i + 2];
    w.tnear = tnear_in[i];
    w.tfar = fminf(tfar_in[i], kInf);
    w.ix = 1.0f / (w.dx == 0.0f ? 1e-30f : w.dx);
    w.iy = 1.0f / (w.dy == 0.0f ? 1e-30f : w.dy);
    w.iz = 1.0f / (w.dz == 0.0f ? 1e-30f : w.dz);
    if (w.tnear < w.tfar) w.ptr = 0;
  }
  ExactLeaf leaf_step{planes, smem_all + (threadIdx.x >> 5) * 2 * kLeafVec, 0u, lane};
  int stack[kOrdered ? kStack : 1];
  warp_leaf_rounds(w, [&](BinWalker& w) {
    while (w.parked < 0 && w.ptr >= 0) {
      const int4 nd = __ldg(ni + w.ptr);
      const float lim = fminf(w.tfar, w.best);
      if constexpr (kOrdered) {
        int next = -1;
        if (nd.y > 0) {
          if (box_hit(box, w.ptr, w, lim)) w.parked = nd.x;  // the leaf waits for the warp
        } else {
          const int left = w.ptr + 1;
          const int right = __ldg(&ni[left].z);
          const bool hl = box_hit(box, left, w, lim);
          const bool hr = box_hit(box, right, w, lim);
          const int axis = nd.w >> 1;
          const bool pos = axis == 0 ? w.dx >= 0.0f : (axis == 1 ? w.dy >= 0.0f : w.dz >= 0.0f);
          const bool left_near = ((nd.w & 1) == 1) == pos;
          if (hl && hr) {
            stack[w.sp++] = left_near ? right : left;
            next = left_near ? left : right;
          } else {
            next = hl ? left : (hr ? right : -1);
          }
        }
        // after a park the next pointer is popped, but its box waits for
        // the leaf step's best
        if (next < 0 && w.sp > 0) next = stack[--w.sp];
        w.ptr = next;
      } else {
        const bool h = box_hit(box, w.ptr, w, lim);
        if (h && nd.y > 0) w.parked = nd.x;  // the leaf waits for the warp
        const int next = (h && nd.y == 0) ? w.ptr + 1 : nd.z;
        w.ptr = next < m_nodes ? next : -1;
      }
    }
  }, leaf_step);
  if (i < n) {
    out_t[i] = w.best;
    out_local[i] = w.local;
  }
}

// ---- mode 2, "any": the first form's per-thread body ----

struct AnyRay {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tnear;
};

// The leaf's lowest hit slot (-1: none) and its t.
__device__ __forceinline__ int plane_leaf_first(const float4* __restrict__ planes, int blk,
                                                int leaf, const AnyRay& r, float lim,
                                                float& t_out) {
  const float4* p = planes + (size_t)blk * leaf * 3;
  for (int s = 0; s < leaf; ++s) {
    const float4 N = __ldg(p + 3 * s);
    const float4 U = __ldg(p + 3 * s + 1);
    const float4 V = __ldg(p + 3 * s + 2);
    const float ao = N.x * r.ox + N.y * r.oy + N.z * r.oz + N.w;
    const float ad = N.x * r.dx + N.y * r.dy + N.z * r.dz;
    const float t = -ao / ad;
    const float u = (U.x * r.ox + U.y * r.oy + U.z * r.oz + U.w) +
                    t * (U.x * r.dx + U.y * r.dy + U.z * r.dz);
    const float w = (V.x * r.ox + V.y * r.oy + V.z * r.oz + V.w) +
                    t * (V.x * r.dx + V.y * r.dy + V.z * r.dz);
    if ((u >= 0.0f) && (w >= 0.0f) && (u + w <= 1.0f) && (t > r.tnear) && (t < lim)) {
      t_out = t;
      return s;
    }
  }
  t_out = kInf;
  return -1;
}

__global__ void bvh2_any_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tnear_in, const float* __restrict__ tfar_in,
    const float4* __restrict__ box, const int4* __restrict__ ni,
    const float4* __restrict__ planes, int m_nodes, int n, int leaf,
    float* __restrict__ out_t, int* __restrict__ out_local) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  AnyRay r;
  r.ox = o[3 * i], r.oy = o[3 * i + 1], r.oz = o[3 * i + 2];
  r.dx = d[3 * i], r.dy = d[3 * i + 1], r.dz = d[3 * i + 2];
  r.tnear = tnear_in[i];
  const float tfar = fminf(tfar_in[i], kInf);
  float best = kInf;
  int local = -1;
  if (r.tnear < tfar) {
    r.ix = 1.0f / (r.dx == 0.0f ? 1e-30f : r.dx);
    r.iy = 1.0f / (r.dy == 0.0f ? 1e-30f : r.dy);
    r.iz = 1.0f / (r.dz == 0.0f ? 1e-30f : r.dz);
    int ptr = 0;
    while (ptr < m_nodes) {
      const int4 nd = __ldg(ni + ptr);
      const bool h = box_hit(box, ptr, r, tfar);
      if (h && nd.y > 0) {
        float tb;
        const int s = plane_leaf_first(planes, nd.x, leaf, r, tfar, tb);
        if (s >= 0) {
          best = tb;
          local = nd.x * leaf + s;
          break;  // any-hit: leave the walk
        }
      }
      ptr = (h && nd.y == 0) ? ptr + 1 : nd.z;
    }
  }
  out_t[i] = best;
  out_local[i] = local;
}

}  // namespace

extern "C" int bvh2_walk(
    const float* o, const float* d, const float* tnear, const float* tfar,
    const float* box, const int* ni, const float* planes,
    int m_nodes, int mode, int n, int leaf,
    float* out_t, int* out_local, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* b = reinterpret_cast<const float4*>(box);
  const int4* nodes = reinterpret_cast<const int4*>(ni);
  const float4* p = reinterpret_cast<const float4*>(planes);
  if (mode == 2) {
    const int threads = 128;
    bvh2_any_kernel<<<(n + threads - 1) / threads, threads, 0, s>>>(
        o, d, tnear, tfar, b, nodes, p, m_nodes, n, leaf, out_t, out_local);
    return static_cast<int>(cudaGetLastError());
  }
  if (leaf != kLeaf || (mode != 0 && mode != 1)) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = kWarps * 32;
  const int blocks = (n + threads - 1) / threads;
  if (mode == 0) {
    bvh2_walk_kernel<true><<<blocks, threads, kSmem, s>>>(o, d, tnear, tfar, b, nodes, p,
                                                          m_nodes, n, out_t, out_local);
  } else {
    bvh2_walk_kernel<false><<<blocks, threads, kSmem, s>>>(o, d, tnear, tfar, b, nodes, p,
                                                           m_nodes, n, out_t, out_local);
  }
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks a multiprocessor of the closest-hit kernel of `mode`
// (0 ordered, 1 skip), registers and shared memory permitting.
extern "C" int bvh2_walk_blocks_per_sm(int mode) {
  int blocks = 0;
  if (mode == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bvh2_walk_kernel<true>, kWarps * 32,
                                                  kSmem);
  } else {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bvh2_walk_kernel<false>,
                                                  kWarps * 32, kSmem);
  }
  return blocks;
}
