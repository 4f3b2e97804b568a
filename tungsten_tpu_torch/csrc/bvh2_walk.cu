// Binary skip-BVH walk for Hopper (sm_90a), three modes, each with inner
// nodes per thread and leaves per warp: closest hit ("ordered", "skip") and
// any hit ("any").
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
// once rays diverge, each ray reading its 6 KB leaf alone. The three modes
// here take K3's and K5's design (walk_common.cuh `warp_leaf_rounds`):
//   * per thread, the walk runs its inner nodes with the first form's rules
//     until it reaches a leaf whose box it hits, and parks it. The skip and
//     any walks then move their pointer to skip[ptr]; the ordered walk pops
//     the next pointer from its stack (kStack ints in local memory). None
//     tests the next node's box before the leaf step has run, so each
//     visit's limit min(tfar, best) is the first form's, and so is the
//     visiting order;
//   * once every lane has parked or finished, the warp stages each wanted
//     leaf once in shared memory and tests it for its members with K3's
//     leaf step (bvh8_common.cuh `ExactLeaf`: the 128 slots split across
//     the lanes, `slot_exact`, the warp's (t, slot) minimum), double-
//     buffered. The closest-hit modes latch no lane. "any" latches every
//     lane: a member takes its leaf's lowest hit slot with that slot's t
//     (BinWalker::latch_hit) and leaves its walk. Its best stays kInf until
//     then, so its limit min(tfar, best) is tfar, as `_walk_kernel3_any`'s;
//   * 4 warps a block, 12 KB of dynamic shared memory a warp (two leaf
//     buffers of 128 x 3 float4), 48 KB a block.
// The leaf's arithmetic is `slot_exact`'s, which rounds as K3 does, not as
// the first form's compiler-contracted expressions did: the two agree by
// bars, not bits.
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
constexpr int kWarps = 4;   // warps a block
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
  // "any": a latched member's hit at t (its leaf's lowest hit slot) ends the walk
  static constexpr bool kLatchT = true;
  __device__ __forceinline__ void latch_hit(float t) {
    best = t;
    leave();
  }
};

// The slab test of node v's box against the ray r.
__device__ __forceinline__ bool box_hit(const float4* __restrict__ box, int v,
                                        const BinWalker& r, float lim) {
  const float4 lo = __ldg(box + 2 * v);      // minx miny minz maxx
  const float4 hi = __ldg(box + 2 * v + 1);  // maxy maxz 0 0
  const float t0x = (lo.x - r.ox) * r.ix, t1x = (lo.w - r.ox) * r.ix;
  const float t0y = (lo.y - r.oy) * r.iy, t1y = (hi.x - r.oy) * r.iy;
  const float t0z = (lo.z - r.oz) * r.iz, t1z = (hi.y - r.oz) * r.iz;
  const float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return (tmin <= tmax) && (tmax > r.tnear) && (tmin < lim);
}

// The three walks: kMode 0 ordered, 1 skip, 2 any (the skip walk, every
// lane latched).
template <int kMode>
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
  constexpr bool kOrdered = kMode == 0;
  // "any" latches every lane; only a lane that parks a leaf becomes a member
  ExactLeaf leaf_step{planes, smem_all + (threadIdx.x >> 5) * 2 * kLeafVec,
                      kMode == 2 ? kFull : 0u, lane};
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

// The kernel of each mode, indexed by mode.
void (*const kKernels[3])(const float*, const float*, const float*, const float*, const float4*,
                          const int4*, const float4*, int, int, float*, int*) = {
    bvh2_walk_kernel<0>, bvh2_walk_kernel<1>, bvh2_walk_kernel<2>};

}  // namespace

extern "C" int bvh2_walk(
    const float* o, const float* d, const float* tnear, const float* tfar,
    const float* box, const int* ni, const float* planes,
    int m_nodes, int mode, int n, int leaf,
    float* out_t, int* out_local, void* stream) {
  if (n <= 0) return 0;
  if (leaf != kLeaf || mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = kWarps * 32;
  kKernels[mode]<<<(n + threads - 1) / threads, threads, kSmem,
                   static_cast<cudaStream_t>(stream)>>>(
      o, d, tnear, tfar, reinterpret_cast<const float4*>(box), reinterpret_cast<const int4*>(ni),
      reinterpret_cast<const float4*>(planes), m_nodes, n, out_t, out_local);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks a multiprocessor of the kernel of `mode` (0 ordered,
// 1 skip, 2 any), registers and shared memory permitting.
extern "C" int bvh2_walk_blocks_per_sm(int mode) {
  int blocks = 0;
  if (mode < 0 || mode > 2) return 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kKernels[mode], kWarps * 32, kSmem);
  return blocks;
}
