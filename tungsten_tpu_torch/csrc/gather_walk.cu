// Per-lane gather walk over an 8-ary tree of 8-triangle leaves, one thread
// per lane: the Hopper (sm_90a) form of K1.
//
// Replaces tungsten_tpu/ops/gather_bvh.py `_phase` (:216-466), the JAX
// package's production intersector on the TPU (intersect_bvh_gather,
// intersect_bvh_gather_mixed, occluded_bvh_gather). K1 is XLA gathers, not
// Pallas: each round gathers one row per lane and runs the node and leaf
// arithmetic over all lanes, masked. This kernel computes what `_phase`
// computes, per thread:
//   * a row is 84 floats (K_ROW = 81 padded; ops/gather_bvh.py gives the
//     layout), 21 16-byte pieces: a node's boxes and child ids (56 floats),
//     or a leaf's 8 triangles and prim ids (80). Node rows come first, so a
//     row is a leaf when its id is at least the pack's n_nodes;
//   * node round: the slab tests of the pending children (pend bit set,
//     child id >= 0, blo <= bhi, bhi >= tnear, blo < best t), the nearest by
//     blo (the lowest slot on ties) becomes the cursor; where other children
//     hit, a bitstack level is pushed: the parent row, the mask of the
//     others but the second-nearest, the second-nearest child and its blo;
//   * leaf round: 8 Moller-Trumbore tests (|det| > 1e-12, u, v >= 0,
//     u + v <= 1, tnear < t < best t), the lowest slot on equal t;
//   * pop (after a leaf, or a node that descends nowhere): the top level's
//     stored child when its tmin is below best t (direct), else consume it
//     and pop again next round (prune: `_phase` re-runs the row, which
//     changes nothing; here the round is counted and the row is not read
//     again), else re-gather the parent row with the level's mask; an empty
//     stack ends the lane;
//   * a latched lane ends on its first hit; a lane with tfar <= tnear does
//     no work; at most kMaxRounds rounds a lane (16,384); a bitstack of
//     kMaxLevels levels, which a lane never fills: it holds at most depth
//     levels, and GatherBvhPack refuses a pack whose depth + 2 (`_phase`'s
//     L) exceeds kMaxLevels.
// Every product and sum of the slab and leaf arithmetic is rounded on its
// own (__fmul_rn / __fadd_rn / __fsub_rn, which nvcc never contracts into
// fused multiply-adds), min and max propagate NaN (min.NaN / max.NaN: a
// NaN wherever torch.minimum / maximum give one; blo and bhi only enter
// comparisons, so the sign of a zero does not matter), the divisions are
// IEEE (no fast-math), and a triangle's test stops early only where the
// first form's acceptance fails: so t, prim, u and v equal the twin's
// (walk_twin) and the first form's (gather_walk_v1.cu) bit for bit.
//
// What bounds it on the H100: instruction issue, then a tail. A warp runs
// a node round (~400 instructions: 8 slab tests and the choice of two
// children) and a leaf round (~700 for 8 triangle tests, fewer where all its
// lanes stop early) for whichever of its lanes stand at a node or a leaf,
// 20-45% of its lanes; the rows' bytes (224 a node, 320 a leaf, from L1 and
// L2) and the card's f32 rate are far from their limits. Padding each node
// round with 200 independent multiplies cost 15%, an extra row load 6%.
// The last 1% of the lanes then finish in the last third of a call, each of
// their rounds a chain of a row load and its arithmetic. Against the first
// form (124 registers, 4 blocks of 128 a multiprocessor, two dependent loads
// a round, one lane a thread over the whole grid):
//   * one trip to memory a round: a row is a leaf by its id (id >= n_nodes),
//     so no flag is read before the row;
//   * more warps resident: the row is read in two halves (4 children, 4
//     triangles) as the arithmetic needs it, a bitstack level is 12 bytes
//     (the parent row and its mask in one word), child ids stay floats until
//     one is taken, and __launch_bounds__ caps the registers at 80: 6 blocks
//     of 128;
//   * fewer instructions: min.NaN / max.NaN (one instruction each, where the
//     first form's select took three), a pruned pop is counted without
//     re-reading its row, a triangle's test stops at the first condition
//     that fails (empty slot, |det|, u, v);
//   * fuller warps: a persistent grid (the blocks that fit on the card at
//     once) whose threads each take a new lane from a counter when their
//     lane ends, kRefill or more at a time a warp, and a lane at a leaf waits
//     until kLeafWait of its warp's lanes are at leaves (or none is at a
//     node), so a leaf round serves more lanes;
//   * the top of the tree in shared memory: rows [0, top) (top =
//     min(TOP_ROWS, n_nodes): the root and its children) are staged once per
//     resident block, their 14 node pieces at an odd stride of 15 pieces, so
//     the 8 lanes of a quarter-warp on distinct rows fall in distinct banks.
//     Every lane's first round reads the root there. Staging 73 rows (two
//     levels) measured 2-3% slower, none the same as 9.
//
// Plain C interface, loaded with ctypes; the function launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kRow = 84;           // == ROW in ops/gather_bvh.py
constexpr int kPieces = kRow / 4;  // 16-byte pieces a row
constexpr int kNodePieces = 14;    // a node row's boxes and child ids
constexpr int kTopStride = 15;     // a staged row's pieces in shared memory (odd)
constexpr int kTopRows = 9;        // == TOP_ROWS: the root and its 8 children
constexpr int kMaxLevels = 32;     // == MAX_LEVELS
constexpr int kMaxRounds = 16384;  // == MAX_ROUNDS, _traverse's max_rounds
constexpr int kThreads = 128;
constexpr int kMinBlocks = 6;  // resident blocks a multiprocessor: at most 80 registers
constexpr int kRefill = 12;    // a warp takes new lanes once this many of its threads wait
constexpr int kLeafWait = 8;   // a leaf round waits for this many of the warp's lanes
constexpr unsigned kAll = 0xffffffffu;

// NaN-propagating min and max (a NaN wherever torch.minimum / maximum give one)
__device__ __forceinline__ float pmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float pmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
// a * b - c * d and a * x + b * y + c * z, each operation rounded on its own
__device__ __forceinline__ float cross1(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}
__device__ __forceinline__ float dot3(float a, float b, float c, float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), __fmul_rn(c, z));
}
__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

struct Args {
  const float* o;
  const float* d;
  const float* tnear;
  const float* tfar;
  const unsigned char* latch;
  int mode;  // 0 closest hit, 1 every lane latched, 2 latch[i]
  const float4* rows;
  int n_rows, n_nodes, top, root, n;
  int* next;  // the lane counter
  float* out_t;
  long long* out_prim;
  float* out_u;
  float* out_v;
};

__global__ void __launch_bounds__(kThreads, kMinBlocks) gather_walk_kernel(const Args a) {
  extern __shared__ float4 srows[];
  for (int k = threadIdx.x; k < a.top * kNodePieces; k += kThreads) {
    const int r = k / kNodePieces, q = k - r * kNodePieces;
    srows[r * kTopStride + q] = __ldg(a.rows + r * kPieces + q);
  }
  __syncthreads();

  // the thread's lane
  float ox = 0, oy = 0, oz = 0, dx = 0, dy = 0, dz = 0, ix = 0, iy = 0, iz = 0, tnear = 0;
  float best = 0, bu = 0, bv = 0;
  int prim = -1, cur = -1, pend = 0, lvl = 0, round = 0;
  bool latched = false;
  unsigned pm[kMaxLevels];  // parent row << 8 | the mask it keeps (rows < 2^24)
  int nc[kMaxLevels];       // the stored second child, -1 once consumed
  float nt[kMaxLevels];     // its tmin

  auto start = [&](int i) {
    ox = a.o[3 * i], oy = a.o[3 * i + 1], oz = a.o[3 * i + 2];
    dx = a.d[3 * i], dy = a.d[3 * i + 1], dz = a.d[3 * i + 2];
    tnear = a.tnear[i];
    const float tfar = a.tfar[i];
    latched = a.mode == 2 ? a.latch[i] != 0 : a.mode == 1;
    best = tfar, bu = 0.0f, bv = 0.0f;
    prim = -1;
    ix = 1.0f / (dx == 0.0f ? 1e-30f : dx);
    iy = 1.0f / (dy == 0.0f ? 1e-30f : dy);
    iz = 1.0f / (dz == 0.0f ? 1e-30f : dz);
    cur = tfar > tnear ? a.root : -1;
    pend = 0xFF, lvl = 0, round = 0;
  };
  auto finish = [&](int i) {
    a.out_t[i] = best;
    a.out_prim[i] = prim;
    a.out_u[i] = bu;
    a.out_v[i] = bv;
  };

  // A node round on row `rid`; true where it descends nowhere (pop).
  auto node_round = [&](int rid) {
    const bool staged = rid < a.top;  // from shared memory, else from global memory
    const float4* sh = srows + rid * kTopStride;
    const float4* gl = a.rows + (size_t)rid * kPieces;
    auto ld = [&](int q) { return staged ? sh[q] : __ldg(gl + q); };
    float t1 = __int_as_float(0x7f800000), t2 = t1;  // +inf
    float c1 = -1.0f, c2 = -1.0f;  // child ids, whole numbers (GatherBvhPack checks)
    int m1 = 0, m2 = 0, hitbits = 0;  // the nearest's and second nearest's bits, all hits
#pragma unroll
    for (int g = 0; g < 2; ++g) {  // children 4g .. 4g + 3: pieces 2f + g of field f
      const float4 lx = ld(g), ly = ld(2 + g), lz = ld(4 + g);
      const float4 hx = ld(6 + g), hy = ld(8 + g), hz = ld(10 + g);
      const float4 ids = ld(12 + g);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int bit = 1 << (4 * g + k);
        const float t0x = __fmul_rn(__fsub_rn(comp(lx, k), ox), ix);
        const float t1x = __fmul_rn(__fsub_rn(comp(hx, k), ox), ix);
        const float t0y = __fmul_rn(__fsub_rn(comp(ly, k), oy), iy);
        const float t1y = __fmul_rn(__fsub_rn(comp(hy, k), oy), iy);
        const float t0z = __fmul_rn(__fsub_rn(comp(lz, k), oz), iz);
        const float t1z = __fmul_rn(__fsub_rn(comp(hz, k), oz), iz);
        const float blo = pmax(pmax(pmin(t0x, t1x), pmin(t0y, t1y)), pmin(t0z, t1z));
        const float bhi = pmin(pmin(pmax(t0x, t1x), pmax(t0y, t1y)), pmax(t0z, t1z));
        const float code = comp(ids, k);
        if ((pend & bit) && code >= 0.0f && blo <= bhi && bhi >= tnear && blo < best) {
          hitbits |= bit;
          if (blo < t1) {  // nearest and second nearest, the lowest slot on ties
            t2 = t1, m2 = m1, c2 = c1;
            t1 = blo, m1 = bit, c1 = code;
          } else if (blo < t2) {
            t2 = blo, m2 = bit, c2 = code;
          }
        }
      }
    }
    if (m1 == 0) return true;
    const int remaining = hitbits & ~m1;
    if (remaining != 0) {
      if (lvl < kMaxLevels) {
        pm[lvl] = (unsigned)cur << 8 | (unsigned)(remaining & ~m2);
        nc[lvl] = (int)c2;
        nt[lvl] = t2;
      }
      ++lvl;
    }
    cur = (int)c1;
    pend = 0xFF;
    return false;
  };

  // A leaf round on row `rid` (leaves are never staged): the nearest accepted
  // slot updates the hit.
  auto leaf_round = [&](int rid) {
    const float4* gl = a.rows + (size_t)rid * kPieces;
    float tk = __int_as_float(0x7f800000), uk = 0.0f, vk = 0.0f, pk = -1.0f;
#pragma unroll
    for (int g = 0; g < 2; ++g) {  // triangles 4g .. 4g + 3: pieces 2f + g of field f
      const float4 ax = __ldg(gl + g), ay = __ldg(gl + 2 + g), az = __ldg(gl + 4 + g);
      const float4 bx = __ldg(gl + 6 + g), by = __ldg(gl + 8 + g), bz = __ldg(gl + 10 + g);
      const float4 cx = __ldg(gl + 12 + g), cy = __ldg(gl + 14 + g), cz = __ldg(gl + 16 + g);
      const float4 ids = __ldg(gl + 18 + g);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!(comp(ids, k) >= 0.0f)) continue;  // an empty slot
        const float e1x = comp(bx, k), e1y = comp(by, k), e1z = comp(bz, k);
        const float e2x = comp(cx, k), e2y = comp(cy, k), e2z = comp(cz, k);
        const float px = cross1(dy, e2z, dz, e2y);
        const float py = cross1(dz, e2x, dx, e2z);
        const float pz = cross1(dx, e2y, dy, e2x);
        const float det = dot3(e1x, e1y, e1z, px, py, pz);
        if (!(fabsf(det) > 1e-12f)) continue;
        const float inv_det = 1.0f / det;
        const float tx = __fsub_rn(ox, comp(ax, k)), ty = __fsub_rn(oy, comp(ay, k));
        const float tz = __fsub_rn(oz, comp(az, k));
        const float u = __fmul_rn(dot3(tx, ty, tz, px, py, pz), inv_det);
        if (!(u >= 0.0f && u <= 1.0f)) continue;  // else u + v <= 1 fails for every v >= 0
        const float qx = cross1(ty, e1z, tz, e1y);
        const float qy = cross1(tz, e1x, tx, e1z);
        const float qz = cross1(tx, e1y, ty, e1x);
        const float v = __fmul_rn(dot3(dx, dy, dz, qx, qy, qz), inv_det);
        if (!(v >= 0.0f && __fadd_rn(u, v) <= 1.0f)) continue;
        const float t = __fmul_rn(dot3(e2x, e2y, e2z, qx, qy, qz), inv_det);
        if (t > tnear && t < best && t < tk) tk = t, uk = u, vk = v, pk = comp(ids, k);
      }
    }
    if (pk >= 0.0f) {
      best = tk, bu = uk, bv = vk;
      prim = (int)pk;
    }
  };

  // The pop; a pruned level costs one more round and no row. False where the
  // lane ends.
  auto pop = [&]() {
    for (;;) {
      if (lvl == 0) return false;
      const int top = lvl - 1;
      const unsigned top_m = pm[top] & 0xFFu;
      const int c = nc[top];
      if (c < 0) {  // re-gather the parent and re-test its mask
        cur = (int)(pm[top] >> 8);
        pend = (int)top_m;
        --lvl;
        return true;
      }
      const bool direct = nt[top] < best;  // descend straight to the stored child
      nc[top] = -1;
      if (top_m == 0) --lvl;
      if (direct) {
        cur = c;
        pend = 0xFF;
        return true;
      }
      if (++round >= kMaxRounds) return false;
    }
  };

  // One round of the lane; false where it has ended.
  auto step = [&]() {
    const int rid = min(cur, a.n_rows - 1);
    if (rid < a.n_nodes) {
      if (node_round(rid) && !pop()) return false;
    } else {
      leaf_round(rid);
      if (latched && prim >= 0) return false;  // a latched lane ends on its first hit
      if (!pop()) return false;
    }
    return ++round < kMaxRounds;
  };

  const int lane = threadIdx.x & 31;
  int i = -1;  // the thread's lane; >= n once the counter has run out
  bool need = true, walking = false;
  for (;;) {
    // waiting threads take new lanes, kRefill or more at once (or all that
    // wait where none walks), consecutive lanes from the counter
    const unsigned want = __ballot_sync(kAll, need);
    const unsigned busy = __ballot_sync(kAll, walking);
    if (want && (__popc(want) >= kRefill || busy == 0)) {
      const int leader = __ffs(want) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(a.next, __popc(want));
      base = __shfl_sync(kAll, base, leader);
      if (need) {
        i = base + __popc(want & ((1u << lane) - 1));
        need = false;
        if (i < a.n) {
          start(i);
          walking = cur >= 0;
          if (!walking) {
            finish(i);
            need = true;
          }
        }
      }
    }
    if (__ballot_sync(kAll, walking || (need && i < a.n)) == 0) return;
    // a lane at a leaf waits while fewer than kLeafWait of the warp's lanes
    // are at leaves and some are at nodes
    const bool at_leaf = walking && min(cur, a.n_rows - 1) >= a.n_nodes;
    const unsigned leaves = __ballot_sync(kAll, at_leaf);
    const unsigned nodes = __ballot_sync(kAll, walking && !at_leaf);
    const bool go = !at_leaf || __popc(leaves) >= kLeafWait || nodes == 0;
    if (walking && go && !step()) {
      finish(i);
      walking = false;
      need = true;
    }
  }
}

size_t smem_bytes(int top) { return (size_t)top * kTopStride * sizeof(float4); }

// The persistent grid: the blocks that reside on all multiprocessors at once
// with `top` rows staged, cached per device (a race only repeats the query).
int resident_blocks(int top) {
  static std::atomic<int> cache[64][kTopRows + 1];  // 0: not asked yet
  int dev = 0;
  cudaGetDevice(&dev);
  std::atomic<int>* slot = dev < 64 ? &cache[dev][top] : nullptr;
  if (slot && slot->load(std::memory_order_relaxed) > 0)
    return slot->load(std::memory_order_relaxed);
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_walk_kernel, kThreads,
                                                smem_bytes(top));
  if (slot) slot->store(per_sm * sms, std::memory_order_relaxed);
  return per_sm * sms;
}

}  // namespace

// next: one int, the kernel's lane counter, which this function sets to 0
// on the stream; rows [0, min(kTopRows, n_nodes)) are served from shared
// memory.
extern "C" int gather_walk(
    const float* o, const float* d, const float* tnear, const float* tfar,
    const unsigned char* latch, int mode, const float* rows, int n_rows, int n_nodes, int root,
    int n, int* next, float* out_t, long long* out_prim, float* out_u, float* out_v,
    void* stream) {
  if (n <= 0) return 0;
  if (n_nodes < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int top = min(kTopRows, n_nodes);
  const Args a{o, d, tnear, tfar, latch, mode, reinterpret_cast<const float4*>(rows), n_rows,
               n_nodes, top, root, n, next, out_t, out_prim, out_u, out_v};
  const size_t smem = smem_bytes(top);
  const int blocks = min((n + kThreads - 1) / kThreads, max(1, resident_blocks(top)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(next, 0, sizeof(int), s);
  gather_walk_kernel<<<blocks, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_walk_blocks_per_sm(int top) {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gather_walk_kernel, kThreads,
                                                smem_bytes(top));
  return blocks;
}
