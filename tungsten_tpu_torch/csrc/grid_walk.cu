// The exact voxel DDA, redesigned for Hopper (sm_90a): K6, a group of four
// threads a walking lane, the lane's rounds four at a time.
//
// Replaces the JAX package's exact cell walk `_dda_cells` with the folds of
// `grid_optical_depth` and `_grid_inverse_exact`
// (tungsten_tpu/models/grids/grid.py:156-197, 216-230, 256-290): an XLA
// lax.while_loop, not Pallas, that advances every lane one interpolation
// cell a round. This kernel computes what that loop computes, from the
// wrapper's per-lane ray in grid coordinates (oq, dq: grid point = oq + dq t)
// and its clipped span [ta, tb] (ops/grid_walk.py):
//   * a round steps to the next boundary of the dual cells (boundaries at
//     half-integers, trilinear sampling) or of the data cells (integers,
//     nearest), at least 1e-6 beyond the current t and at most tb; an axis
//     with |dq| < 1e-12 never wins;
//   * it adds the cell's exact optical depth: two Gauss-Legendre nodes of
//     the trilinear field (exact for the cubic the field is along a line),
//     or the midpoint of a nearest cell;
//   * mode 0 ("tau") returns the sum over [ta, tb]; mode 1 ("inverse") stops
//     in the first cell where the sum reaches the target, runs 24 bisection
//     rounds on that cell's exact integral and returns t, or INF (3e38) where
//     the target is never reached;
//   * at most kMaxRounds (4,096) rounds a lane, the JAX loop's backstop;
//   * a lane whose mask byte is 0, or whose span is empty (tb <= ta), walks
//     no round and returns 0 (tau) or INF (inverse).
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn /
// __fsub_rn, which nvcc never contracts into fused multiply-adds), in the
// twin's order (walk_twin, segment_tau, sample_linear: the corners in z, y,
// x order, each weight (wx wy) wz, the sum started from the first corner);
// the fold tau + dt runs in round order. So the kernel equals the twin, and
// grid_walk_v1.cu, bit for bit.
//
// What bounds it on the H100: counted as the bound counts it, the f32
// operations (chip_smoke.py k6_bound, constants tallied from
// grid_walk_v1.cu: 141 a round, 110 a bisection round): the cloud render's
// largest launch walks 60,369 of its 563,000 lanes, ~170 rounds each.
// What bounds it in fact is latency: each round's boundary depends on the
// last, its corner loads on its boundary, and only ~60,000 lanes walk, so a
// thread a lane leaves the card with too few independent instructions (the
// first form, a thread per lane over all 563,000 lanes, most warps holding
// 3-4 walking threads, took 0.77-0.87 ms there; a variant with loads
// confined to 64 KB ran as slowly as the real one, one without loads twice
// as fast). This design:
//   * pass 1 (grid_walk_list_kernel): the walking lanes, compacted on the
//     card into a list (a ballot and one atomic a warp, near lane order, so
//     neighbouring pixels walk together); the other lanes get their 0 or INF;
//   * pass 2 (grid_walk_kernel): kGroup (4) threads a listed lane, four
//     times the independent work in flight. Each step, every thread of the
//     group computes the same four boundaries ahead (the 34 operations of
//     a round, no loads, identical arithmetic, so the sequence of t is the
//     twin's), thread j evaluates round j's segment (its Gauss nodes share
//     one cell's 8 corner loads), and every thread folds the four depths in
//     round order through shuffles, finding the inverse's first crossing.
//     The found lanes' bisection evaluates a 2-level tree of midpoints a
//     step (3 threads), 12 steps for the 24 rounds, each midpoint the one
//     the serial rounds would take.
// A warp a lane (32 rounds ahead on every thread) repeats the 34-operation
// step 32 times for one lane and ran no faster than the first form; groups
// of 2 and 8 ran 3-20% slower than 4, and 128-bit loads of corner pairs
// slower than scalar loads (the card's measurements in PERF.md §6).
// ptxas -v (sm_90a): the walk 72 registers, no stack, no spills; the list
// pass 13; resident blocks in chip_smoke.py's phase 2.
//
// Plain C interface, loaded with ctypes; grid_walk() launches the two passes
// on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxRounds = 4096;  // == MAX_ROUNDS in ops/grid_walk.py
constexpr int kBisect = 24;       // == BISECT_ROUNDS
constexpr int kGroup = 4;         // == GROUP: threads a lane, rounds a step (divides kMaxRounds)
constexpr int kDepth = 2;  // bisection rounds a step: 2^kDepth - 1 <= kGroup, divides kBisect
constexpr int kThreads = 128;
constexpr int kListThreads = 256;
constexpr float kInf = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
// torch.minimum / maximum: NaN propagates
__device__ __forceinline__ float pmin(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float pmax(float a, float b) { return (a > b || a != a) ? a : b; }

struct Grid {
  const float* __restrict__ density;  // (nz, ny, nx)
  int nx, ny, nz;
  bool linear;
  float g0, g1;  // the Gauss node offsets
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

__device__ __forceinline__ float sample_nearest(const Grid& g, float qx, float qy, float qz) {
  const int ix = clampi(static_cast<int>(qx), 0, g.nx - 1);
  const int iy = clampi(static_cast<int>(qy), 0, g.ny - 1);
  const int iz = clampi(static_cast<int>(qz), 0, g.nz - 1);
  const bool inside = qx >= 0.0f && qx < static_cast<float>(g.nx) && qy >= 0.0f &&
                      qy < static_cast<float>(g.ny) && qz >= 0.0f && qz < static_cast<float>(g.nz);
  return inside ? __ldg(g.density + (static_cast<long long>(iz) * g.ny + iy) * g.nx + ix) : 0.0f;
}

// a trilinear sample's cell: the corner below q - 0.5 and the fraction
__device__ __forceinline__ void dual_cell(float q, int& i0, float& f) {
  const float c = sub(q, 0.5f);
  i0 = static_cast<int>(floorf(c));
  f = sub(c, static_cast<float>(i0));
}

// the 8 corner values of the dual cell at (x0, y0, z0), 0 outside the
// grid, in z, y, x order
__device__ __forceinline__ void load_corners(const Grid& g, int x0, int y0, int z0, float v[8]) {
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int ix = x0 + dx, iy = y0 + dy, iz = z0 + dz;
        const bool inb = ix >= 0 && ix < g.nx && iy >= 0 && iy < g.ny && iz >= 0 && iz < g.nz;
        v[dz * 4 + dy * 2 + dx] =
            inb ? __ldg(g.density + (static_cast<long long>(iz) * g.ny + iy) * g.nx + ix) : 0.0f;
      }
    }
  }
}

// the trilinear sum of a cell's corners: the corners in z, y, x order,
// each weight (wx wy) wz, the sum started from the first corner
__device__ __forceinline__ float trilinear(const float v[8], float fx, float fy, float fz) {
  float out = 0.0f;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const float wx = dx ? fx : sub(1.0f, fx);
        const float wy = dy ? fy : sub(1.0f, fy);
        const float wz = dz ? fz : sub(1.0f, fz);
        const float term = mul(v[dz * 4 + dy * 2 + dx], mul(mul(wx, wy), wz));
        out = dz == 0 && dy == 0 && dx == 0 ? term : add(out, term);
      }
    }
  }
  return out;
}

// the exact optical depth of [ta, tb] inside one interpolation cell; the
// two Gauss nodes share their cell's corners (loaded again only where
// rounding puts the nodes in different cells)
__device__ __forceinline__ float segment_tau(const Grid& g, float ta, float tb, const float oq[3],
                                             const float dq[3]) {
  const float h = sub(tb, ta);
  if (g.linear) {
    const float t0 = add(ta, mul(h, g.g0)), t1 = add(ta, mul(h, g.g1));
    int c0[3], c1[3];
    float f0[3], f1[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dual_cell(add(oq[k], mul(dq[k], t0)), c0[k], f0[k]);
      dual_cell(add(oq[k], mul(dq[k], t1)), c1[k], f1[k]);
    }
    float v0[8], v1[8];
    load_corners(g, c0[0], c0[1], c0[2], v0);
    if (c1[0] == c0[0] && c1[1] == c0[1] && c1[2] == c0[2]) {
#pragma unroll
      for (int k = 0; k < 8; ++k) v1[k] = v0[k];
    } else {
      load_corners(g, c1[0], c1[1], c1[2], v1);
    }
    const float s0 = trilinear(v0, f0[0], f0[1], f0[2]);
    const float s1 = trilinear(v1, f1[0], f1[1], f1[2]);
    return mul(mul(0.5f, h), add(s0, s1));
  }
  const float t = add(ta, mul(0.5f, h));
  return mul(h, sample_nearest(g, add(oq[0], mul(dq[0], t)), add(oq[1], mul(dq[1], t)),
                               add(oq[2], mul(dq[2], t))));
}

struct Ray {
  float oq[3], dq[3], inv[3];
  bool small[3];
};

// one round's boundary: the next cell boundary after t, at least 1e-6
// beyond it, at most tb (the twin's step, operation for operation)
__device__ __forceinline__ float boundary(const Ray& R, float shift, float t, float tb) {
  float tn = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float q = sub(add(R.oq[k], mul(R.dq[k], t)), shift);
    const float stepped = R.dq[k] > 0.0f ? add(floorf(q), 1.0f) : sub(ceilf(q), 1.0f);
    float tk = mul(sub(add(stepped, shift), R.oq[k]), R.inv[k]);
    if (R.small[k]) tk = 3.0e37f;
    tn = k == 0 ? tk : pmin(tn, tk);
  }
  tn = pmax(tn, add(t, 1e-6f));
  return pmin(tn, tb);
}

// pass 1: the lanes that walk (mask byte set, tb > ta not known false), in
// a list; every other lane's result written here
__global__ void __launch_bounds__(kListThreads) grid_walk_list_kernel(
    const float* __restrict__ ta, const float* __restrict__ tb,
    const unsigned char* __restrict__ mask, int n, int inverse, float* __restrict__ out,
    int* __restrict__ list, int* __restrict__ count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool walks = false;
  if (i < n) {
    walks = (mask == nullptr || mask[i] != 0) && !(tb[i] <= ta[i]);
    if (!walks) out[i] = inverse ? kInf : 0.0f;
  }
  const unsigned bal = __ballot_sync(kFull, walks);
  if (bal == 0) return;
  const int lane = threadIdx.x & 31, leader = __ffs(bal) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(bal));
  base = __shfl_sync(kFull, base, leader);
  if (walks) list[base + __popc(bal & ((1u << lane) - 1u))] = i;
}

// pass 2: a group of kGroup threads a listed lane
__global__ void __launch_bounds__(kThreads) grid_walk_kernel(
    Grid g, const float* __restrict__ oq_in, const float* __restrict__ dq_in,
    const float* __restrict__ ta_in, const float* __restrict__ tb_in,
    const float* __restrict__ target_in, int inverse, const int* __restrict__ list,
    const int* __restrict__ count, float* __restrict__ out) {
  const int slot = (blockIdx.x * kThreads + threadIdx.x) / kGroup;
  const int j = threadIdx.x % kGroup;
  const int base = (threadIdx.x & 31) / kGroup * kGroup;
  const unsigned gmask = ((1u << kGroup) - 1u) << base;
  if (slot >= *count) return;  // the whole group
  const int lane = list[slot];
  Ray R;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    R.oq[k] = oq_in[3 * lane + k];
    R.dq[k] = dq_in[3 * lane + k];
    R.small[k] = fabsf(R.dq[k]) < 1e-12f;
    R.inv[k] = 1.0f / (R.small[k] ? 1e-12f : R.dq[k]);
  }
  const float shift = g.linear ? 0.5f : 0.0f;
  const float tb = tb_in[lane];
  const float target = inverse ? target_in[lane] : 0.0f;
  float t = ta_in[lane];
  float tau = 0.0f, seg_a = 0.0f, seg_b = 0.0f, tau_at_a = 0.0f;
  bool found = false, done = false;
  int rounds = 0;
  while (!done) {
    float tas[kGroup], tns[kGroup];
    bool use[kGroup];
    float tt = t;
    bool go = true;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      use[u] = go && rounds + u < kMaxRounds;
      const float tn = boundary(R, shift, tt, tb);
      tas[u] = tt;
      tns[u] = tn;
      if (use[u] && tn > tt) tt = tn;
      if (tn >= tb) go = false;
    }
    float my_a = tas[0], my_n = tns[0];
    bool my_use = use[0];
#pragma unroll
    for (int u = 1; u < kGroup; ++u) {
      if (j == u) {
        my_a = tas[u];
        my_n = tns[u];
        my_use = use[u];
      }
    }
    const float mine = my_use && my_n > my_a ? segment_tau(g, my_a, my_n, R.oq, R.dq) : 0.0f;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const float dtu = __shfl_sync(gmask, mine, u, kGroup);
      if (!use[u] || done) continue;
      const float t_next = tns[u];
      const bool live = t_next > t;
      const float dt = live ? dtu : 0.0f;
      bool new_done = t_next >= tb;
      if (inverse && live && !found && add(tau, dt) >= target) {
        seg_a = t;
        seg_b = t_next;
        tau_at_a = tau;
        found = true;
      }
      if (inverse) new_done = new_done || found;
      tau = add(tau, dt);
      if (live) t = t_next;
      ++rounds;
      done = new_done;
    }
    if (rounds >= kMaxRounds) done = true;
  }
  if (!inverse || !found) {
    if (j == 0) out[lane] = inverse ? kInf : tau;
    return;
  }
  float lo = seg_a, hi = seg_b;
  for (int r = 0; r < kBisect; r += kDepth) {
    bool mine_hi = false;
    if (j < (1 << kDepth) - 1) {
      const int k = j + 1, depth = 31 - __clz(k);
      float l = lo, h = hi;
      for (int b = depth - 1; b >= 0; --b) {
        const float mid = mul(0.5f, add(l, h));
        if ((k >> b) & 1) l = mid; else h = mid;
      }
      const float mid = mul(0.5f, add(l, h));
      mine_hi = add(tau_at_a, segment_tau(g, seg_a, mid, R.oq, R.dq)) < target;
    }
    const unsigned votes = __ballot_sync(gmask, mine_hi) >> base;
    int k = 1;
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const bool go_hi = (votes >> (k - 1)) & 1u;
      const float mid = mul(0.5f, add(lo, hi));
      if (go_hi) lo = mid; else hi = mid;
      k = 2 * k + (go_hi ? 1 : 0);
    }
  }
  if (j == 0) out[lane] = mul(0.5f, add(lo, hi));
}

}  // namespace

// list: int32 scratch of n entries; count: one int32 (zeroed here)
extern "C" int grid_walk(const float* density, int nx, int ny, int nz, int linear,
                         const float* oq, const float* dq, const float* ta, const float* tb,
                         const float* target, const unsigned char* mask, int mode, float g0,
                         float g1, int n, float* out, int* list, int* count, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(count, 0, sizeof(int), st);
  grid_walk_list_kernel<<<(n + kListThreads - 1) / kListThreads, kListThreads, 0, st>>>(
      ta, tb, mask, n, mode, out, list, count);
  const Grid g{density, nx, ny, nz, linear != 0, g0, g1};
  const long long threads = static_cast<long long>(n) * kGroup;  // at most: a group a lane
  grid_walk_kernel<<<static_cast<int>((threads + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      g, oq, dq, ta, tb, target, mode, list, count, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int grid_walk_blocks_per_sm() {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, grid_walk_kernel, kThreads, 0);
  return blocks;
}
