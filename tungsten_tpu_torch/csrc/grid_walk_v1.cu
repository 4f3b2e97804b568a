// The first CUDA form of K6, one thread per lane, kept only to be measured
// against grid_walk.cu in one run on one card (chip_smoke.py phase 12, the
// `cuda`-marked tests). Nothing on a render path launches it; its wrapper is
// `walk_cuda_v1` in ops/grid_walk.py. Its exported names end in _v1; the rest
// is the first form's source unchanged.
//
// The exact voxel DDA, one thread per lane: the first Hopper (sm_90a) form of K6.
//
// Replaces the JAX package's exact cell walk `_dda_cells` with the folds of
// `grid_optical_depth` and `_grid_inverse_exact`
// (tungsten_tpu/models/grids/grid.py:156-197, 216-230, 256-290): an XLA
// lax.while_loop, not Pallas, that advances every lane one interpolation
// cell a round. This kernel computes what that loop computes, per thread,
// from the wrapper's per-lane ray in grid coordinates (oq, dq: grid point =
// oq + dq t) and its clipped span [ta, tb] (ops/grid_walk.py):
//   * a round steps to the next boundary of the dual cells (boundaries at
//     half-integers, trilinear sampling) or of the data cells (integers,
//     nearest), at least 1e-6 beyond the current t and at most tb; an axis
//     with |dq| < 1e-12 never wins;
//   * it adds the cell's exact optical depth: two Gauss-Legendre nodes of
//     the trilinear field (8 corner loads each; exact for the cubic the
//     field is along a line), or the midpoint of a nearest cell;
//   * mode 0 ("tau") returns the sum over [ta, tb]; mode 1 ("inverse") stops
//     in the first cell where the sum reaches the target, runs 24 bisection
//     rounds on that cell's exact integral and returns t, or INF (3e38) where
//     the target is never reached;
//   * at most kMaxRounds (4,096) rounds a lane, the JAX loop's backstop: a
//     lane of the lockstep loop walks exactly as long as it does alone;
//   * a lane whose mask byte is 0 does nothing and returns 0 (tau) or INF
//     (inverse): those lanes belong to another medium, whose values the JAX
//     package computes and discards with `where`.
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn /
// __fsub_rn, which nvcc never contracts into fused multiply-adds), in the
// twin's order (walk_twin, segment_tau, sample_linear: the corners in z, y,
// x order, each weight (wx wy) wz, the sum started from the first corner);
// floor, ceil, the truncating float-to-int casts and the IEEE divisions are
// exact; the Gauss offsets come from the wrapper as the twin's f32 values.
// So the kernel equals the twin bit for bit.
//
// Its bound on the H100 (the larger of two terms, with the rounds counted
// by the twin on the same lanes): the bytes a launch must move, the grid
// once (a grid below 50 MB stays in L2 after its first touch, so every
// later corner load is an L2 hit) plus the lanes' inputs and output, over
// 3.35 TB/s; and the operations, counted from this body (an add, sub, mul,
// divide, floor, min, max or comparison counting one): 9 a walking lane,
// 141 a round on the linear path (the boundary step 34, segment_tau 106,
// the fold 1; an inverse round's crossing test 1 more), 110 a bisection
// round, over 67 TFLOP/s. The operations bind: the cloud render's lanes
// through media-synth's 192^3 grid do ~170 rounds each, ~24,000 f32
// operations against ~550 bytes a walking lane, its share of the grid
// included. The walk runs far from that
// bound: each round's 16 loads depend on the round's boundary, and the
// lanes of a warp cross different numbers of cells, so warps diverge and
// idle. Later forms (ROADMAP): a warp per ray segment, the grid in a 3D
// texture.
//
// Plain C interface, loaded with ctypes; the function launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxRounds = 4096;  // == MAX_ROUNDS in ops/grid_walk.py
constexpr int kBisect = 24;       // == BISECT_ROUNDS
constexpr int kThreads = 128;
constexpr float kInf = 3.0e38f;

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

__device__ __forceinline__ float sample_linear(const Grid& g, float qx, float qy, float qz) {
  const float cx = sub(qx, 0.5f), cy = sub(qy, 0.5f), cz = sub(qz, 0.5f);
  const int x0 = static_cast<int>(floorf(cx)), y0 = static_cast<int>(floorf(cy)),
            z0 = static_cast<int>(floorf(cz));
  const float fx = sub(cx, static_cast<float>(x0)), fy = sub(cy, static_cast<float>(y0)),
              fz = sub(cz, static_cast<float>(z0));
  float out = 0.0f;
  bool first = true;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int ix = x0 + dx, iy = y0 + dy, iz = z0 + dz;
        const bool inb = ix >= 0 && ix < g.nx && iy >= 0 && iy < g.ny && iz >= 0 && iz < g.nz;
        const float v = inb ? __ldg(g.density + (static_cast<long long>(iz) * g.ny + iy) * g.nx + ix)
                            : 0.0f;
        const float wx = dx ? fx : sub(1.0f, fx);
        const float wy = dy ? fy : sub(1.0f, fy);
        const float wz = dz ? fz : sub(1.0f, fz);
        const float term = mul(v, mul(mul(wx, wy), wz));
        out = first ? term : add(out, term);
        first = false;
      }
    }
  }
  return out;
}

// the exact optical depth of [ta, tb] inside one interpolation cell
__device__ __forceinline__ float segment_tau(const Grid& g, float ta, float tb, const float oq[3],
                                             const float dq[3]) {
  const float h = sub(tb, ta);
  if (g.linear) {
    const float t0 = add(ta, mul(h, g.g0));
    const float s0 = sample_linear(g, add(oq[0], mul(dq[0], t0)), add(oq[1], mul(dq[1], t0)),
                                   add(oq[2], mul(dq[2], t0)));
    const float t1 = add(ta, mul(h, g.g1));
    const float s1 = sample_linear(g, add(oq[0], mul(dq[0], t1)), add(oq[1], mul(dq[1], t1)),
                                   add(oq[2], mul(dq[2], t1)));
    return mul(mul(0.5f, h), add(s0, s1));
  }
  const float t = add(ta, mul(0.5f, h));
  return mul(h, sample_nearest(g, add(oq[0], mul(dq[0], t)), add(oq[1], mul(dq[1], t)),
                               add(oq[2], mul(dq[2], t))));
}

__global__ void __launch_bounds__(kThreads) grid_walk_kernel(
    Grid g, const float* __restrict__ oq_in, const float* __restrict__ dq_in,
    const float* __restrict__ ta_in, const float* __restrict__ tb_in,
    const float* __restrict__ target_in, const unsigned char* __restrict__ mask, int mode, int n,
    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool inverse = mode == 1;
  if (mask != nullptr && mask[i] == 0) {
    out[i] = inverse ? kInf : 0.0f;
    return;
  }
  float oq[3], dq[3], inv[3];
  bool small[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    oq[k] = oq_in[3 * i + k];
    dq[k] = dq_in[3 * i + k];
    small[k] = fabsf(dq[k]) < 1e-12f;
    inv[k] = 1.0f / (small[k] ? 1e-12f : dq[k]);
  }
  const float shift = g.linear ? 0.5f : 0.0f;
  const float tb = tb_in[i];
  const float target = inverse ? target_in[i] : 0.0f;
  float t = ta_in[i];
  float tau = 0.0f, seg_a = 0.0f, seg_b = 0.0f, tau_at_a = 0.0f;
  bool found = false;
  bool done = tb <= t;
  for (int round = 0; round < kMaxRounds && !done; ++round) {
    float tn = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float q = sub(add(oq[k], mul(dq[k], t)), shift);
      const float stepped = dq[k] > 0.0f ? add(floorf(q), 1.0f) : sub(ceilf(q), 1.0f);
      float tk = mul(sub(add(stepped, shift), oq[k]), inv[k]);
      if (small[k]) tk = 3.0e37f;
      tn = k == 0 ? tk : pmin(tn, tk);
    }
    tn = pmax(tn, add(t, 1e-6f));
    const float t_next = pmin(tn, tb);
    const bool live = t_next > t;
    const float dt = live ? segment_tau(g, t, t_next, oq, dq) : 0.0f;
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
    done = new_done;
  }
  if (!inverse) {
    out[i] = tau;
    return;
  }
  if (!found) {
    out[i] = kInf;
    return;
  }
  float lo = seg_a, hi = seg_b;
  for (int r = 0; r < kBisect; ++r) {
    const float mid = mul(0.5f, add(lo, hi));
    const bool go_hi = add(tau_at_a, segment_tau(g, seg_a, mid, oq, dq)) < target;
    if (go_hi) lo = mid; else hi = mid;
  }
  out[i] = mul(0.5f, add(lo, hi));
}

}  // namespace

extern "C" int grid_walk_v1(const float* density, int nx, int ny, int nz, int linear,
                            const float* oq, const float* dq, const float* ta, const float* tb,
                            const float* target, const unsigned char* mask, int mode, float g0,
                            float g1, int n, float* out, void* stream) {
  if (n <= 0) return 0;
  Grid g{density, nx, ny, nz, linear != 0, g0, g1};
  const int blocks = (n + kThreads - 1) / kThreads;
  grid_walk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, oq, dq, ta, tb, target, mask, mode, n, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int grid_walk_v1_blocks_per_sm() {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, grid_walk_kernel, kThreads, 0);
  return blocks;
}
