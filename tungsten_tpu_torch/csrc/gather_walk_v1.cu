// The first CUDA form of K1, one thread per lane, kept only to be measured
// against gather_walk.cu in one run on one card (chip_smoke.py phase 3e, the
// `cuda`-marked tests). Nothing on a render path launches it; its wrapper is
// `walk_cuda_v1` in ops/gather_bvh.py. Its exported names end in _v1; the rest
// is the first form's source, but for one line of this comment.
//
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
//     layout), read as 16-byte pieces, one row a round: a node's boxes and
//     child ids (56 floats), or a leaf's 8 triangles and prim ids (80);
//   * node round: the slab tests of the pending children (pend bit set,
//     child id >= 0, blo <= bhi, bhi >= tnear, blo < best t), the nearest by
//     blo (the lowest slot on ties) becomes the cursor; where other children
//     hit, a bitstack level is pushed: the parent row, the mask of the
//     others but the second-nearest, the second-nearest child and its blo;
//   * leaf round: 8 Moller-Trumbore tests (|det| > 1e-12, u, v >= 0,
//     u + v <= 1, tnear < t < best t), the lowest slot on equal t;
//   * pop (after a leaf, or a node that descends nowhere): the top level's
//     stored child when its tmin is below best t (direct), else consume it
//     and pop again next round with the row unchanged (prune: `_phase`
//     re-runs the row, which changes nothing), else re-gather the parent row
//     with the level's mask; an empty stack ends the lane;
//   * a latched lane ends on its first hit; a lane with tfar <= tnear does
//     no work; at most kMaxRounds rounds a lane (16,384).
// The bitstack lives in local memory, kMaxLevels levels; GatherBvhPack
// refuses a tree whose depth + 2 exceeds it. Every product and sum of the
// slab and leaf arithmetic is rounded on its own (__fmul_rn / __fadd_rn /
// __fsub_rn, which nvcc never contracts into fused multiply-adds), min and
// max propagate NaN as torch.minimum / maximum do, and the divisions are
// IEEE (no fast-math): so t, prim, u and v equal the twin's (walk_twin) bit
// for bit.
//
// What bounds it on the H100: the dependent row loads of a divergent walk
// (each round waits on its row, 224-320 bytes, from L2: an 80,000-triangle
// pack is ~6 MB), and the divergence of a warp whose lanes sit at node and
// leaf rounds at once. The pack's bytes and the rounds' arithmetic are far
// below the card's rates. gather_walk.cu is the form that followed.
//
// Plain C interface, loaded with ctypes; the function launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kRow = 84;        // == ROW in ops/gather_bvh.py
constexpr int kFlag = 80;       // COL_FLAG
constexpr int kMaxLevels = 32;  // == MAX_LEVELS
constexpr int kMaxRounds = 16384;  // == MAX_ROUNDS, _traverse's max_rounds
constexpr int kThreads = 128;

// torch.minimum / maximum: NaN propagates (fminf / fmaxf would drop it)
__device__ __forceinline__ float pmin(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float pmax(float a, float b) { return (a > b || a != a) ? a : b; }
// a * b - c * d and a * x + b * y + c * z, each operation rounded on its own
__device__ __forceinline__ float cross1(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}
__device__ __forceinline__ float dot3(float a, float b, float c, float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), __fmul_rn(c, z));
}

__global__ void __launch_bounds__(kThreads) gather_walk_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tnear_in, const float* __restrict__ tfar_in,
    const unsigned char* __restrict__ latch_in, int mode,
    const float4* __restrict__ rows, int n_rows, int root, int n,
    float* __restrict__ out_t, int* __restrict__ out_prim,
    float* __restrict__ out_u, float* __restrict__ out_v) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float tnear = tnear_in[i];
  const float tfar = tfar_in[i];
  const bool latched = mode == 2 ? latch_in[i] != 0 : mode == 1;
  float best = tfar, bu = 0.0f, bv = 0.0f;
  int prim = -1;
  const float ix = 1.0f / (dx == 0.0f ? 1e-30f : dx);
  const float iy = 1.0f / (dy == 0.0f ? 1e-30f : dy);
  const float iz = 1.0f / (dz == 0.0f ? 1e-30f : dz);

  int pid[kMaxLevels], pmask[kMaxLevels], nc[kMaxLevels];
  float nt[kMaxLevels];
  int cur = tfar > tnear ? root : -1;
  int pend = 0xFF, lvl = 0;
  for (int round = 0; round < kMaxRounds && cur >= 0; ++round) {
    const float4* row = rows + (size_t)min(cur, n_rows - 1) * (kRow / 4);
    const bool is_leaf = __ldg(row + kFlag / 4).x > 0.5f;
    bool pop;
    if (!is_leaf) {
      float r[56];
#pragma unroll
      for (int q = 0; q < 14; ++q) {
        const float4 v = __ldg(row + q);
        r[4 * q] = v.x, r[4 * q + 1] = v.y, r[4 * q + 2] = v.z, r[4 * q + 3] = v.w;
      }
      float t1 = __int_as_float(0x7f800000), t2 = t1;  // +inf
      int s1 = 8, s2 = 8, c1 = -1, c2 = -1, hitbits = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float t0x = __fmul_rn(__fsub_rn(r[j], ox), ix);
        const float t1x = __fmul_rn(__fsub_rn(r[24 + j], ox), ix);
        const float t0y = __fmul_rn(__fsub_rn(r[8 + j], oy), iy);
        const float t1y = __fmul_rn(__fsub_rn(r[32 + j], oy), iy);
        const float t0z = __fmul_rn(__fsub_rn(r[16 + j], oz), iz);
        const float t1z = __fmul_rn(__fsub_rn(r[40 + j], oz), iz);
        const float blo = pmax(pmax(pmin(t0x, t1x), pmin(t0y, t1y)), pmin(t0z, t1z));
        const float bhi = pmin(pmin(pmax(t0x, t1x), pmax(t0y, t1y)), pmax(t0z, t1z));
        const int code = (int)r[48 + j];
        const bool h = ((pend >> j) & 1) && code >= 0 && blo <= bhi && bhi >= tnear &&
                       blo < best;
        if (h) {
          hitbits |= 1 << j;
          if (blo < t1) {  // nearest and second nearest, the lowest slot on ties
            t2 = t1, s2 = s1, c2 = c1;
            t1 = blo, s1 = j, c1 = code;
          } else if (blo < t2) {
            t2 = blo, s2 = j, c2 = code;
          }
        }
      }
      if (s1 < 8) {
        const int remaining = hitbits & ~(1 << s1);
        if (remaining != 0) {
          if (lvl < kMaxLevels) {
            pid[lvl] = cur;
            pmask[lvl] = remaining & ~(1 << s2);
            nc[lvl] = c2;
            nt[lvl] = t2;
          }
          ++lvl;
        }
        cur = c1;
        pend = 0xFF;
        pop = false;
      } else {
        pop = true;
      }
    } else {
      float r[80];
#pragma unroll
      for (int q = 0; q < 20; ++q) {
        const float4 v = __ldg(row + q);
        r[4 * q] = v.x, r[4 * q + 1] = v.y, r[4 * q + 2] = v.z, r[4 * q + 3] = v.w;
      }
      float tk = __int_as_float(0x7f800000), uk = 0.0f, vk = 0.0f;
      int sk = -1, pk = -1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float e1x = r[24 + j], e1y = r[32 + j], e1z = r[40 + j];
        const float e2x = r[48 + j], e2y = r[56 + j], e2z = r[64 + j];
        const float px = cross1(dy, e2z, dz, e2y);
        const float py = cross1(dz, e2x, dx, e2z);
        const float pz = cross1(dx, e2y, dy, e2x);
        const float det = dot3(e1x, e1y, e1z, px, py, pz);
        if (!(r[72 + j] >= 0.0f) || !(fabsf(det) > 1e-12f)) continue;
        const float inv_det = 1.0f / det;
        const float tx = __fsub_rn(ox, r[j]), ty = __fsub_rn(oy, r[8 + j]);
        const float tz = __fsub_rn(oz, r[16 + j]);
        const float u = __fmul_rn(dot3(tx, ty, tz, px, py, pz), inv_det);
        const float qx = cross1(ty, e1z, tz, e1y);
        const float qy = cross1(tz, e1x, tx, e1z);
        const float qz = cross1(tx, e1y, ty, e1x);
        const float v = __fmul_rn(dot3(dx, dy, dz, qx, qy, qz), inv_det);
        const float t = __fmul_rn(dot3(e2x, e2y, e2z, qx, qy, qz), inv_det);
        if (u >= 0.0f && v >= 0.0f && __fadd_rn(u, v) <= 1.0f && t > tnear && t < best &&
            t < tk) {
          tk = t, uk = u, vk = v, sk = j, pk = (int)r[72 + j];
        }
      }
      if (sk >= 0) {
        best = tk, bu = uk, bv = vk;
        prim = pk;
      }
      if (latched && prim >= 0) break;  // a latched lane ends on its first hit
      pop = true;
    }
    if (!pop) continue;
    if (lvl == 0) {
      cur = -1;
      continue;
    }
    const int top = lvl - 1;
    const int top_m = pmask[top];
    if (nc[top] >= 0) {
      if (nt[top] < best) {  // direct: descend straight to the stored child
        cur = nc[top];
        pend = 0xFF;
      }  // else prune: the row re-runs next round, as in `_phase`
      nc[top] = -1;
      if (top_m == 0) --lvl;
    } else {  // re-gather the parent and re-test its mask
      cur = pid[top];
      pend = top_m;
      --lvl;
    }
  }
  out_t[i] = best;
  out_prim[i] = prim;
  out_u[i] = bu;
  out_v[i] = bv;
}

}  // namespace

extern "C" int gather_walk_v1(
    const float* o, const float* d, const float* tnear, const float* tfar,
    const unsigned char* latch, int mode, const float* rows, int n_rows, int root, int n,
    float* out_t, int* out_prim, float* out_u, float* out_v, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  gather_walk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, tnear, tfar, latch, mode, reinterpret_cast<const float4*>(rows), n_rows, root, n,
      out_t, out_prim, out_u, out_v);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_walk_v1_blocks_per_sm() {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gather_walk_kernel, kThreads, 0);
  return blocks;
}
