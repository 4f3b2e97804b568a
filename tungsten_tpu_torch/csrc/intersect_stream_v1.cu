// Streaming brute-force closest hit with a tile-level chunk cull: the first
// Hopper (sm_90a) form of K2, kept only to be measured against
// intersect_stream.cu in one run on one card (the intersector benchmark's
// walk triv1, chip_smoke.py). Nothing on a render path launches it. The
// suffix _v1 means "the first CUDA form". One block of 256 threads per
// 256-ray tile, one thread per ray.
//
// Replaces the TPU kernel K2: `_mt_kernel` in tungsten_tpu/ops/pallas_intersect.py
// (launched by `_launch`; API intersect_pallas). It computes what K2
// computes; the TPU's sequential grid axis over chunks becomes a loop inside
// the block:
//   * per 2048-triangle chunk, in order, the tile votes with
//     __syncthreads_or: a live ray votes yes when it hits the chunk's AABB
//     with lim = min(tfar, best) (`_mt_kernel`'s slab rule, inv = 1 / (d == 0 ?
//     1e-30 : d); fminf / fmaxf, as the twin's torch.fmin / fmax). A chunk no
//     ray of the tile hits is skipped by the whole tile. Dead rays
//     (tnear >= tfar) and lanes past n vote no;
//   * a chunk that survives is staged through shared memory in slices of 256
//     triangles (9 floats each, read coalesced from the (n_chunks, 2048, 9)
//     copy, stored 12 floats apart so a thread reads one as three float4);
//   * each live thread tests its ray against the staged triangles in index
//     order, Moller-Trumbore with `ray_tri`'s accept rule (|det| > 1e-12,
//     u >= 0, v >= 0, u + v <= 1, t > tnear) and a strict t < min(tfar, best).
//     That gives the TPU kernel's winner: the lowest index among the least t
//     inside a chunk (its argmin), and a strictly smaller t across chunks.
// The arithmetic rounds every product and sum as its own IEEE f32 operation
// (__fmul_rn / __fadd_rn / __fsub_rn, never contracted into fused
// multiply-adds) in `_mt_kernel`'s order, and divides exactly, so t, u and v
// equal the twin's (ops/intersect_stream.py) bit for bit; u = (tv . p) / det
// cancels, and a fused form would differ (bvh_walk.cu). prim is written as
// int32; the TPU kernel carries it as f32, exact only below 2^24 triangles.
//
// What bounds it on the H100: arithmetic. Where a tile votes, each of its 256
// rays runs ~54 f32 operations per triangle, 2048 triangles a chunk, and the
// cull is coarse (incoherent tiles vote for nearly every chunk), so the work
// is close to rays x triangles. The triangle stream is read once per voting
// tile from L2 (the whole scene's 80k triangles are 2.9 MB) and served to the
// tile from shared memory as broadcasts. Finer culls (per warp, per slice) or
// a BVH are what would cut the work; intersect_stream.cu culls per warp and
// per sub-box.
//
// Plain C interface, loaded with ctypes; the function launches on the given
// stream and returns cudaGetLastError(). Built without fast-math.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;    // == RAY_TILE in ops/intersect_stream.py
constexpr int kChunk = 2048;  // == CHUNK
constexpr int kSlice = 256;   // triangles staged per shared-memory slice
constexpr float kInf = 3.0e38f;

// a * b - c * d and a * x + b * y + c * z, each operation rounded on its own
__device__ __forceinline__ float cross1(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}
__device__ __forceinline__ float dot3(float a, float b, float c, float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), __fmul_rn(c, z));
}

__global__ void __launch_bounds__(kTile) intersect_stream_v1_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tnear_in, const float* __restrict__ tfar_in,
    const float* __restrict__ tris,      // (n_chunks * kChunk, 9): v0, e1, e2
    const float* __restrict__ clusters,  // (n_chunks, 8): min3 | max3 | 0 0
    int n_chunks, int n,
    float* __restrict__ out_t, int* __restrict__ out_prim,
    float* __restrict__ out_u, float* __restrict__ out_v) {
  __shared__ float4 s_tri[kSlice * 3];  // [v0 e1.x | e1.yz e2.xy | e2.z - - -]
  float* s_f = reinterpret_cast<float*>(s_tri);
  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool lane = i < n;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float tnear = 0.0f, tfar = 0.0f;
  if (lane) {
    ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    tnear = tnear_in[i];
    tfar = tfar_in[i];
  }
  const bool alive = lane && (tnear < tfar);
  const float ix = 1.0f / (dx == 0.0f ? 1e-30f : dx);
  const float iy = 1.0f / (dy == 0.0f ? 1e-30f : dy);
  const float iz = 1.0f / (dz == 0.0f ? 1e-30f : dz);
  float best = kInf, bu = 0.0f, bv = 0.0f;
  int prim = -1;

  for (int j = 0; j < n_chunks; ++j) {
    const float* cb = clusters + 8 * j;
    const float lim = fminf(tfar, best);
    const float t0x = (__ldg(cb) - ox) * ix, t1x = (__ldg(cb + 3) - ox) * ix;
    const float t0y = (__ldg(cb + 1) - oy) * iy, t1y = (__ldg(cb + 4) - oy) * iy;
    const float t0z = (__ldg(cb + 2) - oz) * iz, t1z = (__ldg(cb + 5) - oz) * iz;
    const float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
    const bool vote = alive && (tmin <= tmax) && (tmax > tnear) && (tmin < lim);
    if (!__syncthreads_or(vote)) continue;  // the whole tile skips the chunk

    for (int s0 = 0; s0 < kChunk; s0 += kSlice) {
      const float* src = tris + ((size_t)j * kChunk + s0) * 9;
      for (int q = threadIdx.x; q < kSlice * 9; q += kTile) {
        const int tri = q / 9;
        s_f[tri * 12 + (q - tri * 9)] = __ldg(src + q);
      }
      __syncthreads();
      if (alive) {
        for (int k = 0; k < kSlice; ++k) {
          const float4 a = s_tri[3 * k], b = s_tri[3 * k + 1], c = s_tri[3 * k + 2];
          const float v0x = a.x, v0y = a.y, v0z = a.z;
          const float e1x = a.w, e1y = b.x, e1z = b.y;
          const float e2x = b.z, e2y = b.w, e2z = c.x;
          const float px = cross1(dy, e2z, dz, e2y);
          const float py = cross1(dz, e2x, dx, e2z);
          const float pz = cross1(dx, e2y, dy, e2x);
          const float det = dot3(e1x, e1y, e1z, px, py, pz);
          if (!(fabsf(det) > 1e-12f)) continue;
          const float inv_det = 1.0f / det;
          const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
          const float u = __fmul_rn(dot3(tvx, tvy, tvz, px, py, pz), inv_det);
          const float qx = cross1(tvy, e1z, tvz, e1y);
          const float qy = cross1(tvz, e1x, tvx, e1z);
          const float qz = cross1(tvx, e1y, tvy, e1x);
          const float v = __fmul_rn(dot3(dx, dy, dz, qx, qy, qz), inv_det);
          const float t = __fmul_rn(dot3(e2x, e2y, e2z, qx, qy, qz), inv_det);
          if ((u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > tnear) &&
              (t < fminf(tfar, best))) {
            best = t;
            bu = u;
            bv = v;
            prim = j * kChunk + s0 + k;
          }
        }
      }
      __syncthreads();  // the slice is read before the next one lands
    }
  }
  if (lane) {
    out_t[i] = best;
    out_prim[i] = prim;
    out_u[i] = bu;
    out_v[i] = bv;
  }
}

}  // namespace

extern "C" int intersect_stream_v1(
    const float* o, const float* d, const float* tnear, const float* tfar,
    const float* tris, const float* clusters, int n_chunks, int n,
    float* out_t, int* out_prim, float* out_u, float* out_v, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kTile - 1) / kTile;
  intersect_stream_v1_kernel<<<blocks, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, tnear, tfar, tris, clusters, n_chunks, n, out_t, out_prim, out_u, out_v);
  return static_cast<int>(cudaGetLastError());
}
