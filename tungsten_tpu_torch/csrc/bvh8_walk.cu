// BVH8 walk for Hopper (sm_90a): one thread per ray, a private stack per
// thread, closest-hit / any-hit / mixed through a per-ray latch.
//
// Replaces the TPU kernel K3: `_walk_kernel8` in tungsten_tpu/ops/pallas_bvh8.py
// (launched by `_launch8`; APIs intersect_bvh_pallas8 / occluded_bvh_pallas8).
// It computes what K3 computes with fast=False, not block by block:
//   * node visit: slab-test the node's 8 child boxes with exactly K3's rule
//     (tmin <= tmax) & (tmax > tnear) & (tmin < min(tfar, best)) & (tnear < tfar),
//     inv = 1 / (d == 0 ? 1e-30 : d);
//   * push the hit children far-to-near by the node's per-octant order word
//     (3 bits per slot, slot k = 7 pushed first, k = 0 last, so the nearest
//     child pops first). The octant comes from the ray's own direction signs
//     (x<<2 | y<<1 | z); K3 takes one octant per ray tile, which changes only
//     the visiting order, not the closest hit;
//   * leaf: 128 triangles in Woop plane form, t = -(N.o + nc) / (N.d),
//     u = (U.o + uc) + t (U.d), v likewise; accept u >= 0, v >= 0, u + v <= 1,
//     t > tnear, t < min(tfar, best). Within a leaf the lowest slot wins a tie,
//     across leaves a strictly smaller t is needed. Empty and degenerate slots
//     are all-zero planes: t = -0/0 = NaN and every comparison is false, so the
//     file must not be built with --use_fast_math (IEEE division is kept);
//   * latch: a latched ray records its first hit (best = 0) and leaves.
// This is the exact f32 leaf. K3's `fast` variant (bf16x3 leaf products, slack,
// the caller's exact repair pass) is bvh8_walk_fast.cu; its repair pass and
// every any-hit walk run this kernel.
//
// What bounds it on the H100: the walk is latency-bound on divergent loads.
// Each node visit reads 8 child boxes (256 B) and each leaf visit 128 plane
// triples (6 KB) at addresses that differ between the threads of a warp once
// rays diverge; the per-thread stack (160 ints) lives in local memory. The
// whole pack of an 80k-triangle scene (~12 MB of planes, <1 MB of nodes) sits
// in the 50 MB L2, so the loads are L2 hits, not HBM traffic. The design keeps
// the pack read-only (__ldg through the read-only path), reads each plane
// triple as three 16-byte vector loads, skips dead rays (tnear >= tfar) before
// touching memory, and lets latched rays leave at their first hit. Coherent
// camera rays share node and leaf addresses within a warp and are served by
// broadcast. Warp-coherent traversal, node compression and persistent threads
// are later work.
//
// Plain C interface, loaded with ctypes; the function launches on the given
// stream and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kDepth = 160;  // == DEPTH in ops/bvh8.py (asserted at build)
constexpr float kInf = 3.0e38f;

__global__ void bvh8_walk_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tnear_in, const float* __restrict__ tfar_in,
    const uint8_t* __restrict__ latch_in, int latch_mode,
    const float* __restrict__ boxes,    // (m8, 8, 8): child box [min3 | max3 | 0 0]
    const int* __restrict__ kid,        // (m8, 8): >=0 node, <=-2 leaf, -1 none
    const int* __restrict__ order,      // (m8, 8): per-octant order word
    const float4* __restrict__ planes,  // (n_leaves, leaf, 3): N, U, V (x y z c)
    int n, int leaf,
    float* __restrict__ out_t, int* __restrict__ out_local) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float tnear = tnear_in[i];
  const float tfar = fminf(tfar_in[i], kInf);
  const bool latched = latch_mode == 1 || (latch_mode == 2 && latch_in[i] != 0);
  float best = kInf;
  int local = -1;
  if (!(tnear < tfar)) {  // dead lane: no work
    out_t[i] = best;
    out_local[i] = local;
    return;
  }
  const float idx = 1.0f / (dx == 0.0f ? 1e-30f : dx);
  const float idy = 1.0f / (dy == 0.0f ? 1e-30f : dy);
  const float idz = 1.0f / (dz == 0.0f ? 1e-30f : dz);
  const int octant = ((dx >= 0.0f) << 2) | ((dy >= 0.0f) << 1) | (dz >= 0.0f);

  int stack[kDepth];
  int sp = 0;
  stack[sp++] = 0;
  while (sp > 0) {
    const int v = stack[--sp];
    if (v >= 0) {
      const float lim = fminf(tfar, best);
      const float* b = boxes + v * 64;
      unsigned hitmask = 0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 lo = __ldg(reinterpret_cast<const float4*>(b + 8 * c));
        const float4 hi = __ldg(reinterpret_cast<const float4*>(b + 8 * c + 4));
        // lo = (minx, miny, minz, maxx), hi = (maxy, maxz, 0, 0)
        const float t0x = (lo.x - ox) * idx, t1x = (lo.w - ox) * idx;
        const float t0y = (lo.y - oy) * idy, t1y = (hi.x - oy) * idy;
        const float t0z = (lo.z - oz) * idz, t1z = (hi.y - oz) * idz;
        const float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
        const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
        if ((tmin <= tmax) && (tmax > tnear) && (tmin < lim)) hitmask |= 1u << c;
      }
      const int perm = __ldg(order + v * 8 + octant);
#pragma unroll
      for (int k = 7; k >= 0; --k) {
        const int c = (perm >> (3 * k)) & 7;
        const int kv = __ldg(kid + v * 8 + c);
        if (((hitmask >> c) & 1u) && kv != -1) stack[sp++] = kv;
      }
    } else {
      const int blk = -(v + 2);
      const float lim = fminf(tfar, best);
      const float4* p = planes + (size_t)blk * leaf * 3;
      float tb = kInf;
      int sb = -1;
      for (int s = 0; s < leaf; ++s) {
        const float4 N = __ldg(p + 3 * s);
        const float4 U = __ldg(p + 3 * s + 1);
        const float4 V = __ldg(p + 3 * s + 2);
        const float ao = N.x * ox + N.y * oy + N.z * oz + N.w;
        const float ad = N.x * dx + N.y * dy + N.z * dz;
        const float t = -ao / ad;
        const float u = (U.x * ox + U.y * oy + U.z * oz + U.w) + t * (U.x * dx + U.y * dy + U.z * dz);
        const float w = (V.x * ox + V.y * oy + V.z * oz + V.w) + t * (V.x * dx + V.y * dy + V.z * dz);
        const bool h = (u >= 0.0f) && (w >= 0.0f) && (u + w <= 1.0f) && (t > tnear) && (t < lim);
        if (h) {
          if (latched) {
            sb = s;
            break;
          }
          if (t < tb) {
            tb = t;
            sb = s;
          }
        }
      }
      if (sb >= 0) {
        local = blk * leaf + sb;
        if (latched) {
          best = 0.0f;
          break;  // any-hit: leave the walk
        }
        best = tb;
      }
    }
  }
  out_t[i] = best;
  out_local[i] = local;
}

}  // namespace

extern "C" int bvh8_walk(
    const float* o, const float* d, const float* tnear, const float* tfar,
    const uint8_t* latch, int latch_mode,
    const float* boxes, const int* kid, const int* order, const float* planes,
    int n, int leaf, float* out_t, int* out_local, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  bvh8_walk_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, tnear, tfar, latch, latch_mode, boxes, kid, order,
      reinterpret_cast<const float4*>(planes), n, leaf, out_t, out_local);
  return static_cast<int>(cudaGetLastError());
}
