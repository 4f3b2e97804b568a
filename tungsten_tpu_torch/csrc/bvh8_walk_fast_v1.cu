// Fast BVH8 walk, one thread per ray: the first Hopper form of K3-fast,
// kept only to be measured against bvh8_walk_fast.cu in one run on one card
// (the intersector benchmark's walk bvh8fastv1, chip_smoke.py). Nothing on a
// render path launches it. A private stack per thread, closest hit only,
// leaves evaluated as a three-pass bf16 product on the f32 units.
//
// Replaces the TPU kernel K3-fast: `_walk_kernel8` with fast=True in
// tungsten_tpu/ops/pallas_bvh8.py (`_leaf_tuv_bf16x3`, the slack of the leaf
// accept rule and of the box prune; launched by `_launch8(..., fast=True)`
// from intersect_bvh_pallas8). The traversal, the stack and the octant order
// are those of bvh8_walk_v1.cu. What differs, and is kept as the TPU kernel has
// it:
//   * the leaf product. Each plane row c = (cx, cy, cz, cw) of a slot (N, U,
//     V) is stored as two bf16 rows, c_hi = bf16(c) and c_lo = bf16(c -
//     f32(c_hi)); the ray vectors r = [o, 1] and [d, 0] are split the same
//     way once per ray (round to nearest even). Then
//         c . r  ~  c_hi . r_hi  +  c_hi . r_lo  +  c_lo . r_hi,
//     every bf16 x bf16 product exact in f32, every sum in f32. The c_lo .
//     r_lo term is NOT computed: dropping it is this kernel's error (about
//     2^-16 of |N . o|, which grows with scene extent over triangle extent),
//     and the reason for the slack;
//   * t = -ao_N / ad_N, u = ao_U + t ad_U, v = ao_V + t ad_V; accept
//     u >= -0.02, v >= -0.02, u + v <= 1.02, t > tnear (1 - 1e-3),
//     t < min(tfar, best) (1 + 1e-3). Within a leaf the lowest slot among the
//     least t wins; a leaf's winner replaces the best only when strictly
//     nearer. Empty and degenerate slots are all-zero planes: t = -0/0 = NaN,
//     never accepted, so no fast-math here either;
//   * the box test prunes against min(tfar, best (1 + 1e-3)): best may be an
//     underestimate, or a phantom's t;
//   * no latch: a phantom would occlude falsely, so any-hit stays exact.
// The winner may be a phantom, a slot accepted only through the slack just
// outside a silhouette edge, and it may have pruned a real hit behind it. The
// caller (ops/bvh8.py `intersect`) validates the winner in exact f32 and
// walks the phantom lanes again with bvh8_walk.cu.
//
// The order of the additions is fixed (pass by pass; x, y, z, w within a
// pass; then (p1 + p2) + p3) and every operation is written as an intrinsic
// that the compiler does not contract, so the plain PyTorch twin
// (`walk_fast_twin`) reproduces the kernel bit for bit: a fused multiply-add
// whose product is exact rounds once, like the twin's separate add.
//
// What bounds it on the H100: like bvh8_walk_v1.cu, latency on divergent loads
// from a pack that sits in L2. A leaf slot is 48 bytes here as there (two
// bf16 tables are the bytes of one f32 table) and costs 54 multiply-adds
// against 21, all on the ordinary f32 units: the bf16 split buys nothing on
// this card unless the three passes go to the tensor cores, which needs a
// warp's rays to visit one leaf together: bvh8_walk_fast.cu does that.
//
// Plain C interface, loaded with ctypes; the function launches on the given
// stream and returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kDepth = 160;  // == DEPTH in ops/bvh8.py
constexpr float kInf = 3.0e38f;
constexpr float kEdge = 0.02f;          // e_edge
constexpr float kOnePlusEdge = 1.02f;   // 1 + e_edge
constexpr float kOneMinusEt = 0.999f;   // 1 - e_t
constexpr float kOnePlusEt = 1.001f;    // 1 + e_t

// the two bf16 values of a 32-bit word, as f32 (element 0 in the low half)
__device__ __forceinline__ float bf_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

struct Row {  // one plane row (x y z w) as f32 values of bf16
  float x, y, z, w;
};

__device__ __forceinline__ Row row_of(uint2 q) {
  return Row{bf_lo(q.x), bf_hi(q.x), bf_lo(q.y), bf_hi(q.y)};
}

struct Split3 {  // a ray vector's bf16 halves, as f32
  float hx, hy, hz, lx, ly, lz;
};

__device__ __forceinline__ void split(float r, float& h, float& l) {
  h = __bfloat162float(__float2bfloat16_rn(r));
  l = __bfloat162float(__float2bfloat16_rn(__fsub_rn(r, h)));
}

__device__ __forceinline__ float dot(const Row& c, float x, float y, float z) {
  return __fmaf_rn(c.z, z, __fmaf_rn(c.y, y, __fmul_rn(c.x, x)));
}

// c . [r, w]: (c_hi . r_hi + c_hi . r_lo) + c_lo . r_hi, w = 1 (affine) or 0
template <bool kAffine>
__device__ __forceinline__ float dot3(const Row& ch, const Row& cl, const Split3& r) {
  float a = dot(ch, r.hx, r.hy, r.hz);
  const float b = dot(ch, r.lx, r.ly, r.lz);
  float c = dot(cl, r.hx, r.hy, r.hz);
  if (kAffine) {
    a = __fadd_rn(a, ch.w);
    c = __fadd_rn(c, cl.w);
  }
  return __fadd_rn(__fadd_rn(a, b), c);
}

__global__ void bvh8_walk_fast_v1_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tnear_in, const float* __restrict__ tfar_in,
    const float* __restrict__ boxes,   // (m8, 8, 8): child box [min3 | max3 | 0 0]
    const int* __restrict__ kid,       // (m8, 8): >=0 node, <=-2 leaf, -1 none
    const int* __restrict__ order,     // (m8, 8): per-octant order word
    const uint2* __restrict__ planes_hi,  // (n_leaves, leaf, 3) rows of 4 bf16: N, U, V
    const uint2* __restrict__ planes_lo,
    int n, int leaf,
    float* __restrict__ out_t, int* __restrict__ out_local) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float tnear = tnear_in[i];
  const float tfar = fminf(tfar_in[i], kInf);
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
  Split3 ro, rd;
  split(ox, ro.hx, ro.lx);
  split(oy, ro.hy, ro.ly);
  split(oz, ro.hz, ro.lz);
  split(dx, rd.hx, rd.lx);
  split(dy, rd.hy, rd.ly);
  split(dz, rd.hz, rd.lz);
  const float tnear_s = __fmul_rn(tnear, kOneMinusEt);

  int stack[kDepth];
  int sp = 0;
  stack[sp++] = 0;
  while (sp > 0) {
    const int v = stack[--sp];
    if (v >= 0) {
      const float lim = fminf(tfar, __fmul_rn(best, kOnePlusEt));
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
      const float lim_s = __fmul_rn(fminf(tfar, best), kOnePlusEt);
      const uint2* ph = planes_hi + (size_t)blk * leaf * 3;
      const uint2* pl = planes_lo + (size_t)blk * leaf * 3;
      float tb = kInf;
      int sb = -1;
      for (int s = 0; s < leaf; ++s) {
        const Row Nh = row_of(__ldg(ph + 3 * s)), Nl = row_of(__ldg(pl + 3 * s));
        const Row Uh = row_of(__ldg(ph + 3 * s + 1)), Ul = row_of(__ldg(pl + 3 * s + 1));
        const Row Vh = row_of(__ldg(ph + 3 * s + 2)), Vl = row_of(__ldg(pl + 3 * s + 2));
        const float t = __fdiv_rn(-dot3<true>(Nh, Nl, ro), dot3<false>(Nh, Nl, rd));
        const float u = __fadd_rn(dot3<true>(Uh, Ul, ro), __fmul_rn(t, dot3<false>(Uh, Ul, rd)));
        const float w = __fadd_rn(dot3<true>(Vh, Vl, ro), __fmul_rn(t, dot3<false>(Vh, Vl, rd)));
        const bool h = (u >= -kEdge) && (w >= -kEdge) && (__fadd_rn(u, w) <= kOnePlusEdge) &&
                       (t > tnear_s) && (t < lim_s);
        if (h && t < tb) {
          tb = t;
          sb = s;
        }
      }
      if (sb >= 0 && tb < best) {
        best = tb;
        local = blk * leaf + sb;
      }
    }
  }
  out_t[i] = best;
  out_local[i] = local;
}

}  // namespace

extern "C" int bvh8_walk_fast_v1(
    const float* o, const float* d, const float* tnear, const float* tfar,
    const float* boxes, const int* kid, const int* order,
    const void* planes_hi, const void* planes_lo,
    int n, int leaf, float* out_t, int* out_local, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  bvh8_walk_fast_v1_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, tnear, tfar, boxes, kid, order,
      reinterpret_cast<const uint2*>(planes_hi), reinterpret_cast<const uint2*>(planes_lo),
      n, leaf, out_t, out_local);
  return static_cast<int>(cudaGetLastError());
}
