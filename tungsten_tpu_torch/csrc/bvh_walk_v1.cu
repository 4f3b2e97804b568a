// Skip-BVH walk with Moller-Trumbore leaves, one thread per ray: the first
// Hopper (sm_90a) form of K5, kept only to be measured against bvh_walk.cu
// in one run on one card (the intersector benchmark's walks bvhv1 / bvh1v1,
// chip_smoke.py). Nothing on a render path launches it. The suffix _v1
// means "the first CUDA form"; it is not the TPU's K5-v1 (`_walk_kernel`,
// prune = 0), which this file computes in both of its modes as before.
// Stackless, in two modes.
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
//     rule: |det| > 1e-12, u >= 0, v >= 0, u + v <= 1, t > tnear,
//     t < min(tfar, best); the lowest slot wins a tie inside a leaf, and
//     across leaves a strictly smaller t is needed. u and v are the winning
//     slot's. Padding slots are all-zero triangles (det = 0) and never win,
//     although prim_map sends them to triangle 0;
//   * K5 walks a 512-ray tile in lockstep: the tile descends where any lane
//     hits, so a lane may test leaves its own ray misses. This walk is per
//     ray and tests fewer leaves; the closest hit is the same apart from
//     box-boundary rounding.
// The leaf rounds every product and sum as its own IEEE f32 operation, in
// `_walk_kernel2`'s order (left to right), through __fmul_rn / __fadd_rn /
// __fsub_rn, which nvcc never contracts into fused multiply-adds: u and t
// cancel (u = (tv . p) / det), and a contracted leaf differed from the twin
// by up to 6e-4 in u on an H100 for small triangles far from the ray's
// origin. So the kernel's t, u and v equal the twin's bit for bit.
// The node fields leaf_blk, count and skip are exact f32 in the JAX layout;
// BvhPack.from_arrays converts them once into an int4 row per node.
// Dead lanes (tnear >= tfar) do no work and report a miss.
//
// What bounds it on the H100: divergent dependent loads, as in the other
// walks, and here the leaf above all; without pruning (v1) a ray opens every
// leaf its segment crosses, so v1 reads more leaves than v2. A leaf visit reads 128 x 9 floats
// (4.5 KB) per thread, and Moller-Trumbore, unfused here, costs about twice
// the plane form's arithmetic (bvh2_walk.cu). The pack of an 80k-triangle
// scene (~4 MB of triangles) sits in L2. Each ray stops descending behind its
// own best hit, and a dead ray reads nothing. bvh_walk.cu stages each leaf
// once a warp in shared memory and tests it with the whole warp.
//
// Plain C interface, loaded with ctypes; the function launches on the given
// stream and returns cudaGetLastError(). Built without fast-math.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLeaf = 128;  // == LEAF in ops/bvh.py
constexpr float kInf = 3.0e38f;

// a * b - c * d and a * x + b * y + c * z, each operation rounded on its own
__device__ __forceinline__ float cross1(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}
__device__ __forceinline__ float dot3(float a, float b, float c, float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), __fmul_rn(c, z));
}

__global__ void bvh_walk_v1_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tnear_in, const float* __restrict__ tfar_in,
    const float4* __restrict__ box,  // (m, 2) float4: [min3 maxx | maxy maxz 0 0]
    const int4* __restrict__ ni,     // (m,) [leaf_blk, count, skip, 0]
    const float* __restrict__ tris,  // (n_leaves, kLeaf, 9): v0, e1, e2
    int m_nodes, int n, int prune,
    float* __restrict__ out_t, int* __restrict__ out_local,
    float* __restrict__ out_u, float* __restrict__ out_v) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float tnear = tnear_in[i];
  const float tfar = tfar_in[i];
  float best = kInf, bu = 0.0f, bv = 0.0f;
  int local = -1;
  if (tnear < tfar) {
    const float ix = 1.0f / (dx == 0.0f ? 1e-30f : dx);
    const float iy = 1.0f / (dy == 0.0f ? 1e-30f : dy);
    const float iz = 1.0f / (dz == 0.0f ? 1e-30f : dz);
    int ptr = 0;
    while (ptr < m_nodes) {
      const int4 nd = __ldg(ni + ptr);
      const float lim = fminf(tfar, best);  // the leaf's bound in both modes
      const float box_lim = prune ? lim : tfar;
      const float4 lo = __ldg(box + 2 * ptr);
      const float4 hi = __ldg(box + 2 * ptr + 1);
      const float t0x = (lo.x - ox) * ix, t1x = (lo.w - ox) * ix;
      const float t0y = (lo.y - oy) * iy, t1y = (hi.x - oy) * iy;
      const float t0z = (lo.z - oz) * iz, t1z = (hi.y - oz) * iz;
      const float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
      const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
      const bool h = (tmin <= tmax) && (tmax > tnear) && (tmin < box_lim);
      if (h && nd.y > 0) {
        const float* tr = tris + (size_t)nd.x * kLeaf * 9;
        float tb = kInf, ub = 0.0f, vb = 0.0f;
        int sb = -1;
        for (int s = 0; s < kLeaf; ++s, tr += 9) {
          const float v0x = __ldg(tr), v0y = __ldg(tr + 1), v0z = __ldg(tr + 2);
          const float e1x = __ldg(tr + 3), e1y = __ldg(tr + 4), e1z = __ldg(tr + 5);
          const float e2x = __ldg(tr + 6), e2y = __ldg(tr + 7), e2z = __ldg(tr + 8);
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
          if ((u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > tnear) && (t < lim) &&
              (t < tb)) {
            tb = t;
            ub = u;
            vb = v;
            sb = s;
          }
        }
        if (sb >= 0) {
          best = tb;
          bu = ub;
          bv = vb;
          local = nd.x * kLeaf + sb;
        }
      }
      ptr = (h && nd.y == 0) ? ptr + 1 : nd.z;
    }
  }
  out_t[i] = best;
  out_local[i] = local;
  out_u[i] = bu;
  out_v[i] = bv;
}

}  // namespace

extern "C" int bvh_walk_v1(
    const float* o, const float* d, const float* tnear, const float* tfar,
    const float* box, const int* ni, const float* tris, int m_nodes, int n, int prune,
    float* out_t, int* out_local, float* out_u, float* out_v, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  bvh_walk_v1_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, tnear, tfar, reinterpret_cast<const float4*>(box),
      reinterpret_cast<const int4*>(ni), tris, m_nodes, n, prune, out_t, out_local, out_u, out_v);
  return static_cast<int>(cudaGetLastError());
}
