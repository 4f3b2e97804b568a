// Binary skip-BVH walk, one thread per ray: the first Hopper (sm_90a) form
// of K4, kept only to be measured against bvh2_walk.cu in one run on one
// card (the intersector benchmark's walks bvh3v1 / bvh3skipv1, chip_smoke.py).
// Nothing on a render path or in a query launches it. Its modes are those of
// bvh2_walk.cu; its leaf arithmetic is left to the compiler's contraction,
// where bvh2_walk.cu's closest-hit modes round as K3 does (bvh8_common.cuh
// `slot_exact`).
//
// Three modes.
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
// What bounds it on the H100: like K3 (bvh8_walk.cu), divergent dependent
// loads. A binary node is 32 bytes of box plus 16 of integer fields, read
// with vector loads through the read-only path; a leaf visit reads 128
// plane triples (6 KB). The pack of an 80k-triangle scene is ~12 MB of
// planes and <0.1 MB of nodes, so it lives in the 50 MB L2. The binary
// tree costs more node visits than K3's 8-wide one (each visit tests one or
// two boxes, not eight) and the ordered stack lives in local memory. The
// design keeps the walk per ray, so no lane pays for a leaf its ray misses
// (K4's tile does), and "any" leaves at its first hit.
//
// Plain C interface, loaded with ctypes; the function launches on the given
// stream and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStack = 96;  // == STACK_DEPTH in ops/bvh2.py
constexpr float kInf = 3.0e38f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tnear;
};

__device__ __forceinline__ bool box_hit(const float4* __restrict__ box, int v,
                                        const Ray& r, float lim) {
  const float4 lo = __ldg(box + 2 * v);      // minx miny minz maxx
  const float4 hi = __ldg(box + 2 * v + 1);  // maxy maxz 0 0
  const float t0x = (lo.x - r.ox) * r.ix, t1x = (lo.w - r.ox) * r.ix;
  const float t0y = (lo.y - r.oy) * r.iy, t1y = (hi.x - r.oy) * r.iy;
  const float t0z = (lo.z - r.oz) * r.iz, t1z = (hi.y - r.oz) * r.iz;
  const float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return (tmin <= tmax) && (tmax > r.tnear) && (tmin < lim);
}

// The leaf's hit slot (-1: none) and its t: the nearest, or with `first`
// the lowest slot that hits.
__device__ __forceinline__ int plane_leaf(const float4* __restrict__ planes, int blk,
                                          int leaf, const Ray& r, float lim, bool first,
                                          float& t_out) {
  const float4* p = planes + (size_t)blk * leaf * 3;
  float tb = kInf;
  int sb = -1;
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
      if (first) {
        tb = t;
        sb = s;
        break;
      }
      if (t < tb) {
        tb = t;
        sb = s;
      }
    }
  }
  t_out = tb;
  return sb;
}

__global__ void bvh2_walk_v1_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tnear_in, const float* __restrict__ tfar_in,
    const float4* __restrict__ box,     // (m, 2) float4: [min3 maxx | maxy maxz 0 0]
    const int4* __restrict__ ni,        // (m,) [leaf_blk, count, skip, ordcode]
    const float4* __restrict__ planes,  // (n_leaves, leaf, 3): N, U, V (x y z c)
    int m_nodes, int mode, int n, int leaf,
    float* __restrict__ out_t, int* __restrict__ out_local) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r;
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
    if (mode == 0) {
      int stack[kStack];
      int sp = 0;
      int ptr = 0;
      while (ptr >= 0) {
        const int4 nd = __ldg(ni + ptr);
        const float lim = fminf(tfar, best);
        if (nd.y > 0) {
          if (box_hit(box, ptr, r, lim)) {
            float tb;
            const int s = plane_leaf(planes, nd.x, leaf, r, lim, false, tb);
            if (s >= 0) {
              best = tb;
              local = nd.x * leaf + s;
            }
          }
          ptr = -1;
        } else {
          const int left = ptr + 1;
          const int right = __ldg(&ni[left].z);
          const bool hl = box_hit(box, left, r, lim);
          const bool hr = box_hit(box, right, r, lim);
          const int axis = nd.w >> 1;
          const bool pos = axis == 0 ? r.dx >= 0.0f : (axis == 1 ? r.dy >= 0.0f : r.dz >= 0.0f);
          const bool left_near = ((nd.w & 1) == 1) == pos;
          if (hl && hr) {
            stack[sp++] = left_near ? right : left;
            ptr = left_near ? left : right;
          } else {
            ptr = hl ? left : (hr ? right : -1);
          }
        }
        if (ptr < 0 && sp > 0) ptr = stack[--sp];
      }
    } else {
      const bool any = mode == 2;
      int ptr = 0;
      while (ptr < m_nodes) {
        const int4 nd = __ldg(ni + ptr);
        const float lim = any ? tfar : fminf(tfar, best);
        const bool h = box_hit(box, ptr, r, lim);
        if (h && nd.y > 0) {
          float tb;
          const int s = plane_leaf(planes, nd.x, leaf, r, lim, any, tb);
          if (s >= 0) {
            best = tb;
            local = nd.x * leaf + s;
            if (any) break;  // any-hit: leave the walk
          }
        }
        ptr = (h && nd.y == 0) ? ptr + 1 : nd.z;
      }
    }
  }
  out_t[i] = best;
  out_local[i] = local;
}

}  // namespace

extern "C" int bvh2_walk_v1(
    const float* o, const float* d, const float* tnear, const float* tfar,
    const float* box, const int* ni, const float* planes,
    int m_nodes, int mode, int n, int leaf,
    float* out_t, int* out_local, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  bvh2_walk_v1_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, tnear, tfar, reinterpret_cast<const float4*>(box),
      reinterpret_cast<const int4*>(ni), reinterpret_cast<const float4*>(planes),
      m_nodes, mode, n, leaf, out_t, out_local);
  return static_cast<int>(cudaGetLastError());
}
