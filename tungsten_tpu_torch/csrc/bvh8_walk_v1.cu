// BVH8 walk, one thread per ray: the first Hopper form of K3, kept only to
// be measured against bvh8_walk.cu in one run on one card (the intersector
// benchmark's walks bvh8v1 / bvh8anyv1, chip_smoke.py). Nothing on a render
// path launches it.
//
// Replaces the TPU kernel K3: `_walk_kernel8` in tungsten_tpu/ops/pallas_bvh8.py.
// It computes the function of bvh8_walk.cu (see there, and `walk_twin` in
// ops/bvh8.py): closest / any / mixed through a per-ray latch, the node
// visits and the slot test of bvh8_common.cuh, so that the two kernels agree
// bit for bit. Each thread walks its own ray with a private stack and tests
// each leaf it pops in a serial loop over the 128 slots, reading the plane
// triples through the read-only path (__ldg, three 16-byte loads a slot).
//
// What bounds it on the H100: latency on divergent loads. The leaf loop's
// loads differ between the lanes of a warp once rays diverge, and each ray
// reads its 6 KB leaf alone; the pack sits in L2.
//
// Plain C interface, loaded with ctypes; the function launches on the given
// stream and returns cudaGetLastError().

#include "bvh8_common.cuh"

namespace {

using namespace bvh8;

__global__ void bvh8_walk_v1_kernel(
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
  Walker w = make_walker(o, d, tnear_in, tfar_in, i, n);
  const bool latched = latch_mode == 1 || (latch_mode == 2 && latch_in[i] != 0);
  int stack[kDepth];
  if (w.sp > 0) stack[0] = 0;
  while (w.sp > 0) {
    const int v = stack[--w.sp];
    if (v >= 0) {
      visit_node(boxes, kid, order, v, w, fminf(w.tfar, w.best), stack, w.sp);
    } else {
      const int blk = -(v + 2);
      const float lim = fminf(w.tfar, w.best);
      const float4* p = planes + (size_t)blk * leaf * 3;
      float tb = kInf;
      int sb = -1;
      for (int s = 0; s < leaf; ++s) {
        float t;
        const bool h = slot_exact(__ldg(p + 3 * s), __ldg(p + 3 * s + 1), __ldg(p + 3 * s + 2),
                                  w.ox, w.oy, w.oz, w.dx, w.dy, w.dz, w.tnear, lim, t);
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
        w.local = blk * leaf + sb;
        if (latched) {
          w.best = 0.0f;
          break;  // any-hit: leave the walk
        }
        w.best = tb;
      }
    }
  }
  out_t[i] = w.best;
  out_local[i] = w.local;
}

}  // namespace

extern "C" int bvh8_walk_v1(
    const float* o, const float* d, const float* tnear, const float* tfar,
    const uint8_t* latch, int latch_mode,
    const float* boxes, const int* kid, const int* order, const float* planes,
    int n, int leaf, float* out_t, int* out_local, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  bvh8_walk_v1_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, tnear, tfar, latch, latch_mode, boxes, kid, order,
      reinterpret_cast<const float4*>(planes), n, leaf, out_t, out_local);
  return static_cast<int>(cudaGetLastError());
}
