// Fast BVH8 walk for Hopper (sm_90a): inner nodes per thread, leaves per
// warp, the leaf's bf16x3 products on the tensor cores. Closest hit only.
//
// Replaces the TPU kernel K3-fast: `_walk_kernel8` with fast=True in
// tungsten_tpu/ops/pallas_bvh8.py (`_leaf_tuv_bf16x3`, the slack of the leaf
// accept rule and of the box prune; launched by `_launch8(..., fast=True)`
// from intersect_bvh_pallas8). The traversal and the stack are those of
// bvh8_walk.cu (bvh8_common.cuh). What it computes, as the TPU kernel does:
//   * the leaf product. Each plane row c = (cx, cy, cz, cw) of a slot (N, U,
//     V) is stored as two bf16 rows, c_hi = bf16(c) and c_lo = bf16(c -
//     f32(c_hi)); the ray vectors r = [o, 1] and [d, 0] are split the same
//     way once per ray (round to nearest even). Then
//         c . r  ~  c_hi . r_hi  +  c_hi . r_lo  +  c_lo . r_hi,
//     every bf16 x bf16 product exact. The c_lo . r_lo term is NOT computed:
//     dropping it is this kernel's error (about 2^-16 of |N . o|), and the
//     reason for the slack;
//   * t = -ao_N / ad_N, u = ao_U + t ad_U, v = ao_V + t ad_V; accept
//     u >= -0.02, v >= -0.02, u + v <= 1.02, t > tnear (1 - 1e-3),
//     t < min(tfar, best) (1 + 1e-3). Within a leaf the lowest slot among the
//     least t wins; a leaf's winner replaces the best only when strictly
//     nearer. All-zero slots give t = -0/0 = NaN, never accepted, so no
//     fast-math;
//   * the box test prunes against min(tfar, best (1 + 1e-3));
//   * no latch: a phantom would occlude falsely, so any-hit stays exact.
// The winner may be a phantom (a slot accepted only through the slack); the
// caller (ops/bvh8.py `intersect`) validates it in exact f32 and walks the
// phantom lanes again with bvh8_walk.cu.
//
// The leaf step as one tensor-core product, as the TPU kernel gives it to
// its MXU. mma.sync.m16n8k16 (bf16 in, f32 accumulate) with
//   A (16 x 16): one plane row (N, U or V) of 16 slots a row,
//                [c_hi(4) | c_hi(4) | c_lo(4) | 0(4)] along k;
//   B (16 x 8):  the rays, column 2j = ray j's [o, 1] and 2j + 1 its [d, 0],
//                [r_hi(4) | r_lo(4) | r_hi(4) | 0(4)] along k;
// so each accumulator is c_hi.r_hi + c_hi.r_lo + c_lo.r_hi of one slot and
// one ray vector. A group of up to 4 member rays takes 3 products (N, U, V)
// for each 16 slots, 24 for the leaf. In the m16n8 accumulator layout lane
// (g = lane / 4, q = lane % 4) then holds N.o, N.d, U.o, U.d, V.o and V.d of
// slots 16s + g and 16s + 8 + g of ray q: it computes t, u and v of its 16
// slots in registers (t by the approximate reciprocal and one Newton step,
// `div_nr`), and three xor-shuffles over the 8 lanes of ray q give the
// lexicographic (t, slot) minimum. With more than 4 members the group
// step repeats; a member alone takes a whole group. Each accumulator element
// depends only on its own row and column, so a ray's result does not depend
// on which rays share its warp. (Rays in B rather than in A: the suggested
// layout with 8 rays' o and d rows in A needs 48 products a leaf for up to 8
// rays; with 1 to 3 members a leaf, as incoherent warps have, this one needs
// half the products and fragment loads, and the rays' fragment is loaded once
// a leaf.)
//
// The A fragments are read straight from the staged bf16 tables, the
// pack's `tri_planes_hi` / `tri_planes_lo` (6 KB a leaf together): lane
// (g, q) reads the hi word (q & 1) of its slot's row and, for q < 2, the lo
// word; the 16 words of one read lie in 16 banks. A k16 table built in the
// pack (12 KB a leaf, laid out for ldmatrix) would double the bytes staged
// per leaf visit and was not built.
//
// The tensor core sums the 12 products in its own order and rounding, not in
// the twin's fixed order, and t's quotient is within about an ulp of the
// IEEE one, so this kernel is not bit-equal to `walk_fast_twin`: it is held
// to it statistically (chip_smoke.py phase 3d, tests/test_torch_cuda.py), as
// the TPU's MXU is. bvh8_walk_fast_v1.cu keeps the one-thread-per-ray form
// that is bit-equal to the twin.
//
// What bounds it on the H100: latency, as bvh8_walk.cu (the pack sits in
// L2). 4 warps a block, 13 KB of dynamic shared memory a warp (two leaf
// buffers of 6 KB, the lanes' ray words); the shared memory caps a
// multiprocessor at 4 blocks. A tensor-core group costs the same whatever
// number of its 4 columns hold a ray, so a leaf visited by one ray pays for
// four; the slot loop is unrolled whole, which keeps the accumulators and the
// fragment addresses in registers.
//
// Why the tensor cores: on the H100 this step is faster than a cooperative
// leaf step on the f32 units (bvh8_walk.cu's lane split with the twin's
// bf16x3 arithmetic) on the 2N batch and on coherent rays, and ties on
// incoherent ones (PERF.md, section 6).
//
// Plain C interface, loaded with ctypes; bvh8_walk_fast launches on the given
// stream and returns cudaGetLastError().

#include <cuda_bf16.h>

#include "bvh8_common.cuh"

namespace {

using namespace bvh8;

constexpr float kEdge = 0.02f;          // e_edge
constexpr float kOnePlusEdge = 1.02f;   // 1 + e_edge
constexpr float kOneMinusEt = 0.999f;   // 1 - e_t
constexpr float kOnePlusEt = 1.001f;    // 1 + e_t
constexpr int kNoSlot = 0x7fffffff;

constexpr int kWarps = 4;
constexpr int kTableWords = kLeaf * 6;     // one leaf's bf16 table (hi or lo), 32-bit words
constexpr int kBufWords = 2 * kTableWords; // one leaf buffer: hi, then lo
constexpr int kRayWords = 32 * 8;          // each lane's ray as bf16 pairs
constexpr int kWarpWords = 2 * kBufWords + kRayWords;
constexpr int kSmem = kWarps * kWarpWords * 4;

__device__ __forceinline__ void split(float r, __nv_bfloat16& h, __nv_bfloat16& l) {
  h = __float2bfloat16_rn(r);
  l = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(h)));
}

// two bf16 values as one 32-bit word, the first in the low half
__device__ __forceinline__ unsigned pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(a)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(b)) << 16);
}

// c = A (16 x 16, row) . B (16 x 8, col), bf16 in, f32 accumulate from 0
__device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.0f));
}

// x / y from the approximate reciprocal and one Newton step: within about
// an ulp of the IEEE quotient, without its range checks and slow path; 0 / 0
// (an all-zero slot) is NaN, and x / 0 is NaN where IEEE gives an infinity,
// which no accept rule takes either
__device__ __forceinline__ float div_nr(float x, float y) {
  const float r = __fdividef(1.0f, y);
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q, y, x), r, q);
}

// the lane of the j-th set bit of m (j < 4), or -1
__device__ __forceinline__ int nth_lane(unsigned m, int j) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k < j) m &= m - 1;
  }
  return m ? __ffs(m) - 1 : -1;
}

struct FastLeaf {
  const uint4* hi;  // (n_leaves, 128, 12) bf16: N, U, V rows (x y z c)
  const uint4* lo;
  unsigned* smem;   // this warp's [2][hi | lo] leaf buffers, then the ray words
  int lane;
  float tnear_s;    // tnear (1 - e_t)

  __device__ __forceinline__ float prune(float best) const { return __fmul_rn(best, kOnePlusEt); }

  __device__ __forceinline__ void stage(int leaf, int buf) {
    const uint4* sh = hi + static_cast<size_t>(leaf) * (kTableWords / 4);
    const uint4* sl = lo + static_cast<size_t>(leaf) * (kTableWords / 4);
    uint4* dh = reinterpret_cast<uint4*>(smem + buf * kBufWords);
    uint4* dl = dh + kTableWords / 4;
#pragma unroll
    for (int k = 0; k < kTableWords / 4 / 32; ++k) {
      cp_async16(dh + lane + 32 * k, sh + lane + 32 * k);
      cp_async16(dl + lane + 32 * k, sl + lane + 32 * k);
    }
  }

  __device__ __forceinline__ void test(Walker& w, unsigned members, int leaf, int buf) {
    const unsigned* H = smem + buf * kBufWords;
    const unsigned* L = H + kTableWords;
    const unsigned* rays = smem + 2 * kBufWords;
    const float lim_own = __fmul_rn(fminf(w.tfar, w.best), kOnePlusEt);
    const int g = lane >> 2, q = lane & 3;
    while (members) {
      unsigned grp = 0;  // the (up to) 4 lowest members
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        grp |= members & (0u - members);
        members &= members - 1;
      }
      // B fragment: column g = ray g / 2's [o, 1] (g even) or [d, 0] (g odd)
      const int src_b = nth_lane(grp, g >> 1);
      unsigned b0 = 0u, b1 = 0u;
      if (src_b >= 0) {
        b0 = rays[src_b * 8 + (g & 1) * 4 + q];
        b1 = q < 2 ? b0 : 0u;
      }
      // this lane's accumulators belong to ray q
      const int src_e = max(nth_lane(grp, q), 0);
      const float tn = __shfl_sync(kFull, tnear_s, src_e);
      const float lim = __shfl_sync(kFull, lim_own, src_e);
      float tb = kInf;
      int sb = kNoSlot;
#pragma unroll
      for (int sg = 0; sg < kLeaf / 16; ++sg) {
        float acc[3][4];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int wi = (sg * 16 + g) * 6 + 2 * c + (q & 1);
          const unsigned a2 = q < 2 ? L[wi] : 0u;
          const unsigned a3 = q < 2 ? L[wi + 48] : 0u;
          mma_bf16(acc[c], H[wi], H[wi + 48], a2, a3, b0, b1);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // slot 16 sg + g, then 16 sg + 8 + g
          const float t = div_nr(-acc[0][2 * h], acc[0][2 * h + 1]);
          const float u = __fadd_rn(acc[1][2 * h], __fmul_rn(t, acc[1][2 * h + 1]));
          const float v = __fadd_rn(acc[2][2 * h], __fmul_rn(t, acc[2][2 * h + 1]));
          const bool hit = (u >= -kEdge) && (v >= -kEdge) && (__fadd_rn(u, v) <= kOnePlusEdge) &&
                           (t > tn) && (t < lim);
          if (hit && t < tb) {
            tb = t;
            sb = sg * 16 + 8 * h + g;
          }
        }
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {  // over the 8 lanes of ray q
        const float ot = __shfl_xor_sync(kFull, tb, off);
        const int os = __shfl_xor_sync(kFull, sb, off);
        if (ot < tb || (ot == tb && os < sb)) {
          tb = ot;
          sb = os;
        }
      }
      // lane j holds ray j's winner; each member of the group reads its own
      const int j = __popc(grp & ((1u << lane) - 1u)) & 3;
      const float rt = __shfl_sync(kFull, tb, j);
      const int rs = __shfl_sync(kFull, sb, j);
      if (((grp >> lane) & 1u) && rs != kNoSlot && rt < w.best) {
        w.best = rt;
        w.local = leaf * kLeaf + rs;
      }
    }
    if (w.parked == leaf) w.parked = -1;
  }
};

__global__ void __launch_bounds__(kWarps * 32) bvh8_walk_fast_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tnear_in, const float* __restrict__ tfar_in,
    const float* __restrict__ boxes,  // (m8, 8, 8): child box [min3 | max3 | 0 0]
    const int* __restrict__ kid,      // (m8, 8): >=0 node, <=-2 leaf, -1 none
    const int* __restrict__ order,    // (m8, 8): per-octant order word
    const uint4* __restrict__ planes_hi, const uint4* __restrict__ planes_lo,
    int n, float* __restrict__ out_t, int* __restrict__ out_local) {
  extern __shared__ uint4 smem_all[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  Walker w = make_walker(o, d, tnear_in, tfar_in, i, n);
  unsigned* mine = reinterpret_cast<unsigned*>(smem_all) + (threadIdx.x >> 5) * kWarpWords;
  // the lane's ray as B-column words: [o_hi.xy, o_hi.z 1, o_lo.xy, o_lo.z 0,
  // d_hi.xy, d_hi.z 0, d_lo.xy, d_lo.z 0]
  __nv_bfloat16 h[6], l[6];
  const float r[6] = {w.ox, w.oy, w.oz, w.dx, w.dy, w.dz};
#pragma unroll
  for (int k = 0; k < 6; ++k) split(r[k], h[k], l[k]);
  const __nv_bfloat16 one = __float2bfloat16_rn(1.0f), zero = __float2bfloat16_rn(0.0f);
  unsigned* rw = mine + 2 * kBufWords + lane * 8;
  rw[0] = pack2(h[0], h[1]);
  rw[1] = pack2(h[2], one);
  rw[2] = pack2(l[0], l[1]);
  rw[3] = pack2(l[2], zero);
  rw[4] = pack2(h[3], h[4]);
  rw[5] = pack2(h[5], zero);
  rw[6] = pack2(l[3], l[4]);
  rw[7] = pack2(l[5], zero);
  __syncwarp();
  int stack[kDepth];
  FastLeaf leaf_step{planes_hi, planes_lo, mine, lane, __fmul_rn(w.tnear, kOneMinusEt)};
  walk_warp(leaf_step, w, stack, boxes, kid, order);
  if (i < n) {
    out_t[i] = w.best;
    out_local[i] = w.local;
  }
}

}  // namespace

extern "C" int bvh8_walk_fast(
    const float* o, const float* d, const float* tnear, const float* tfar,
    const float* boxes, const int* kid, const int* order,
    const void* planes_hi, const void* planes_lo,
    int n, float* out_t, int* out_local, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(bvh8_walk_fast_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = kWarps * 32;
  const int blocks = (n + threads - 1) / threads;
  bvh8_walk_fast_kernel<<<blocks, threads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      o, d, tnear, tfar, boxes, kid, order, reinterpret_cast<const uint4*>(planes_hi),
      reinterpret_cast<const uint4*>(planes_lo), n, out_t, out_local);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks a multiprocessor (registers and shared memory permitting).
extern "C" int bvh8_walk_fast_blocks_per_sm() {
  int blocks = 0;
  cudaFuncSetAttribute(bvh8_walk_fast_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bvh8_walk_fast_kernel,
                                                kWarps * 32, kSmem);
  return blocks;
}
