// Streaming brute-force closest hit for Hopper (sm_90a), culled per warp
// and per sub-box: each warp owns 32 rays, one a lane, and walks the
// triangle chunks in order.
//
// Replaces the TPU kernel K2: `_mt_kernel` in tungsten_tpu/ops/pallas_intersect.py
// (launched by `_launch`; API intersect_pallas). It computes the closest hit
// that K2 and the plain twin `stream_twin` (ops/intersect_stream.py) define:
//   * chunks of 2048 triangles in order; within a chunk the lowest index
//     among the least t wins, across chunks a strictly smaller t is needed;
//   * Moller-Trumbore in `_mt_kernel`'s order with `ray_tri`'s accept rule
//     (walk_common.cuh `mt_exact`: every product and sum its own IEEE f32
//     operation, never contracted; the IEEE reciprocal of det) and a strict
//     t < min(tfar, best), so t, u and v equal the twin's bit for bit
//     wherever both pick the same triangle;
//   * dead rays (tnear >= tfar) and lanes past n do no work and report a
//     miss; prim is written as int32 (the TPU kernel carries it as f32,
//     exact only below 2^24 triangles).
// The culls are finer than the TPU kernel's 256-ray tile vote:
//   * per chunk, each live lane slab-tests the chunk's AABB against
//     lim = min(tfar, best) with `_mt_kernel`'s rule (inv = 1 / (d == 0 ?
//     1e-30 : d); fminf / fmaxf, as the twin's torch.fmin / fmax), and a
//     warp none of whose rays hit it skips the chunk;
//   * in a chunk the warp keeps, each lane whose ray hit the chunk tests the
//     chunk's sub-boxes (TriPack.sub_boxes: the AABB of each run of kSub = 32
//     consecutive real triangles; sub-boxes of 64 and 128 ran 1.4x and 2.8x
//     slower on the 2N batch of PERF.md, H100 80GB HBM3 at 700 W)
//     against the same lim, and tests the triangles of the sub-boxes its own
//     ray hits, in index order.
// So a ray tests only triangles whose sub-box its own ray hits, where the
// twin tests every triangle of a chunk its tile votes for. The two differ
// where Moller-Trumbore accepts a triangle just outside its box through the
// rounding of the slab test: the kernel culls it, the twin may take it.
// K5 (bvh_walk.cu) has carried the same difference since its first CUDA form;
// chip_smoke.py counts the lanes that differ and holds them by bars.
//
// What bounds it on the H100: arithmetic on the tests the culls leave. The
// first CUDA form (intersect_stream_v1.cu) ran 4.4x the tests its rays
// needed at the chunk level and ~54 f32 operations each, the IEEE division
// included. Here:
//   * the sub-box cull leaves a ray the triangles near its path;
//   * the warp stages each sub-box that any of its rays hit once, in its own
//     double-buffered slice of shared memory (kSub x 12 floats, three float4 a
//     triangle, 16-byte cp.async copies from the pack's padded copy
//     `tri_p`), so the next sub-box's copy overlaps this one's tests; the
//     lanes read each triangle as broadcasts;
//   * the cheap rejects of `mt_exact` (|det|, the signs of u's, v's and t's
//     numerators) run before the reciprocal;
//   * 4 warps a block, 2 x kSub x 48 bytes = 3 KB of shared memory a warp.
// What is left: the lanes of a warp whose rays miss a staged sub-box idle
// while the others test it.
//
// Plain C interface, loaded with ctypes; intersect_stream launches on the
// given stream and returns cudaGetLastError(). Built without fast-math.

#include "walk_common.cuh"

namespace {

using namespace walk;

constexpr int kWarps = 4;     // warps a block
constexpr int kChunk = 2048;  // == CHUNK in ops/intersect_stream.py
constexpr int kSub = 32;      // triangles a sub-box, == SUB in ops/intersect_stream.py
constexpr int kSubs = kChunk / kSub;  // sub-boxes a chunk
constexpr int kVec = 3 * kSub;        // float4 of one staged sub-box
constexpr int kSmem = kWarps * 2 * kVec * 16;  // two staged sub-boxes a warp
static_assert(kSubs <= 64 && kVec % 32 == 0, "kSub: 32 to 2048, a multiple of 32");
static_assert(kSmem <= 48 * 1024, "within the default dynamic shared memory limit");

// slab test of one AABB [min3 | max3 | 0 0] with `_mt_kernel`'s rule
__device__ __forceinline__ bool box_hit(const float4* __restrict__ b, const Ray& r, float ix,
                                        float iy, float iz, float tnear, float lim) {
  const float4 lo = __ldg(b), hi = __ldg(b + 1);
  const float t0x = (lo.x - r.ox) * ix, t1x = (lo.w - r.ox) * ix;
  const float t0y = (lo.y - r.oy) * iy, t1y = (hi.x - r.oy) * iy;
  const float t0z = (lo.z - r.oz) * iz, t1z = (hi.y - r.oz) * iz;
  const float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return (tmin <= tmax) && (tmax > tnear) && (tmin < lim);
}

__global__ void __launch_bounds__(kWarps * 32) intersect_stream_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tnear_in, const float* __restrict__ tfar_in,
    const float4* __restrict__ tri_p,     // (n_chunks * kChunk, 3) float4:
                                          // [v0 e1.x | e1.yz e2.xy | e2.z 0 0 0]
    const float4* __restrict__ clusters,  // (n_chunks, 2) float4: min3 | max3 | 0 0
    const float4* __restrict__ sub,       // (n_chunks, kSubs, 2) float4, the same
    int n_chunks, int n_tris, int n,
    float* __restrict__ out_t, int* __restrict__ out_prim,
    float* __restrict__ out_u, float* __restrict__ out_v) {
  extern __shared__ float4 smem_all[];
  float4* smem = smem_all + (threadIdx.x >> 5) * 2 * kVec;  // this warp's [2][kVec]
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  Ray r{};
  float tnear = 0.0f, tfar = 0.0f;
  if (i < n) {
    r.ox = o[3 * i], r.oy = o[3 * i + 1], r.oz = o[3 * i + 2];
    r.dx = d[3 * i], r.dy = d[3 * i + 1], r.dz = d[3 * i + 2];
    tnear = tnear_in[i];
    tfar = tfar_in[i];
  }
  const bool alive = i < n && tnear < tfar;
  const float ix = 1.0f / (r.dx == 0.0f ? 1e-30f : r.dx);
  const float iy = 1.0f / (r.dy == 0.0f ? 1e-30f : r.dy);
  const float iz = 1.0f / (r.dz == 0.0f ? 1e-30f : r.dz);
  float best = kInf, bu = 0.0f, bv = 0.0f;
  int prim = -1;

  for (int j = 0; j < n_chunks; ++j) {
    const float lim = fminf(tfar, best);
    const bool vote = alive && box_hit(clusters + 2 * j, r, ix, iy, iz, tnear, lim);
    if (!__any_sync(kFull, vote)) continue;  // no ray of the warp hits the chunk
    // the sub-boxes holding real triangles, each tested by the lanes that voted
    const int n_sub = min(kSubs, (n_tris - j * kChunk + kSub - 1) / kSub);
    unsigned long long mine = 0;
    if (vote) {
      for (int k = 0; k < n_sub; ++k) {
        if (box_hit(sub + 2 * (j * kSubs + k), r, ix, iy, iz, tnear, lim)) mine |= 1ull << k;
      }
    }
    unsigned long long todo =
        static_cast<unsigned long long>(__reduce_or_sync(kFull, static_cast<unsigned>(mine))) |
        (static_cast<unsigned long long>(__reduce_or_sync(kFull, static_cast<unsigned>(mine >> 32)))
         << 32);
    if (todo == 0) continue;
    auto stage = [&](int k, int buf) {
      const float4* src = tri_p + (static_cast<size_t>(j) * kChunk + k * kSub) * 3;
#pragma unroll
      for (int q = 0; q < kVec / 32; ++q) cp_async16(smem + buf * kVec + lane + 32 * q, src + lane + 32 * q);
    };
    int k = __ffsll(todo) - 1;
    todo &= todo - 1;
    int buf = 0;
    stage(k, buf);
    cp_async_commit();
    while (true) {
      int next = -1;
      if (todo) {
        next = __ffsll(todo) - 1;
        todo &= todo - 1;
        stage(next, buf ^ 1);
      }
      cp_async_commit();
      cp_async_wait<1>();  // this sub-box's copy has landed (the next may be in flight)
      __syncwarp();
      if ((mine >> k) & 1ull) {
        const float4* p = smem + buf * kVec;
        const int base = j * kChunk + k * kSub;
#pragma unroll 4
        for (int q = 0; q < kSub; ++q) {
          const float4 a = p[3 * q], b = p[3 * q + 1], c = p[3 * q + 2];
          float t, u, v;
          if (mt_exact(r, a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, tnear, fminf(tfar, best),
                       t, u, v)) {
            best = t;
            bu = u;
            bv = v;
            prim = base + q;
          }
        }
      }
      __syncwarp();  // buf is free for the sub-box after next
      if (next < 0) break;
      k = next;
      buf ^= 1;
    }
  }
  if (i < n) {
    out_t[i] = best;
    out_prim[i] = prim;
    out_u[i] = bu;
    out_v[i] = bv;
  }
}

}  // namespace

extern "C" int intersect_stream(
    const float* o, const float* d, const float* tnear, const float* tfar,
    const float* tri_p, const float* clusters, const float* sub, int n_chunks, int n_tris,
    int n, float* out_t, int* out_prim, float* out_u, float* out_v, void* stream) {
  if (n <= 0) return 0;
  const int threads = kWarps * 32;
  const int blocks = (n + threads - 1) / threads;
  intersect_stream_kernel<<<blocks, threads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      o, d, tnear, tfar, reinterpret_cast<const float4*>(tri_p),
      reinterpret_cast<const float4*>(clusters), reinterpret_cast<const float4*>(sub), n_chunks,
      n_tris, n, out_t, out_prim, out_u, out_v);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks a multiprocessor (registers and shared memory permitting).
extern "C" int intersect_stream_blocks_per_sm() {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, intersect_stream_kernel, kWarps * 32,
                                                kSmem);
  return blocks;
}
