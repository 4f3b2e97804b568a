// The first CUDA form of K7, one thread per lane, kept only to be measured
// against photon_walk.cu in one run on one card (chip_smoke.py phase 14, the
// `cuda`-marked tests). Nothing on a render path launches it; its wrapper is
// `walk_cuda_v1` in ops/photon_walk.py. Its exported names end in _v1; the rest
// is the first form's source unchanged.
//
// The photon-grid walk, one thread per lane: the first Hopper (sm_90a) form of K7.
//
// Replaces the candidate loops of the JAX package's SPPM gathers
// (tungsten_tpu/integrators/photon_map.py): the surface gather's 27-cell
// loop `cell_body` (:1255-1280) and its kNN histogram `hist_body`
// (:1221-1247), and the 3D DDA of `_volume_beam_gather` (:966-1035) and
// `_beam1d_gather` (:482-577). Those are XLA loops, not Pallas. This kernel
// runs their accept tests per thread over the photon hash grid and emits
// the accepted (lane, row) pairs; the physics runs in PyTorch on the pairs
// (ops/photon_walk.py, integrators/photon_map.py). Modes:
//   0 surface: the gather point's cell floor(gp / cell) and its 27
//     neighbours (dx, dy, dz in -1, 0, 1, dz fastest), of each hash cell the
//     first min(count, 32) rows from its start; accepted where the bounce
//     gate min <= bounce + pb - 1 < max holds and |p - gp|^2 < lim (r^2);
//   1 hist: the same candidates against lim = r^2_max, counted in 32 bins
//     of (d^2 / r^2_max) * 32 (the kNN histogram, written to count_out);
//   2 points: the DDA through cells `cell` = 2 r wide, every round visiting
//     the current cell's 27 neighbours; a photon counts where its foot
//     o + t* d, t* = clip((p - o).d, 0, seg), lies in the visited cell,
//     |p - foot|^2 < r^2 and the gate holds; a pair carries t* and dist^2;
//   3 beams: the same DDA over beam stations; intersectBeam1D's perp < r,
//     0 < t < seg, s in [0, len] and in [s0, s0 + r), and the gate; a pair
//     carries t and 1 / sin.
// Phases: 0 each lane's own rounds (points, beams: the DDA's steps while
// t < seg, at most 96) into count_out; the wrapper takes the maximum, the
// JAX loop's global count, which every lane then walks. 1 the accepted
// pairs a lane into count_out (hist: the histogram). 2 the pairs written
// from the lane's exclusive-scan offset, in (round, offset, slot) order. A
// lane whose mask byte is 0 does nothing (0 rounds, 0 pairs): the JAX masks
// zero those lanes (not gathered, not in a medium, dead).
// Every product, sum and quotient is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn: nvcc contracts none of them),
// in the twin's order (walk_twin, _accept: three-term dots as (x + y) + z,
// the cross products' two products each rounded), so the kernel equals the
// twin bit for bit: pairs, floats and histogram.
//
// Its bound on the H100 (the larger of two terms, counted from the twin's
// work on the same lanes; chip_smoke.py k7_bound): the bytes it must move
// over 3.35 TB/s: of each row the hash cells can give (at most 32 a cell,
// at most one a candidate test) the fields accept() loads, 16 bytes (p,
// the bounce) or 36 (beams: also d, len, s0); the cell tables' entries a
// lane-round reads (8 bytes each); the pairs written (8 bytes, 16 with the
// two floats) or the histogram (128 bytes a lane); a mask byte a lane and
// a walking lane's o, lim and bounce (20 bytes, 32 with d). And the
// operations over 67 TFLOP/s, tallied from this body (an add, sub, mul,
// divide, sqrt, abs, min, max, float-int conversion or comparison counts
// one; integer ones too):
//   accept(), a candidate row: the gate 5 (the row's bounce converted, two
//     adds, two comparisons), then
//     surface / hist 9: e 3, dot3 5, d^2 < lim 1 (14 in all);
//     points 34: dv 3, dot3 5, the clamp 2, per axis the foot 2, its cell
//       2, the cell test 1 and e 1 (18), dot3 5, dist^2 < r^2 1 (39);
//     beams 83: lv 3, cross3 9, |c| 8 (dot3 5, two max, sqrt), u 3,
//       cross3 9, denom 5, t 8 (dot3 5, abs, comparison, divide), hb 9,
//       cosr 5, inv_sin 5, perp 6, s_cr 5, the tests 8 (88);
//   hist's bin, an accepted row: divide, mul, conversion, min (4);
//   visit(), a lane-round: 27 neighbours of 10 each (3 adds, the hash's 3
//     muls, 2 xors and mask, the count's min);
//   dda_step(), a volume round: 2 comparisons, 2 adds (4).
// The kernel waits on the rows' loads: a candidate's row is a dependent
// load after its cell's hash and start, and the lanes of a warp visit
// different cells, so the loads do not coalesce; the simple form leaves the
// card idle on them. Later forms (ROADMAP): a warp per lane-round, the
// rows of a cell fetched by its 32 threads at once.
//
// Plain C interface, loaded with ctypes; the function launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxPerCell = 32;       // == MAX_PER_CELL
constexpr unsigned kGridMask = (1u << 20) - 1;  // GRID_SIZE - 1
constexpr int kMaxSteps = 96;         // == MAX_VOL_STEPS
constexpr int kBins = 32;             // == N_BINS
constexpr int kThreads = 128;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
// torch.minimum / maximum / clamp: NaN propagates
__device__ __forceinline__ float pmin(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float pmax(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return add(add(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2]));
}

__device__ __forceinline__ void cross3(const float a[3], const float b[3], float c[3]) {
  c[0] = sub(mul(a[1], b[2]), mul(a[2], b[1]));
  c[1] = sub(mul(a[2], b[0]), mul(a[0], b[2]));
  c[2] = sub(mul(a[0], b[1]), mul(a[1], b[0]));
}

// floor(x / size) as int32; out of range saturates (cvt.rmi.s32.f32), as
// the twin's clamp before its cast
__device__ __forceinline__ int cell_of(float x, float size) {
  return __float2int_rd(dvd(x, size));
}

__device__ __forceinline__ unsigned hash_cell(int ix, int iy, int iz) {
  const unsigned h = static_cast<unsigned>(ix) * 73856093u ^ static_cast<unsigned>(iy) * 19349663u ^
                     static_cast<unsigned>(iz) * 83492791u;
  return h & kGridMask;
}

struct Args {
  int mode, phase;
  const float* __restrict__ pack;
  int row_w;
  const int* __restrict__ starts;
  const int* __restrict__ counts;
  const float* __restrict__ o;
  const float* __restrict__ d;
  const float* __restrict__ lim;
  const int* __restrict__ bounce;
  const unsigned char* __restrict__ mask;
  int n;
  float cell, r, r2;
  int min_b, max_b, rounds;
  const long long* __restrict__ offsets;
  int* __restrict__ count_out;
  int* __restrict__ lane_out;
  int* __restrict__ row_out;
  float* __restrict__ a_out;
  float* __restrict__ b_out;
};

struct Lane {
  float o[3], d[3], lim;
  int bounce;
};

// the accept test of one candidate row; a / b: the pair's two floats
__device__ __forceinline__ bool accept(const Args& g, const Lane& L, const int cv[3], int row,
                                       float& a, float& b) {
  const float* x = g.pack + static_cast<long long>(row) * g.row_w;
  const int pb = static_cast<int>(__ldg(x + (g.mode == 3 ? 10 : 9)));  // the row's bounce
  const int full_b = L.bounce + pb - 1;
  const bool gate = full_b >= g.min_b && full_b < g.max_b;
  if (g.mode <= 1) {  // surface, hist
    const float e[3] = {sub(__ldg(x), L.o[0]), sub(__ldg(x + 1), L.o[1]), sub(__ldg(x + 2), L.o[2])};
    a = dot3(e, e);
    return gate && a < L.lim;
  }
  if (g.mode == 2) {  // points
    const float p[3] = {__ldg(x), __ldg(x + 1), __ldg(x + 2)};
    const float dv[3] = {sub(p[0], L.o[0]), sub(p[1], L.o[1]), sub(p[2], L.o[2])};
    const float t_star = pmin(pmax(dot3(dv, L.d), 0.0f), L.lim);
    bool dedup = true;
    float e[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float foot = add(L.o[k], mul(t_star, L.d[k]));
      dedup = dedup && cell_of(foot, g.cell) == cv[k];
      e[k] = sub(p[k], foot);
    }
    a = t_star;
    b = dot3(e, e);
    return dedup && b < g.r2 && gate;
  }
  // beams: intersectBeam1D (photon_map.py:513-532)
  const float bo[3] = {__ldg(x), __ldg(x + 1), __ldg(x + 2)};
  const float bd[3] = {__ldg(x + 3), __ldg(x + 4), __ldg(x + 5)};
  const float b_len = __ldg(x + 6), b_s0 = __ldg(x + 12);
  const float lv[3] = {sub(bo[0], L.o[0]), sub(bo[1], L.o[1]), sub(bo[2], L.o[2])};
  float c[3], u[3], nv[3];
  cross3(lv, bd, c);
  const float len = pmax(__fsqrt_rn(pmax(dot3(c, c), 0.0f)), 1e-12f);
#pragma unroll
  for (int k = 0; k < 3; ++k) u[k] = dvd(c[k], len);
  cross3(bd, u, nv);
  const float denom = dot3(nv, L.d);
  const float t = dvd(dot3(nv, lv), fabsf(denom) < 1e-9f ? 1e-9f : denom);
  float hb[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) hb[k] = sub(add(L.o[k], mul(L.d[k], t)), bo[k]);
  const float cosr = dot3(L.d, bd);
  const float inv_sin = dvd(1.0f, __fsqrt_rn(pmax(sub(1.0f, mul(cosr, cosr)), 1e-8f)));
  const float perp = fabsf(dot3(u, hb));
  const float s_cr = dot3(bd, hb);
  a = t;
  b = inv_sin;
  return perp < g.r && t > 0.0f && t < L.lim && s_cr >= 0.0f && s_cr <= b_len && s_cr >= b_s0 &&
         s_cr < add(b_s0, g.r) && gate;
}

// one lane-round: the 27 neighbours of cell cv, their rows, the accept test;
// counts into `count` (phase 1), writes from `out` (phase 2), bins (hist)
__device__ __forceinline__ void visit(const Args& g, const Lane& L, const int cv[3], int lane,
                                      int& count, long long& out) {
  for (int dx = -1; dx <= 1; ++dx) {
    for (int dy = -1; dy <= 1; ++dy) {
      for (int dz = -1; dz <= 1; ++dz) {
        const unsigned h = hash_cell(cv[0] + dx, cv[1] + dy, cv[2] + dz);
        const int start = __ldg(g.starts + h);
        const int cnt = min(__ldg(g.counts + h), kMaxPerCell);
        for (int m = 0; m < cnt; ++m) {
          float a = 0.0f, b = 0.0f;
          if (!accept(g, L, cv, start + m, a, b)) continue;
          if (g.mode == 1) {
            const int bin = min(static_cast<int>(mul(dvd(a, L.lim), static_cast<float>(kBins))),
                                kBins - 1);
            ++g.count_out[static_cast<long long>(lane) * kBins + bin];
          } else if (g.phase == 1) {
            ++count;
          } else {
            g.lane_out[out] = lane;
            g.row_out[out] = start + m;
            if (g.mode >= 2) {
              g.a_out[out] = a;
              g.b_out[out] = b;
            }
            ++out;
          }
        }
      }
    }
  }
}

struct Dda {
  int c[3], stp[3];
  float tm[3], td[3];
};

__device__ __forceinline__ void dda_setup(const Args& g, const Lane& L, Dda& s) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float inv = dvd(1.0f, fabsf(L.d[k]) < 1e-12f ? 1e-12f : L.d[k]);
    const bool pos = L.d[k] >= 0.0f;
    s.stp[k] = pos ? 1 : -1;
    s.c[k] = cell_of(L.o[k], g.cell);
    const float nxt = mul(add(static_cast<float>(s.c[k]), pos ? 1.0f : 0.0f), g.cell);
    s.tm[k] = mul(sub(nxt, L.o[k]), inv);
    s.td[k] = fabsf(mul(g.cell, inv));
  }
}

// one round: the nearest boundary's axis (the first on ties) is crossed
__device__ __forceinline__ float dda_step(Dda& s) {
  int ax = 0;
  float best = s.tm[0];
  if (s.tm[1] < best) { ax = 1; best = s.tm[1]; }
  if (s.tm[2] < best) { ax = 2; best = s.tm[2]; }
  s.c[ax] += s.stp[ax];
  s.tm[ax] = add(s.tm[ax], s.td[ax]);
  return best;
}

__global__ void __launch_bounds__(kThreads) photon_walk_kernel(Args g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.n) return;
  const bool volume = g.mode >= 2;
  if (g.mask[i] == 0) {
    if (g.phase != 2 && g.mode != 1) g.count_out[i] = 0;
    return;
  }
  Lane L;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    L.o[k] = g.o[3 * i + k];
    L.d[k] = volume ? g.d[3 * i + k] : 0.0f;
  }
  L.lim = g.lim[i];
  L.bounce = g.bounce[i];
  int count = 0;
  long long out = g.phase == 2 ? g.offsets[i] : 0;
  if (!volume) {
    const int cv[3] = {cell_of(L.o[0], g.cell), cell_of(L.o[1], g.cell), cell_of(L.o[2], g.cell)};
    visit(g, L, cv, i, count, out);
    if (g.phase == 1 && g.mode == 0) g.count_out[i] = count;
    return;
  }
  Dda s;
  dda_setup(g, L, s);
  if (g.phase == 0) {
    float t = 0.0f;
    int own = 0;
    while (own < kMaxSteps && t < L.lim) {
      t = dda_step(s);
      ++own;
    }
    g.count_out[i] = own;
    return;
  }
  for (int round = 0; round < g.rounds; ++round) {
    visit(g, L, s.c, i, count, out);
    dda_step(s);
  }
  if (g.phase == 1) g.count_out[i] = count;
}

}  // namespace

extern "C" int photon_walk_v1(int mode, int phase, const float* pack, int row_w, const int* starts,
                              const int* counts, const float* o, const float* d, const float* lim,
                              const int* bounce, const unsigned char* mask, int n, float cell,
                              float r, int min_b, int max_b, int rounds, const long long* offsets,
                              int* count_out, int* lane_out, int* row_out, float* a_out,
                              float* b_out, void* stream) {
  if (n <= 0) return 0;
  Args g{mode, phase, pack, row_w, starts, counts, o, d, lim, bounce, mask, n, cell, r,
         r * r, min_b, max_b, rounds, offsets, count_out, lane_out, row_out, a_out, b_out};
  const int blocks = (n + kThreads - 1) / kThreads;
  photon_walk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int photon_walk_v1_blocks_per_sm() {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, photon_walk_kernel, kThreads, 0);
  return blocks;
}
