// The photon-grid walk, redesigned for Hopper (sm_90a): K7, one walk that
// tests each candidate once, the pairs staged in pages a lane and copied
// into lane order.
//
// Replaces the candidate loops of the JAX package's SPPM gathers
// (tungsten_tpu/integrators/photon_map.py): the surface gather's 27-cell
// loop `cell_body` (:1255-1280) and its kNN histogram `hist_body`
// (:1221-1247), and the 3D DDA of `_volume_beam_gather` (:966-1035) and
// `_beam1d_gather` (:482-577). Those are XLA loops, not Pallas. This kernel
// runs their accept tests over the photon hash grid and emits the accepted
// (lane, row) pairs; the physics runs in PyTorch on the pairs
// (ops/photon_walk.py, integrators/photon_map.py). Modes:
//   0 surface: the gather point's cell floor(gp / cell) and its 27
//     neighbours (dx, dy, dz in -1, 0, 1, dz fastest), of each hash cell the
//     first min(count, 32) rows from its start; accepted where the bounce
//     gate min <= bounce + pb - 1 < max holds and |p - gp|^2 < lim (r^2);
//   1 hist: the same candidates against lim = r^2_max, counted in 32 bins
//     of (d^2 / r^2_max) * 32 (the kNN histogram);
//   2 points: the DDA through cells `cell` = 2 r wide, every round visiting
//     the current cell's 27 neighbours; a photon counts where its foot
//     o + t* d, t* = clip((p - o).d, 0, seg), lies in the visited cell,
//     |p - foot|^2 < r^2 and the gate holds; a pair carries t* and dist^2;
//   3 beams: the same DDA over beam stations; intersectBeam1D's perp < r,
//     0 < t < seg, s in [0, len] and in [s0, s0 + r), and the gate; a pair
//     carries t and 1 / sin.
// The DDA's round count is global: every walking lane walks the largest of
// the lanes' own counts (a caveat of the reference, kept). A lane whose
// mask byte is 0 does nothing. Every product, sum and quotient is rounded
// on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), in
// the twin's order, so the kernel equals the twin (walk_twin) and
// photon_walk_v1.cu bit for bit: pairs in (lane, round, offset, slot) order,
// floats and histogram.
//
// What bounds it on the H100: counted as the bound counts it, the
// candidate tests' f32 operations in the volume modes (box-synth fog at
// 2^18 photons: ~1.2e10 candidate rows a call, 39 or 88 operations each,
// chip_smoke.py k7_bound with constants tallied from photon_walk_v1.cu)
// and the rows' bytes in the surface mode. The first form ran one thread a
// lane and walked every lane twice, a count pass and then a fill pass, so
// it tested every candidate twice and wrote each lane's pairs from its own
// scattered offset. In fact the tests' instructions bound it: the
// divisions and square roots are IEEE (the beams' test is ~140
// instructions), and the rows come from L1: the 32 threads of a warp are
// 32 neighbouring pixels whose rays cross the same cells in the same
// rounds, so they read the same row at once. This design:
//   * the walk (photon_walk_kernel): a thread a masked lane, as the first
//     form, so the warp's coherent lanes still share each row load, but
//     one walk: each accepted pair goes at once to the lane's current page
//     of kPage (64) pairs, taken from a counter (ctr[1]) when the last one
//     fills, the page marked with its lane and its place among the lane's
//     pages; a pair is 16 bytes (row bits, a, b), one vector store. The
//     histogram bins in shared memory, a column of 32 a thread;
//   * the copy (photon_copy_kernel): a thread a staged pair, to the lane's
//     first pair (an exclusive scan of the lanes' totals) plus its place
//     in the lane, lane and row as int64.
// The pages are sized ahead by the wrapper (the last call's pages a lane);
// where the walk takes more than it was given, it goes on counting but
// stops writing, and the wrapper launches it again with the exact number.
// The points' foot-in-cell test compares each foot coordinate with the two
// floats that bound the visited cell (the least x with floor(x / cell) >=
// c and >= c + 1, found once a lane-round with the same IEEE division):
// exact, since x / cell rounded is monotone in x, and two comparisons
// where the first form divided three times a candidate. The beams' 1 / sin
// is computed for accepted rows only.
// A warp a lane (a round's 27 cells hashed at once, a warp scan flattening
// the candidates, 32 neighbouring rows tested at once) ran 1.1x (points)
// and 1.4x (beams) faster than the first form: each row came from L2 once
// a lane instead of once a warp of 32 lanes (the card's measurements in
// PERF.md §6).
// ptxas -v (sm_90a): the walk 56 registers for beams (12 bytes spilled),
// 48 for points (24 bytes spilled), 32 for hist (16 KB of shared memory),
// 40 for surface; the copy 22, the rounds pass 27; resident blocks per
// mode in chip_smoke.py's phase 2.
//
// Plain C interface, loaded with ctypes: photon_walk_rounds,
// photon_walk and photon_walk_copy each launch one kernel on the given
// stream and return cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxPerCell = 32;       // == MAX_PER_CELL
constexpr unsigned kGridMask = (1u << 20) - 1;  // GRID_SIZE - 1
constexpr int kMaxSteps = 96;         // == MAX_VOL_STEPS
constexpr int kBins = 32;             // == N_BINS
constexpr int kPage = 64;             // == PAGE: pairs a staging page
constexpr int kThreads = 128;
constexpr int kCopyPages = 4;         // pages a block of the copy
constexpr unsigned kFull = 0xffffffffu;

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
  int* __restrict__ ctr;         // [0] the round count, [1] the pages taken
  int* __restrict__ lane_total;  // (n,) the pairs of each lane
  int* __restrict__ page_lane;   // (cap_pages,) a page's lane
  int* __restrict__ page_idx;    // (cap_pages,) its place among the lane's pages
  int cap_pages;
  int* __restrict__ stg_row;     // surface: a row a pair, kPage a page
  float4* __restrict__ stg;      // points, beams: (row bits, a, b, 0) a pair
  int* __restrict__ hist;        // (n, kBins)
};

struct Lane {
  float o[3], d[3], lim;
  int bounce;
};

// the visited cell of a points round: cv, and per axis the floats lo, hi
// with floor(x / cell) == cv  <=>  lo <= x < hi (exact: `bounded`)
struct Visit {
  int cv[3];
  float lo[3], hi[3];
  bool bounded;
};
// the least float x with x / cell (rounded) >= c; cell > 0 and finite,
// |c| < 2^22. x / cell rounded is monotone in x, so the walk ends within
// an ulp or two of c * cell
__device__ __forceinline__ float least_at_least(float c, float cell) {
  float x = mul(c, cell);
  if (dvd(x, cell) >= c) {
    for (;;) {
      const float p = nextafterf(x, -__int_as_float(0x7f800000));
      if (!(dvd(p, cell) >= c)) return x;
      x = p;
    }
  }
  do {
    x = nextafterf(x, __int_as_float(0x7f800000));
  } while (!(dvd(x, cell) >= c));
  return x;
}

// the accept test of one candidate row; a / b: the pair's two floats (b
// of an accepted beams row only)
template <int MODE, bool BOUNDED>
__device__ __forceinline__ bool accept(const Args& g, const Lane& L, const Visit& V, int row,
                                       float& a, float& b) {
  const float* x = g.pack + static_cast<long long>(row) * g.row_w;
  const int pb = static_cast<int>(__ldg(x + (MODE == 3 ? 10 : 9)));  // the row's bounce
  const int full_b = L.bounce + pb - 1;
  const bool gate = full_b >= g.min_b && full_b < g.max_b;
  if (MODE <= 1) {  // surface, hist
    const float e[3] = {sub(__ldg(x), L.o[0]), sub(__ldg(x + 1), L.o[1]), sub(__ldg(x + 2), L.o[2])};
    a = dot3(e, e);
    return gate && a < L.lim;
  }
  if (MODE == 2) {  // points
    const float p[3] = {__ldg(x), __ldg(x + 1), __ldg(x + 2)};
    const float dv[3] = {sub(p[0], L.o[0]), sub(p[1], L.o[1]), sub(p[2], L.o[2])};
    const float t_star = pmin(pmax(dot3(dv, L.d), 0.0f), L.lim);
    bool dedup = true;
    float e[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float foot = add(L.o[k], mul(t_star, L.d[k]));
      dedup = dedup && (BOUNDED ? (foot >= V.lo[k] && foot < V.hi[k])
                                : cell_of(foot, g.cell) == V.cv[k]);
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
  const float perp = fabsf(dot3(u, hb));
  const float s_cr = dot3(bd, hb);
  a = t;
  const bool ok = perp < g.r && t > 0.0f && t < L.lim && s_cr >= 0.0f && s_cr <= b_len &&
                  s_cr >= b_s0 && s_cr < add(b_s0, g.r) && gate;
  if (ok) {
    const float cosr = dot3(L.d, bd);
    b = dvd(1.0f, __fsqrt_rn(pmax(sub(1.0f, mul(cosr, cosr)), 1e-8f)));
  }
  return ok;
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
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k == ax) {
      s.c[k] += s.stp[k];
      s.tm[k] = add(s.tm[k], s.td[k]);
    }
  }
  return best;
}

__device__ __forceinline__ void load_lane(const Args& g, int i, bool volume, Lane& L) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    L.o[k] = g.o[3 * i + k];
    L.d[k] = volume ? g.d[3 * i + k] : 0.0f;
  }
  L.lim = g.lim[i];
  L.bounce = g.bounce[i];
}

// each masked lane's own rounds (the DDA's steps while t < seg, at most
// kMaxSteps); their maximum into ctr[0]
__global__ void __launch_bounds__(kThreads) photon_rounds_kernel(Args g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int own = 0;
  if (i < g.n && g.mask[i] != 0) {
    Lane L;
    load_lane(g, i, true, L);
    Dda s;
    dda_setup(g, L, s);
    float t = 0.0f;
    while (own < kMaxSteps && t < L.lim) {
      t = dda_step(s);
      ++own;
    }
  }
  own = __reduce_max_sync(kFull, own);
  if ((threadIdx.x & 31) == 0 && own > 0) atomicMax(&g.ctr[0], own);
}


// a pair to the lane's pages: a new page every kPage pairs
template <int MODE>
__device__ __forceinline__ void emit(const Args& g, int lane, int& count, int& page, int row,
                                     float a, float b) {
  const int slot = count % kPage;
  if (slot == 0) {
    page = atomicAdd(&g.ctr[1], 1);
    if (page < g.cap_pages) {
      g.page_lane[page] = lane;
      g.page_idx[page] = count / kPage;
    }
  }
  if (page < g.cap_pages) {
    const long long at = static_cast<long long>(page) * kPage + slot;
    if (MODE >= 2) g.stg[at] = make_float4(__int_as_float(row), a, b, 0.0f);
    else g.stg_row[at] = row;
  }
  ++count;
}

// the points round's cell bounds (bounded where the cell index, the cell
// size and their product are well inside f32's range)
__device__ __forceinline__ void cell_bounds(const Args& g, const int cv[3], Visit& V) {
  const float big = 4194304.0f;  // 2^22
  V.bounded = g.cell > 1e-30f && g.cell < 1e30f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    V.cv[k] = cv[k];
    const float c = static_cast<float>(cv[k]);
    V.bounded = V.bounded && c > -big && c < big && fabsf(mul(c, g.cell)) < 1e30f;
  }
  if (!V.bounded) return;
#pragma unroll 1
  for (int j = 0; j < 6; ++j) {
    const float x = least_at_least(static_cast<float>(cv[j % 3] + j / 3), g.cell);
    if (j == 0) V.lo[0] = x;
    if (j == 1) V.lo[1] = x;
    if (j == 2) V.lo[2] = x;
    if (j == 3) V.hi[0] = x;
    if (j == 4) V.hi[1] = x;
    if (j == 5) V.hi[2] = x;
  }
}

// the rows of one hash cell, in slot order: the accept test, accepted
// pairs emitted (or binned)
template <int MODE, bool BOUNDED>
__device__ __forceinline__ void cell_rows(const Args& g, const Lane& L, const Visit& V, int lane,
                                          int start, int cnt, int& count, int& page, int* bins) {
  for (int m = 0; m < cnt; ++m) {
    float a = 0.0f, b = 0.0f;
    if (!accept<MODE, BOUNDED>(g, L, V, start + m, a, b)) continue;
    if (MODE == 1) {
      ++bins[min(static_cast<int>(mul(dvd(a, L.lim), static_cast<float>(kBins))), kBins - 1) *
             kThreads];
    } else {
      emit<MODE>(g, lane, count, page, start + m, a, b);
    }
  }
}

// one lane-round: the 27 neighbours of cell cv, of each the first
// min(count, 32) rows; the points' foot test against the cell bounds
// where they exist (always, but for cells beyond 2^22 or absurd sizes)
template <int MODE>
__device__ __forceinline__ void visit(const Args& g, const Lane& L, const int cv[3], int lane,
                                      int& count, int& page, int* bins) {
  Visit V;
  V.bounded = false;
  if (MODE == 2) cell_bounds(g, cv, V);
  for (int dx = -1; dx <= 1; ++dx) {
    for (int dy = -1; dy <= 1; ++dy) {
      for (int dz = -1; dz <= 1; ++dz) {
        const unsigned h = hash_cell(cv[0] + dx, cv[1] + dy, cv[2] + dz);
        const int start = __ldg(g.starts + h);
        const int cnt = min(__ldg(g.counts + h), kMaxPerCell);
        if (MODE != 2 || V.bounded)
          cell_rows<MODE, true>(g, L, V, lane, start, cnt, count, page, bins);
        else
          cell_rows<MODE, false>(g, L, V, lane, start, cnt, count, page, bins);
      }
    }
  }
}

// the walk: a thread a masked lane
template <int MODE>
__global__ void __launch_bounds__(kThreads) photon_walk_kernel(Args g) {
  __shared__ int s_bins[MODE == 1 ? kBins * kThreads : 1];  // bin k of thread t at k * kThreads + t
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.n || g.mask[i] == 0) return;
  int* bins = s_bins + threadIdx.x;
  if (MODE == 1) {
#pragma unroll
    for (int k = 0; k < kBins; ++k) bins[k * kThreads] = 0;
  }
  Lane L;
  load_lane(g, i, MODE >= 2, L);
  int count = 0, page = 0;
  if (MODE >= 2) {
    Dda s;
    dda_setup(g, L, s);
    for (int round = 0; round < g.rounds; ++round) {
      visit<MODE>(g, L, s.c, i, count, page, bins);
      dda_step(s);
    }
  } else {
    const int cv[3] = {cell_of(L.o[0], g.cell), cell_of(L.o[1], g.cell), cell_of(L.o[2], g.cell)};
    visit<MODE>(g, L, cv, i, count, page, bins);
  }
  if (MODE == 1) {
    int4* out = reinterpret_cast<int4*>(g.hist + static_cast<long long>(i) * kBins);
#pragma unroll
    for (int k = 0; k < kBins / 4; ++k)
      out[k] = make_int4(bins[(4 * k) * kThreads], bins[(4 * k + 1) * kThreads],
                         bins[(4 * k + 2) * kThreads], bins[(4 * k + 3) * kThreads]);
  } else {
    g.lane_total[i] = count;
  }
}

// the copy: a thread a staged pair, to its place in lane order (the lane's
// first pair, an exclusive scan of lane_total, plus its place in the lane)
__global__ void __launch_bounds__(kPage * kCopyPages) photon_copy_kernel(
    int pages, const int* __restrict__ page_lane, const int* __restrict__ page_idx,
    const int* __restrict__ lane_total, const long long* __restrict__ lane_end,
    const int* __restrict__ stg_row, const float4* __restrict__ stg,
    long long* __restrict__ lane_out, long long* __restrict__ row_out, float* __restrict__ a_out,
    float* __restrict__ b_out) {
  const int pg = blockIdx.x * kCopyPages + threadIdx.x / kPage, k = threadIdx.x % kPage;
  if (pg >= pages) return;
  const int lane = page_lane[pg], first = page_idx[pg] * kPage;
  if (first + k >= lane_total[lane]) return;
  const long long dst = lane_end[lane] - lane_total[lane] + first + k;
  const long long src = static_cast<long long>(pg) * kPage + k;
  lane_out[dst] = lane;
  if (a_out != nullptr) {
    const float4 v = stg[src];
    row_out[dst] = __float_as_int(v.x);
    a_out[dst] = v.y;
    b_out[dst] = v.z;
  } else {
    row_out[dst] = stg_row[src];
  }
}

template <int MODE>
void launch_walk(const Args& g, cudaStream_t st) {
  photon_walk_kernel<MODE><<<(g.n + kThreads - 1) / kThreads, kThreads, 0, st>>>(g);
}

}  // namespace

// ctr: 2 int32, zeroed by the caller; the round count lands in ctr[0]
extern "C" int photon_walk_rounds(const float* o, const float* d, const float* lim,
                                  const unsigned char* mask, int n, float cell, int* ctr,
                                  void* stream) {
  if (n <= 0) return 0;
  Args g{};
  g.o = o;
  g.d = d;
  g.lim = lim;
  g.mask = mask;
  g.n = n;
  g.cell = cell;
  g.ctr = ctr;
  photon_rounds_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// stg_row (surface) or stg (points, beams: 4 floats a pair) of cap_pages *
// kPage pairs; the page tables of cap_pages entries; hist (hist mode)
extern "C" int photon_walk(int mode, const float* pack, int row_w, const int* starts,
                           const int* counts, const float* o, const float* d, const float* lim,
                           const int* bounce, const unsigned char* mask, int n, float cell,
                           float r, int min_b, int max_b, int rounds, int* ctr, int* lane_total,
                           int* page_lane, int* page_idx, int cap_pages, int* stg_row, float* stg,
                           int* hist, void* stream) {
  if (n <= 0) return 0;
  const Args g{pack, row_w, starts, counts, o, d, lim, bounce, mask, n, cell, r, r * r, min_b,
               max_b, rounds, ctr, lane_total, page_lane, page_idx, cap_pages, stg_row,
               reinterpret_cast<float4*>(stg), hist};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: launch_walk<0>(g, st); break;
    case 1: launch_walk<1>(g, st); break;
    case 2: launch_walk<2>(g, st); break;
    case 3: launch_walk<3>(g, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// lane_end: the inclusive scan of lane_total (int64); a_out / b_out null
// in the surface mode
extern "C" int photon_walk_copy(int pages, const int* page_lane, const int* page_idx,
                                const int* lane_total, const long long* lane_end,
                                const int* stg_row, const float* stg, long long* lane_out,
                                long long* row_out, float* a_out, float* b_out, void* stream) {
  if (pages <= 0) return 0;
  photon_copy_kernel<<<(pages + kCopyPages - 1) / kCopyPages, kPage * kCopyPages, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      pages, page_lane, page_idx, lane_total, lane_end, stg_row,
      reinterpret_cast<const float4*>(stg), lane_out, row_out, a_out, b_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int photon_walk_blocks_per_sm(int mode) {
  int blocks = 0;
  void (*const kernels[4])(Args) = {photon_walk_kernel<0>, photon_walk_kernel<1>,
                                    photon_walk_kernel<2>, photon_walk_kernel<3>};
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernels[mode & 3], kThreads, 0);
  return blocks;
}
