// Banded elastic cost on the H100: zipped pairs and all pairs.
//
// Replaces repro/kernels/dtw_band/kernel.py::dtw_band_compressed_kernel as
// launched by make_dtw_band_call (mode="compressed", zipped pairs
// (N,L) x (N,L) -> (N,)) and by make_dtw_band_cdist_call (broadcast_b,
// all pairs (N,L) x (M,L) -> (N,M)), dtw_band_adaptive_kernel
// (mode="adaptive": zipped pairs inside per-pair corridors lo, hi
// (N, 2L-1) int32 with a register cap W -> (N,)), and dtw_band_kernel
// (mode="full", the DTW-only full-width baseline, below: one warp a pair
// up to L = 1024, one thread a pair beyond).
//
// The zipped form has two.  Where the band's 2w + 2 slots fit a register
// bucket (8, 16 or 32; for dtw also 64 and 128: dtw_band/ops.py::
// cdist_bucket) each thread sweeps one pair with the band row in
// registers (pqdtw::band_cost_reg), the k-loop unrolled; each warp owns 32
// pairs and stages their B columns in its slice of shared memory, 32 rows
// of the table at a time (dtw_band_pairs_reg_kernel).  Wider bands keep
// the earlier form, one thread a pair with the band row in shared memory
// or a wrapper-allocated scratch buffer (pqdtw::band_cost; wavefront.cuh
// says what bounds the DP and why).  Both walk the pairs grid-stride, so
// the wrapper may cap the grid, and both give the same bits.
//
// The all-pairs form (the k-means assignments, the symmetric LUT, the
// coarse search, 1-NN) has two: where the band's 2w + 2 slots fit a
// register bucket (8, 16 or 32; for dtw also 64 and 128) the band row lives in
// registers (pqdtw::band_cost_reg, the k-loop unrolled, cells off the band
// masked by selects) and each block stages its B row in shared memory;
// there each cell is about its 5-6 arithmetic instructions, where the
// shared-memory row adds a load, a store and the loop's control to each.
// Wider bands keep band_cost, consecutive threads taking consecutive rows
// of A against one row of B (a broadcast read).  The wrapper picks the
// form from w, the measure and L alone (dtw_band/ops.py::cdist_bucket);
// both give the same bits.  The N*M pairs are never materialised.
//
// The adaptive form sweeps every measure inside the pair's corridor.  Up
// to width 256 one warp sweeps a pair (dtw_band_adaptive_warp_kernel):
// the pair's rows staged in the warp's slice of shared memory, erp's
// border sums formed there by the warp in the reference's log-depth
// order, then pqdtw::corridor_cost_warp_padded<MEAS, C>, 2L-1 dependent
// diagonal steps of C slots a lane, with the clamped
// pqdtw::corridor_cost_warp<MEAS, C> for a corridor that breaks the
// invariants.  Beyond width 256 (and where a warp's rows do not fit in
// shared memory) one thread sweeps a pair with pqdtw::corridor_cost (a
// chain of (2L-1) * W slot updates: latency-bound), erp's border sums in
// the wrapper's gaps buffer.  Same bits either way.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "wavefront.cuh"

namespace {

using pqdtw::band_cost;
using pqdtw::band_row;

template <int MEAS>
__global__ void dtw_band_pairs_kernel(const float* __restrict__ A,
                                      const float* __restrict__ B,
                                      float* __restrict__ out,
                                      const float* __restrict__ wt,
                                      float* scratch, int n, int L, int w,
                                      float p) {
  float* row;
  int stride;
  band_row(scratch, &row, &stride);
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < n;
       q += step) {
    out[q] = band_cost<MEAS>(A + q * L, B + q * L, L, w, p, wt, row, stride);
  }
}

// The zipped form with the band row in registers (band_cost_reg, 2w + 2
// <= WB).  Unlike the all-pairs form, every thread's B row is its own, so
// there is no block-wide row to stage: each warp owns 32 consecutive pairs
// (grid-stride over groups of 32) and stages their B columns in its slice
// of shared memory, kPairRows rows of the table at a time (band_cost_reg's
// restage hook).  For rows [i0, i0 + kPairRows) a lane's band reads b[j]
// for j in [i0 - w - 1, i0 + kPairRows - 1 - w + WB - 2], kPairRows + WB -
// 1 columns, each the element of b clamped to the row (what the edge
// padding that band_cost_reg asks for holds).  That count is odd, so at
// that pitch the warp's 32 rows fall in 32 different banks and a cell's
// read of b[j] is conflict-free.  The lanes copy each pair's columns at
// consecutive addresses (coalesced) as asynchronous copies (cp.async), all
// in flight before the warp waits for them, so a chunk costs one round
// trip to memory, not one a pair.  a is read from device memory, one
// element a row of the table, through L1.  Nothing is synchronised beyond
// the warp, and a slice is 32 * (kPairRows + WB - 1) floats at any L (6 KB
// at WB = 16).  What bounds it: the cells' instructions, as in the
// all-pairs form, with the 2L floats a pair reads from device memory once
// (the chunks' overlap of WB - 1 columns is reread from L1).
constexpr int kPairRows = 32;

template <int MEAS, int WB>
__global__ void dtw_band_pairs_reg_kernel(const float* __restrict__ A,
                                          const float* __restrict__ B,
                                          float* __restrict__ out,
                                          const float* __restrict__ wt, int n,
                                          int L, int w, float p) {
  extern __shared__ float zs[];  // (wdtw's L weights), then a slice a warp
  constexpr int kPitch = kPairRows + WB - 1;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  float* win = zs + (MEAS == pqdtw::kWDTW ? L : 0) +
               (threadIdx.x >> 5) * 32 * kPitch;
  if (MEAS == pqdtw::kWDTW) {
    for (int k = threadIdx.x; k < L; k += blockDim.x) zs[k] = wt[k];
    __syncthreads();
  }
  const long long step = 32LL * warps * gridDim.x;
  const long long first = (long long)blockIdx.x * warps + (threadIdx.x >> 5);
  for (long long g = 32LL * first; g < n; g += step) {
    const int np = (int)min(32LL, n - g);
    const int me = min(lane, np - 1);  // a ragged group's idle lanes repeat
    const float* mine = win + me * kPitch;
    // before rows i0, i0 + kPairRows, ...: the warp copies its pairs'
    // columns [i0 - w - 1, i0 - w - 1 + kPitch) of B, clamped to the row,
    // all in flight at once (cp.async), then waits once
    auto restage = [&](int i0) -> const float* {
      const int j0 = i0 - w - 1;  // the window's first column
      __syncwarp();               // the last chunk's reads are done
      for (int pp = 0; pp < np; ++pp) {
        const float* src = B + (g + pp) * L;
        for (int e = lane; e < kPitch; e += 32)
          __pipeline_memcpy_async(&win[pp * kPitch + e],
                                  &src[min(max(j0 + e, 0), L - 1)], 4);
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncwarp();
      return mine - j0;
    };
    const float c = pqdtw::band_cost_reg<MEAS, WB>(
        A + (g + me) * L, nullptr, L, w, p, zs, 1, restage, kPairRows);
    if (lane < np) out[g + lane] = c;
  }
}

template <int MEAS>
__global__ void dtw_band_cdist_kernel(const float* __restrict__ A,
                                      const float* __restrict__ B,
                                      float* __restrict__ out,
                                      const float* __restrict__ wt,
                                      float* scratch, int N, int M, int L,
                                      int w, float p) {
  float* row;
  int stride;
  band_row(scratch, &row, &stride);
  const long long total = (long long)N * M;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       q < total; q += step) {
    const long long i = q % N;
    const long long j = q / N;
    out[i * M + j] =
        band_cost<MEAS>(A + i * L, B + j * L, L, w, p, wt, row, stride);
  }
}

// The all-pairs form with the band row in registers (band_cost_reg, for
// 2w + 2 <= WB): grid (x: rows of one operand in blocks, y: rows of the
// other, walked grid-stride).  The block stages its y row in shared memory
// with WB copies of each edge element on both sides (coalesced), so every
// thread of the block reads it as a broadcast and needs no edge test, and
// for WDTW the L weights beside it; thread t owns x row blockIdx.x *
// blockDim.x + t and reads it from device memory (once a row of the table,
// L1-cached).  The x rows are A's, or with swap B's (the wrapper gives the
// threads the longer operand, so that few queries against many series
// still fill the warps); the banded cost is symmetric to the bit (each
// cell of the swapped table is the same float32 expression of the same
// predecessors, min and the squared difference being exact under
// exchange), so either way out[i * M + j] = cost(A[i], B[j]).
template <int MEAS, int WB>
__global__ void dtw_band_cdist_reg_kernel(const float* __restrict__ A,
                                          const float* __restrict__ B,
                                          float* __restrict__ out,
                                          const float* __restrict__ wt,
                                          int N, int M, int L, int w,
                                          float p, int swap) {
  extern __shared__ float sb[];  // L + 2 * WB floats (+ L weights)
  float* sw = sb + L + 2 * WB;
  if (MEAS == pqdtw::kWDTW)
    for (int k = threadIdx.x; k < L; k += blockDim.x) sw[k] = wt[k];
  const float* X = swap ? B : A;
  const float* Y = swap ? A : B;
  const int nx = swap ? M : N, ny = swap ? N : M;
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (int y = blockIdx.y; y < ny; y += gridDim.y) {
    const float* b = Y + (long long)y * L;
    __syncthreads();  // the previous row's readers are done
    for (int k = threadIdx.x; k < L + 2 * WB; k += blockDim.x)
      sb[k] = b[min(max(k - WB, 0), L - 1)];
    __syncthreads();
    if (x < nx) {
      const float c = pqdtw::band_cost_reg<MEAS, WB>(X + x * L, sb + WB, L,
                                                     w, p, sw, 1);
      out[swap ? (long long)y * M + x : x * M + y] = c;
    }
  }
}

// ERP's border sums live in gaps (2 * L * T floats from the wrapper, T =
// gridDim.x * blockDim.x): thread g keeps the pair it sweeps at ga =
// gaps[i * T + g] and gb = gaps[(L + i) * T + g], so a warp's accesses
// coalesce and the buffer follows the grid, not the pairs; other measures
// pass none.
template <int MEAS>
__global__ void dtw_band_adaptive_kernel(const float* __restrict__ A,
                                         const float* __restrict__ B,
                                         const int* __restrict__ lo,
                                         const int* __restrict__ hi,
                                         float* __restrict__ out,
                                         const float* __restrict__ wt,
                                         float* scratch, float* gaps, int n,
                                         int L, int W, float p) {
  float* row;
  int stride;
  band_row(scratch, &row, &stride);
  const long long D = 2LL * L - 1;
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float* ga = nullptr;
  float* gb = nullptr;
  if (MEAS == pqdtw::kERP) {
    ga = gaps + g;
    gb = gaps + (size_t)L * step + g;
  }
  for (long long q = g; q < n; q += step) {
    const float* a = A + q * L;
    const float* b = B + q * L;
    if (MEAS == pqdtw::kERP) {
      pqdtw::gap_prefix_sum(a, p, L, ga, step);
      pqdtw::gap_prefix_sum(b, p, L, gb, step);
    }
    out[q] = pqdtw::corridor_cost<MEAS>(a, b, lo + q * D, hi + q * D, L, W,
                                        p, wt, ga, gb, step, row, stride);
  }
}

// A warp's slice of the adaptive warp form, in floats: [a | warp_pad(C) |
// b], then erp's border sums ga, gb.  wdtw's L weights are the block's,
// before the slices.
__host__ __device__ constexpr int adaptive_slice(int meas, int C, int L) {
  return 2 * L + pqdtw::warp_pad(C) + (meas == pqdtw::kERP ? 2 * L : 0);
}

inline size_t adaptive_warp_smem(int meas, int C, int L, int warps) {
  return ((meas == pqdtw::kWDTW ? (size_t)L : 0) +
          (size_t)warps * adaptive_slice(meas, C, L)) *
         sizeof(float);
}

// The adaptive form, one warp a pair (width <= 256, C = ceil(width / 32)
// rounded up to 1, 2, 4 or 8): the warp stages its pair in its slice as
// [a | warp_pad(C) NaNs | b], as lb_cascade.cu's adaptive refine does;
// for erp it forms the border sums after them (warp_gap_prefix_sums, the
// reference's log-depth order, so no global gaps buffer); then
// corridor_cost_warp_padded<MEAS, C>, and for a pair whose corridor breaks
// the invariants the clamped corridor_cost_warp<MEAS, C> on the same rows.
// What bounds it: per diagonal step one broadcast and one or two
// shuffles, per slot two shared-memory loads (four for msm) and the
// cell's 6 (dtw) to 28 (msm) operations, across the launch's warps:
// instructions, not bytes.
template <int MEAS, int C>
__global__ void dtw_band_adaptive_warp_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    const int* __restrict__ lo, const int* __restrict__ hi,
    float* __restrict__ out, const float* __restrict__ wt, int n, int L,
    int W, float p) {
  extern __shared__ float cs[];  // (wdtw's L weights), then a slice a warp
  constexpr int P = pqdtw::warp_pad(C);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  pqdtw::MeasureArgs m;
  m.p = p;
  if (MEAS == pqdtw::kWDTW) {
    for (int k = threadIdx.x; k < L; k += blockDim.x) cs[k] = wt[k];
    __syncthreads();
    m.wt = cs;
  }
  const long long q = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (q >= n) return;  // the whole warp: one pair per warp
  float* sa = cs + (MEAS == pqdtw::kWDTW ? L : 0) +
              (size_t)warp * adaptive_slice(MEAS, C, L);
  float* sb = sa + L + P;
  const float* a = A + q * L;
  const float* b = B + q * L;
  const float nan = __int_as_float(0x7fc00000);
  for (int k = lane; k < 2 * L + P; k += 32)
    sa[k] = k < L ? a[k] : (k < L + P ? nan : b[k - L - P]);
  if (MEAS == pqdtw::kERP) {
    float* ga = sb + L;
    __syncwarp();
    pqdtw::warp_gap_prefix_sums(sa, sb, p, L, ga, ga + L, lane);
    m.ga = ga;
    m.gb = ga + L;
  }
  __syncwarp();
  const long long D = 2LL * L - 1;
  float cost;
  if (!pqdtw::corridor_cost_warp_padded<MEAS, C>(sa, sb, lo + q * D,
                                                 hi + q * D, L, W, lane,
                                                 &cost, m))
    cost = pqdtw::corridor_cost_warp<MEAS, C>(sa, sb, lo + q * D, hi + q * D,
                                              L, W, lane, m);
  if (lane == 0) out[q] = cost;
}

// Full-width sweep: replaces dtw_band_kernel (repro/kernels/dtw_band/
// kernel.py:92, make_dtw_band_call(mode="full")), the reference's legacy
// benchmark baseline.  As there, every anti-diagonal d is swept over all
// L rows i, and the band |i - j| <= w is only a mask: a pair costs
// (2L-1) * L cell updates against band_cost's L * (2w+1), which is the
// point of keeping it (the baseline the band-compressed sweep is measured
// against).  This thread form is the wrapper's choice beyond L = 1024 (the
// warp form below takes shorter series).  One thread owns one pair and
// keeps diagonals d-1 and d-2
// (L floats each, addressed as in band_row); diagonal d overwrites d-2
// with i descending, so cell i still reads d-2's slot i-1 and d-1's
// slots i and i-1.  The cell is the reference's, contracted by XLA as
// dtw's is: __fmaf_rn(diff, diff, min(diag, horizontal, vertical)),
// clamped at 3e38, so the result equals band_cost's to the bit.  It
// reads each cell's predecessors from memory, so it is bound by that
// latency, not by HBM.
__global__ void dtw_band_full_kernel(const float* __restrict__ A,
                                     const float* __restrict__ B,
                                     float* __restrict__ out, float* scratch,
                                     int n, int L, int w) {
  float* row;
  int stride;
  band_row(scratch, &row, &stride);
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < n;
       q += step) {
    const float* a = A + q * L;
    const float* b = B + q * L;
    float* prev1 = row;                         // diagonal d-1
    float* prev2 = row + (size_t)L * stride;    // d-2, overwritten by d
    for (int i = 0; i < L; ++i) {
      prev1[(size_t)i * stride] = pqdtw::kInf;
      prev2[(size_t)i * stride] = pqdtw::kInf;
    }
    for (int d = 0; d < 2 * L - 1; ++d) {
      float h = prev1[(size_t)(L - 1) * stride];  // (i, j-1): d-1, slot i
      for (int i = L - 1; i >= 0; --i) {
        const int j = d - i;
        const float v = i > 0 ? prev1[(size_t)(i - 1) * stride]
                              : pqdtw::kInf;      // (i-1, j): d-1, slot i-1
        const float dg = i > 0 ? prev2[(size_t)(i - 1) * stride]
                               : pqdtw::kInf;     // (i-1, j-1): d-2
        float cell = pqdtw::kInf;
        if (j >= 0 && j < L && abs(i - j) <= w) {
          const float best = (d == 0) ? 0.f : fminf(fminf(dg, h), v);
          const float df = a[i] - b[j];
          cell = fminf(__fmaf_rn(df, df, best), pqdtw::kInf);
        }
        prev2[(size_t)i * stride] = cell;
        h = v;
      }
      float* t = prev1;
      prev1 = prev2;
      prev2 = t;
    }
    out[q] = prev1[(size_t)(L - 1) * stride];
  }
}

// The full-width sweep, one warp a pair (L <= 32 * C, C in 1, 2, 4, 8, 16,
// 32).  The same algorithm as dtw_band_full_kernel, every one of the L
// slots of every one of the 2L-1 diagonals computed and the band only a
// mask, as the reference kernel sweeps a diagonal as one vector over L
// lanes (kernel.py:92-125); here lane l owns rows i = l*C .. l*C + C-1 of
// every diagonal, in registers:
//
//   a[i]       loaded once;
//   b[d - i]   slid by one row a diagonal, as the reference slides its
//              reversed, zero-padded copy of b: each lane shifts its C
//              values, takes its first from lane l-1 by one shuffle, and
//              lane 0 takes b[d] (0 for d >= L);
//   d-1, d-2   two register arrays; diagonal d overwrites d-2 with c
//              descending (slot i reads d-2 only at slot i-1), and the
//              diagonals go in pairs so the arrays alternate and nothing
//              is copied.  The predecessors on slot i-1 (vertical on d-1,
//              diagonal on d-2) of a lane's first row come from lane l-1,
//              two shuffles a diagonal; lane 0 reads +inf there, or 0 at
//              d = 0: cell (0, 0) starts from 0.
//
// A slot is live where its row lies in the table and the band, rows
// max(0, d-L+1, ceil((d-w)/2)) .. min(L-1, d, floor((d+w)/2)), computed
// once a diagonal; every other slot holds +inf, as the thread form writes.
// Each live cell is the thread form's fminf(__fmaf_rn(df, df, fminf(fminf(
// dg, h), v)), kInf), so the cost equals it (and band_cost's) to the bit.
// What bounds it: about 9 instructions a slot, (2L-1) * L slots a pair
// (the instruction issue rate, not HBM: a pair reads 2L floats once); a
// pair's chain is 2L-1 diagonal steps of two shuffles and one cell.
template <int C>
__device__ __forceinline__ void full_diag(float* cur, const float* prev,
                                          float* bv, const float* ar,
                                          float b_d, int d, int L, int w,
                                          int t0, int lane) {
  constexpr unsigned kFull = 0xffffffffu;
  float ev = __shfl_up_sync(kFull, prev[C - 1], 1);  // d-1 at slot t0 - 1
  float ed = __shfl_up_sync(kFull, cur[C - 1], 1);   // d-2 at slot t0 - 1
  float eb = __shfl_up_sync(kFull, bv[C - 1], 1);    // b[d - t0]
  if (lane == 0) {
    ev = pqdtw::kInf;
    ed = d == 0 ? 0.f : pqdtw::kInf;
    eb = b_d;
  }
  const int lo = max(max(0, d - L + 1), (d - w + 1) >> 1);
  const int hi = min(min(L - 1, d), (d + w) >> 1);
  const int first = lo - t0;  // slot c is live iff 0 <= c - first < live
  const unsigned live = (unsigned)max(hi - lo + 1, 0);
#pragma unroll
  for (int c = C - 1; c >= 0; --c) {
    bv[c] = (c > 0) ? bv[c > 0 ? c - 1 : 0] : eb;
    const float h = prev[c];
    const float v = (c > 0) ? prev[c > 0 ? c - 1 : 0] : ev;
    const float dg = (c > 0) ? cur[c > 0 ? c - 1 : 0] : ed;
    const float df = ar[c] - bv[c];
    const float cell =
        fminf(__fmaf_rn(df, df, fminf(fminf(dg, h), v)), pqdtw::kInf);
    cur[c] = (unsigned)(c - first) < live ? cell : pqdtw::kInf;
  }
}

template <int C>
__global__ void dtw_band_full_warp_kernel(const float* __restrict__ A,
                                          const float* __restrict__ B,
                                          float* __restrict__ out, int n,
                                          int L, int w) {
  const int lane = threadIdx.x & 31;
  const long long q =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (q >= n) return;  // the whole warp
  const float* a = A + q * L;
  const float* b = B + q * L;
  const int t0 = lane * C;  // this lane's first row
  float ar[C], bv[C], x[C], y[C];  // x: even diagonals, y: odd
#pragma unroll
  for (int c = 0; c < C; ++c) {
    ar[c] = (t0 + c < L) ? a[t0 + c] : 0.f;
    bv[c] = 0.f;  // rows past the diagonal: masked
    x[c] = y[c] = pqdtw::kInf;  // diagonals -2 and -1
  }
  int d = 0;
  for (; d < 2 * L - 2; d += 2) {
    const float b0 = (d < L) ? b[d] : 0.f;
    const float b1 = (d + 1 < L) ? b[d + 1] : 0.f;
    full_diag<C>(x, y, bv, ar, b0, d, L, w, t0, lane);
    full_diag<C>(y, x, bv, ar, b1, d + 1, L, w, t0, lane);
  }
  full_diag<C>(x, y, bv, ar, (d < L) ? b[d] : 0.f, d, L, w, t0, lane);
  // cell (L-1, L-1): row L-1 of diagonal 2L-2
  float mine = pqdtw::kInf;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (t0 + c == L - 1) mine = x[c];
  const float cost = __shfl_sync(0xffffffffu, mine, (L - 1) / C);
  if (lane == 0) out[q] = cost;
}

// The register form of pq_dtw_band_cdist: bucket WB in {8, 16, 32} for
// every measure (64 and 128 for dtw), 2w + 2 <= WB; grid (blocks_x,
// blocks_y) with blocks_x * threads >= the threads' operand's rows (B's
// with swap, else A's).
template <int MEAS>
int launch_cdist_reg(const float* A, const float* B, float* out,
                     const float* wt, int N, int M, int L, int w, float p,
                     int bucket, int swap, int threads, int blocks_x,
                     int blocks_y, cudaStream_t s) {
  const dim3 grid(blocks_x, blocks_y);
  const size_t smem =
      (size_t)(L + 2 * bucket + (MEAS == pqdtw::kWDTW ? L : 0)) *
      sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  switch (bucket) {
    case 8:
      dtw_band_cdist_reg_kernel<MEAS, 8><<<grid, threads, smem, s>>>(
          A, B, out, wt, N, M, L, w, p, swap);
      break;
    case 16:
      dtw_band_cdist_reg_kernel<MEAS, 16><<<grid, threads, smem, s>>>(
          A, B, out, wt, N, M, L, w, p, swap);
      break;
    case 32:
      dtw_band_cdist_reg_kernel<MEAS, 32><<<grid, threads, smem, s>>>(
          A, B, out, wt, N, M, L, w, p, swap);
      break;
    case 64:
      if (MEAS != pqdtw::kDTW) return (int)cudaErrorInvalidValue;
      dtw_band_cdist_reg_kernel<pqdtw::kDTW, 64><<<grid, threads, smem, s>>>(
          A, B, out, wt, N, M, L, w, p, swap);
      break;
    case 128:
      if (MEAS != pqdtw::kDTW) return (int)cudaErrorInvalidValue;
      dtw_band_cdist_reg_kernel<pqdtw::kDTW, 128><<<grid, threads, smem, s>>>(
          A, B, out, wt, N, M, L, w, p, swap);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The zipped register form: bucket WB in {8, 16, 32} for every measure
// (64 and 128 for dtw), 2w + 2 <= WB; warps a block, each sweeping 32
// pairs at a time, grid-stride.
template <int MEAS>
int launch_pairs_reg(const float* A, const float* B, float* out,
                     const float* wt, int n, int L, int w, float p,
                     int bucket, int warps, int blocks, cudaStream_t s) {
  const size_t smem =
      ((MEAS == pqdtw::kWDTW ? (size_t)L : 0) +
       (size_t)warps * 32 * (kPairRows + bucket - 1)) *
      sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int threads = 32 * warps;
  switch (bucket) {
    case 8:
      dtw_band_pairs_reg_kernel<MEAS, 8><<<blocks, threads, smem, s>>>(
          A, B, out, wt, n, L, w, p);
      break;
    case 16:
      dtw_band_pairs_reg_kernel<MEAS, 16><<<blocks, threads, smem, s>>>(
          A, B, out, wt, n, L, w, p);
      break;
    case 32:
      dtw_band_pairs_reg_kernel<MEAS, 32><<<blocks, threads, smem, s>>>(
          A, B, out, wt, n, L, w, p);
      break;
    case 64:
      if (MEAS != pqdtw::kDTW) return (int)cudaErrorInvalidValue;
      dtw_band_pairs_reg_kernel<pqdtw::kDTW, 64><<<blocks, threads, smem, s>>>(
          A, B, out, wt, n, L, w, p);
      break;
    case 128:
      if (MEAS != pqdtw::kDTW) return (int)cudaErrorInvalidValue;
      dtw_band_pairs_reg_kernel<pqdtw::kDTW, 128><<<blocks, threads, smem,
                                                    s>>>(A, B, out, wt, n, L,
                                                         w, p);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The adaptive warp form of measure MEAS at C slots a lane.
template <int MEAS, int C>
int launch_adaptive_warp(const float* A, const float* B, const int* lo,
                         const int* hi, float* out, const float* wt, int n,
                         int L, int W, float p, int warps, int blocks,
                         cudaStream_t s) {
  const size_t smem = adaptive_warp_smem(MEAS, C, L, warps);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = dtw_band_adaptive_warp_kernel<MEAS, C>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, warps * 32, smem, s>>>(A, B, lo, hi, out, wt, n, L, W, p);
  return (int)cudaGetLastError();
}

template <int C>
int launch_adaptive_warp_measure(int measure, const float* A, const float* B,
                                 const int* lo, const int* hi, float* out,
                                 const float* wt, int n, int L, int W,
                                 float p, int warps, int blocks,
                                 cudaStream_t s) {
  switch (measure) {
    case pqdtw::kDTW:
      return launch_adaptive_warp<pqdtw::kDTW, C>(A, B, lo, hi, out, wt, n, L,
                                                  W, p, warps, blocks, s);
    case pqdtw::kWDTW:
      return launch_adaptive_warp<pqdtw::kWDTW, C>(A, B, lo, hi, out, wt, n,
                                                   L, W, p, warps, blocks, s);
    case pqdtw::kERP:
      return launch_adaptive_warp<pqdtw::kERP, C>(A, B, lo, hi, out, wt, n, L,
                                                  W, p, warps, blocks, s);
    case pqdtw::kMSM:
      return launch_adaptive_warp<pqdtw::kMSM, C>(A, B, lo, hi, out, wt, n, L,
                                                  W, p, warps, blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// bucket = 0: the shared-memory form (threads a block, the band rows in
// shared memory or scratch); else the register form with bucket slots
// (2w + 2 <= bucket), threads / 32 warps a block.  Both grid-stride.
int pq_dtw_band(const float* A, const float* B, float* out, const float* wt,
                float* scratch, int n, int L, int w, int measure, float p,
                int bucket, int threads, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bucket > 0) {
    if (w < 0 || w > L - 1 || 2 * w + 2 > bucket || threads < 32 ||
        threads % 32 != 0)
      return (int)cudaErrorInvalidValue;
    switch (measure) {
      case pqdtw::kDTW:
        return launch_pairs_reg<pqdtw::kDTW>(A, B, out, wt, n, L, w, p,
                                             bucket, threads / 32, blocks, s);
      case pqdtw::kWDTW:
        return launch_pairs_reg<pqdtw::kWDTW>(A, B, out, wt, n, L, w, p,
                                              bucket, threads / 32, blocks, s);
      case pqdtw::kERP:
        return launch_pairs_reg<pqdtw::kERP>(A, B, out, wt, n, L, w, p,
                                             bucket, threads / 32, blocks, s);
      case pqdtw::kMSM:
        return launch_pairs_reg<pqdtw::kMSM>(A, B, out, wt, n, L, w, p,
                                             bucket, threads / 32, blocks, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  const size_t smem = pqdtw::band_smem_bytes(scratch, threads, w);
  switch (measure) {
    case pqdtw::kDTW:
      dtw_band_pairs_kernel<pqdtw::kDTW><<<blocks, threads, smem, s>>>(
          A, B, out, wt, scratch, n, L, w, p);
      break;
    case pqdtw::kWDTW:
      dtw_band_pairs_kernel<pqdtw::kWDTW><<<blocks, threads, smem, s>>>(
          A, B, out, wt, scratch, n, L, w, p);
      break;
    case pqdtw::kERP:
      dtw_band_pairs_kernel<pqdtw::kERP><<<blocks, threads, smem, s>>>(
          A, B, out, wt, scratch, n, L, w, p);
      break;
    case pqdtw::kMSM:
      dtw_band_pairs_kernel<pqdtw::kMSM><<<blocks, threads, smem, s>>>(
          A, B, out, wt, scratch, n, L, w, p);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int pq_dtw_band_cdist(const float* A, const float* B, float* out,
                      const float* wt, float* scratch, int N, int M, int L,
                      int w, int measure, float p, int threads, int blocks,
                      void* stream) {
  const size_t smem = pqdtw::band_smem_bytes(scratch, threads, w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (measure) {
    case pqdtw::kDTW:
      dtw_band_cdist_kernel<pqdtw::kDTW><<<blocks, threads, smem, s>>>(
          A, B, out, wt, scratch, N, M, L, w, p);
      break;
    case pqdtw::kWDTW:
      dtw_band_cdist_kernel<pqdtw::kWDTW><<<blocks, threads, smem, s>>>(
          A, B, out, wt, scratch, N, M, L, w, p);
      break;
    case pqdtw::kERP:
      dtw_band_cdist_kernel<pqdtw::kERP><<<blocks, threads, smem, s>>>(
          A, B, out, wt, scratch, N, M, L, w, p);
      break;
    case pqdtw::kMSM:
      dtw_band_cdist_kernel<pqdtw::kMSM><<<blocks, threads, smem, s>>>(
          A, B, out, wt, scratch, N, M, L, w, p);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int pq_dtw_band_cdist_reg(const float* A, const float* B, float* out,
                          const float* wt, int N, int M, int L, int w,
                          int measure, float p, int bucket, int swap,
                          int threads, int blocks_x, int blocks_y,
                          void* stream) {
  if (w < 0 || w > L - 1 || 2 * w + 2 > bucket)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (measure) {
    case pqdtw::kDTW:
      return launch_cdist_reg<pqdtw::kDTW>(A, B, out, wt, N, M, L, w, p,
                                           bucket, swap, threads,
                                           blocks_x, blocks_y, s);
    case pqdtw::kWDTW:
      return launch_cdist_reg<pqdtw::kWDTW>(A, B, out, wt, N, M, L, w, p,
                                            bucket, swap, threads,
                                            blocks_x, blocks_y, s);
    case pqdtw::kERP:
      return launch_cdist_reg<pqdtw::kERP>(A, B, out, wt, N, M, L, w, p,
                                           bucket, swap, threads,
                                           blocks_x, blocks_y, s);
    case pqdtw::kMSM:
      return launch_cdist_reg<pqdtw::kMSM>(A, B, out, wt, N, M, L, w, p,
                                           bucket, swap, threads,
                                           blocks_x, blocks_y, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// warps = 0: the thread form, threads a block (its three diagonals in
// shared memory or scratch; gaps: 2 * L * threads * blocks floats for erp,
// else unused).  Else the warp form: warps pairs a block, one a warp,
// blocks * warps >= n, 1 <= width <= 256; scratch and gaps unused.
int pq_dtw_band_adaptive(const float* A, const float* B, const int* lo,
                         const int* hi, float* out, const float* wt,
                         float* scratch, float* gaps, int n, int L, int width,
                         int measure, float p, int threads, int blocks,
                         int warps, void* stream) {
  if (warps > 0) {
    if (width < 1 || width > 256 || warps > 32 ||
        (long long)blocks * warps < n)
      return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int need = (width + 31) / 32;
    if (need <= 1)
      return launch_adaptive_warp_measure<1>(measure, A, B, lo, hi, out, wt,
                                             n, L, width, p, warps, blocks, s);
    if (need <= 2)
      return launch_adaptive_warp_measure<2>(measure, A, B, lo, hi, out, wt,
                                             n, L, width, p, warps, blocks, s);
    if (need <= 4)
      return launch_adaptive_warp_measure<4>(measure, A, B, lo, hi, out, wt,
                                             n, L, width, p, warps, blocks, s);
    return launch_adaptive_warp_measure<8>(measure, A, B, lo, hi, out, wt, n,
                                           L, width, p, warps, blocks, s);
  }
  const size_t smem = pqdtw::state_smem_bytes(scratch, threads, 3 * width);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (measure) {
    case pqdtw::kDTW:
      dtw_band_adaptive_kernel<pqdtw::kDTW><<<blocks, threads, smem, s>>>(
          A, B, lo, hi, out, wt, scratch, gaps, n, L, width, p);
      break;
    case pqdtw::kWDTW:
      dtw_band_adaptive_kernel<pqdtw::kWDTW><<<blocks, threads, smem, s>>>(
          A, B, lo, hi, out, wt, scratch, gaps, n, L, width, p);
      break;
    case pqdtw::kERP:
      if (gaps == nullptr) return (int)cudaErrorInvalidValue;
      dtw_band_adaptive_kernel<pqdtw::kERP><<<blocks, threads, smem, s>>>(
          A, B, lo, hi, out, wt, scratch, gaps, n, L, width, p);
      break;
    case pqdtw::kMSM:
      dtw_band_adaptive_kernel<pqdtw::kMSM><<<blocks, threads, smem, s>>>(
          A, B, lo, hi, out, wt, scratch, gaps, n, L, width, p);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// cells = 0: the thread form (threads a block, its two diagonals in
// shared memory or scratch); else the warp form with C = cells rows a lane
// (32 * cells >= L), threads / 32 warps a block, one pair a warp.
int pq_dtw_band_full(const float* A, const float* B, float* out,
                     float* scratch, int n, int L, int w, int cells,
                     int threads, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cells == 0) {
    const size_t smem = pqdtw::state_smem_bytes(scratch, threads, 2 * L);
    dtw_band_full_kernel<<<blocks, threads, smem, s>>>(A, B, out, scratch, n,
                                                       L, w);
    return (int)cudaGetLastError();
  }
  if (32 * cells < L || threads % 32 != 0 ||
      (long long)blocks * (threads / 32) < n)
    return (int)cudaErrorInvalidValue;
  switch (cells) {
    case 1:
      dtw_band_full_warp_kernel<1><<<blocks, threads, 0, s>>>(A, B, out, n,
                                                              L, w);
      break;
    case 2:
      dtw_band_full_warp_kernel<2><<<blocks, threads, 0, s>>>(A, B, out, n,
                                                              L, w);
      break;
    case 4:
      dtw_band_full_warp_kernel<4><<<blocks, threads, 0, s>>>(A, B, out, n,
                                                              L, w);
      break;
    case 8:
      dtw_band_full_warp_kernel<8><<<blocks, threads, 0, s>>>(A, B, out, n,
                                                              L, w);
      break;
    case 16:
      dtw_band_full_warp_kernel<16><<<blocks, threads, 0, s>>>(A, B, out, n,
                                                               L, w);
      break;
    case 32:
      dtw_band_full_warp_kernel<32><<<blocks, threads, 0, s>>>(A, B, out, n,
                                                               L, w);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* pq_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
