// Banded elastic DP shared by every kernel of the port that sweeps an
// alignment table: dtw_band.cu (zipped pairs and all pairs),
// lb_cascade.cu (the refine step of the LB cascade) and prealign_encode.cu
// (segment x centroid 1-NN).  The forms, each bit-identical to band_cost
// on the same cells:
//
//   band_cost           one thread a pair, the band row in shared memory
//                       or scratch (wide zipped, all-pairs and prealign
//                       bands, lb_cascade beyond w = 255);
//   corridor_cost       the same DP inside a per-pair adaptive corridor,
//                       every measure (dtw_band.cu's adaptive kernel and
//                       lb_cascade.cu's beyond width 256);
//   corridor_cost_warp_padded
//                       one warp a pair inside the corridor, every measure,
//                       on staged rows (dtw_band.cu's adaptive kernel, and
//                       lb_cascade.cu's adaptive refine with dtw, up to
//                       width 256, for corridors that keep the invariants);
//   corridor_cost_warp  the same with clamped indices (its fallback for a
//                       corridor that breaks them);
//   band_cost_warp      one warp a pair in the static band, dtw
//                       (lb_cascade.cu's refine up to w = 255);
//   band_cost_reg       one thread a pair, the band row in registers
//                       (dtw_band.cu's zipped and all pairs and
//                       prealign_encode.cu's 1-NN, for narrow bands; the
//                       zipped form restages b every 32 rows).
//
// The thread forms are bound by one pair's dependent chain (hidden by
// thousands of pairs in flight) or, in registers, by instructions a cell;
// the warp forms cut the chain to 2L-1 diagonal steps.
//
// Replaces repro/kernels/dtw_band/kernel.py::wavefront_compressed, the
// band-compressed anti-diagonal sweep of the TPU kernels.  On the TPU one
// diagonal is one vector op over the lanes; on Hopper one thread owns one
// pair and sweeps its table row by row instead.  Each cell is
//
//   dtw/wdtw: c + min(pred_d, pred_h, pred_v)
//   erp/msm:  min(pred_d + c_d, pred_v + c_v, pred_h + c_h)
//
// so the order of the sweep does not change a result: every cell is the
// same float32 expression of the same predecessors as in the reference.
//
// Storage.  Row i keeps only its band cells j in [i-w, i+w] at index
// k = j - i + w of a (2w+2)-float buffer (the last slot is a permanent
// +inf sentinel).  Swept with k ascending, the update can run in place in
// one buffer: cell k reads the previous row's slot k+1 (vertical move),
// which is still unwritten, and the previous row's slot k (diagonal move),
// which the previous iteration read as its vertical predecessor and
// carries in a register.  Each cell therefore costs one buffer read and
// one buffer write.  The buffer is addressed as row[k * stride], so it can
// live in shared memory (stride = blockDim.x, conflict-free) or in a
// global scratch buffer allocated by the wrapper (stride = total threads,
// coalesced) when 2w+2 floats per thread do not fit in shared memory.
//
// What bounds it on the H100: the DP is a chain of L*(2w+1) dependent
// min/add steps per pair (2L-1 anti-diagonals of about w+1 cells in the
// reference's terms), so the card is bound by dependent arithmetic and
// shared-memory latency, not by HBM: the inputs are read once and the
// output is one float per pair.  The design answers with one independent
// pair per thread, so thousands of chains hide each other's latency.
//
// +inf is the finite stand-in 3e38 with a clamp after every cell, as in
// the reference kernel (dtw_band/kernel.py:70, :287).
//
// Rounding.  Compiled with --fmad=false, so nvcc contracts nothing on its
// own; the one line that the reference's compiler (XLA) does contract, the
// shared-cost cell c + min(...) with c = (x-y)^2 or w * (x-y)^2, is written
// as an explicit __fmaf_rn.  Distances then match the reference to the
// bit, and a near-tie argmin does not flip.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace pqdtw {

constexpr float kInf = 3.0e38f;

enum Measure : int { kDTW = 0, kWDTW = 1, kERP = 2, kMSM = 3 };

// MSM split/merge cost C(new | prev, other).
__device__ __forceinline__ float msm_move(float nw, float prev, float other,
                                          float c) {
  const bool inside = ((prev <= nw) && (nw <= other)) ||
                      ((prev >= nw) && (nw >= other));
  return inside ? c : c + fminf(fabsf(nw - prev), fabsf(nw - other));
}

// Banded elastic cost of one pair a, b (length L, band w <= L-1) under
// measure MEAS.  p: the measure's float parameter (ERP gap value, MSM
// split cost); wt: WDTW weights by |i-j| (length L), else unused.
template <int MEAS>
__device__ float band_cost(const float* __restrict__ a,
                           const float* __restrict__ b, int L, int w,
                           float p, const float* __restrict__ wt,
                           float* row, int stride) {
  const int width = 2 * w + 1;
  for (int k = 0; k <= width; ++k) row[k * stride] = kInf;
  float ga = 0.f;  // ERP: T[i, -1], the prefix sum of |a - g| through row i
  for (int i = 0; i < L; ++i) {
    const float x = a[i];
    const float xp = (i > 0) ? a[i - 1] : a[0];
    const float ga_prev = ga;  // T[i-1, -1] (0 at i = 0)
    if (MEAS == kERP) ga = ga + fabsf(x - p);
    const int k_lo = max(0, w - i);
    const int k_hi = min(2 * w, L - 1 - i + w);
    int j = i - w + k_lo;
    // Predecessors of the first cell of the row.
    float h = (MEAS == kERP && j == 0) ? ga : kInf;  // T[i, j-1]
    float dg;                                          // T[i-1, j-1]
    if (i == 0) {
      dg = 0.f;  // cell (0, 0) starts from 0 via the diagonal move
    } else if (j == 0) {
      dg = (MEAS == kERP) ? ga_prev : kInf;
    } else {
      dg = row[k_lo * stride];
    }
    float gb = 0.f;  // ERP, row 0 only: T[-1, j], prefix sum of |b - g|
    for (int k = k_lo; k <= k_hi; ++k, ++j) {
      const float y = b[j];
      float v;  // T[i-1, j]
      if (i == 0) {
        if (MEAS == kERP) {
          gb = gb + fabsf(y - p);
          v = gb;
        } else {
          v = kInf;
        }
      } else {
        v = row[(k + 1) * stride];
      }
      float cell;
      if (MEAS == kDTW) {
        const float df = x - y;
        cell = __fmaf_rn(df, df, fminf(fminf(dg, h), v));
      } else if (MEAS == kWDTW) {
        const float df = x - y;
        cell = __fmaf_rn(wt[abs(i - j)], df * df, fminf(fminf(dg, h), v));
      } else if (MEAS == kERP) {
        cell = fminf(fminf(dg + fabsf(x - y), v + fabsf(x - p)),
                     h + fabsf(y - p));
      } else {
        const float yp = (j > 0) ? b[j - 1] : b[0];
        cell = fminf(fminf(dg + fabsf(x - y), v + msm_move(x, xp, y, p)),
                     h + msm_move(y, yp, x, p));
      }
      cell = fminf(cell, kInf);
      row[k * stride] = cell;
      h = cell;
      dg = v;  // T[i-1, j] is the diagonal predecessor of (i, j+1)
    }
  }
  return row[w * stride];  // cell (L-1, L-1) sits at k = w
}

// This thread's band row for a one-pair-per-thread kernel: a column of
// the dynamic shared memory (stride blockDim.x) or, when the wrapper
// passes a scratch buffer, a column of it (stride = total threads).
__device__ __forceinline__ void band_row(float* scratch, float** row,
                                         int* stride) {
  extern __shared__ float smem[];
  if (scratch != nullptr) {
    *row = scratch + (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    *stride = gridDim.x * blockDim.x;
  } else {
    *row = smem + threadIdx.x;
    *stride = blockDim.x;
  }
}

// Dynamic shared memory for band_row: none when the rows live in scratch.
inline size_t state_smem_bytes(const float* scratch, int threads,
                               int floats) {
  return scratch != nullptr ? 0 : (size_t)threads * floats * sizeof(float);
}

inline size_t band_smem_bytes(const float* scratch, int threads, int w) {
  return state_smem_bytes(scratch, threads, 2 * w + 2);
}

// ---------------------------------------------------------------------------
// Adaptive corridor
// ---------------------------------------------------------------------------
//
// Replaces the corridor form of wavefront_compressed
// (repro/kernels/dtw_band/kernel.py, corridor=(lo, hi)), the sweep of
// dtw_band_adaptive_kernel and lb_cascade_adaptive_kernel.  The pair's
// corridor gives each anti-diagonal d its live rows i in [lo[d], hi[d]];
// diagonal d holds W slots, slot t being cell (i, j) = (lo[d] + t,
// d - lo[d] - t), live iff t <= hi[d] - lo[d] (slots t >= W do not
// exist: W caps the corridor).  Predecessors sit at slots shifted by the
// base drift, as in the reference:
//
//   (i,   j-1) on d-1 -> t + sign(s1),      s1 = lo[d] - lo[d-1]
//   (i-1, j  ) on d-1 -> t + sign(s1 - 1)
//   (i-1, j-1) on d-2 -> t + sign(s2),      s2 = lo[d] - lo[d-2] - 1
//
// (lo[-1] and lo[-2] read lo[0]), a slot outside [0, W) reading +inf.  A
// slot that is not live holds +inf, so a predecessor outside the corridor
// reads +inf whichever slot it maps to.  Each live cell is the float32
// expression of band_cost for every measure: __fmaf_rn for the dtw/wdtw
// cell, the three moves for erp and msm, the 3e38 clamp after it.  So with
// the static band as the corridor and W at least its widest diagonal, the
// dtw/wdtw cost equals band_cost's to the bit.
//
// Borders, as the reference selects them (kernel.py:269-280): MSM reads
// a[i-1] and b[j-1], element 0 standing in at the border.  ERP reads its
// virtual first column and row, T[i, -1] = ga[i] and T[-1, j] = gb[j], the
// prefix sums of |a - g| and |b - g|: at i == 0 the vertical predecessor
// is gb[j] and the diagonal gb[j-1] (0 at j == 0), at j == 0 the
// horizontal one is ga[i] and the diagonal ga[i-1].  The reference forms
// ga and gb by a log-depth scan (_prefix_sum), not a running sum, and the
// float32 sums differ, so the caller forms them with gap_prefix_sums
// below, in the reference's order, before the sweep.
//
// Storage: diagonals d, d-1 and d-2, W floats each, at diag[(k*W + t) *
// stride] (shared memory column of this thread, or global scratch, as
// band_row gives it); the three buffers rotate.  The DP reads lo[d] and
// hi[d] once per diagonal.  A pair costs (2L-1) * W slot updates, against
// band_cost's L * (2w+1) cells: one dependent chain per thread, so what
// bounds it is that chain's latency, not bytes (corridor_cost_warp below
// cuts the chain to 2L-1 steps; this thread form stays beyond width 256).
//
// Indices into a, b, wt, ga and gb are clamped, so a corridor that breaks
// the structural invariants gives a wrong cost, never a fault.

// ERP's border sums of one pair in the reference's order: g[i * gs] =
// |x[i] - p|, then the Hillis-Steele scan g[i] += g[i - s] for s = 1, 2,
// 4, ... < L, each stage reading the previous stage's values
// (repro/kernels/dtw_band/kernel.py::_prefix_sum).  Run in place with i
// descending, a stage reads g[i - s] before it writes it.
__device__ __forceinline__ void gap_prefix_sum(const float* __restrict__ x,
                                               float p, int L, float* g,
                                               size_t gs) {
  for (int i = 0; i < L; ++i) g[i * gs] = fabsf(x[i] - p);
  for (int s = 1; s < L; s *= 2)
    for (int i = L - 1; i >= s; --i) g[i * gs] = g[i * gs] + g[(i - s) * gs];
}

// The same two scans (ga of a, gb of b) by the 32 lanes of one warp, into
// its shared memory: stage s runs over chunks of 32 indices from the top
// down, each lane reading g[i] and g[i - s] before the warp writes the
// chunk, so every read sees the previous stage (below the chunk nothing
// is written yet).  Each g[i] is the same float32 sum as gap_prefix_sum's.
__device__ __forceinline__ void warp_gap_prefix_sums(const float* a,
                                                     const float* b, float p,
                                                     int L, float* ga,
                                                     float* gb, int lane) {
  for (int i = lane; i < L; i += 32) {
    ga[i] = fabsf(a[i] - p);
    gb[i] = fabsf(b[i] - p);
  }
  __syncwarp();
  for (int s = 1; s < L; s *= 2) {
    for (int base = (L - 1) & ~31; base >= 0; base -= 32) {
      const int i = base + lane;
      const bool sum = i < L && i >= s;
      float na = 0.f, nb = 0.f;
      if (sum) {
        na = ga[i] + ga[i - s];
        nb = gb[i] + gb[i - s];
      }
      __syncwarp();
      if (sum) {
        ga[i] = na;
        gb[i] = nb;
      }
      __syncwarp();
    }
  }
}

template <int MEAS>
__device__ float corridor_cost(const float* __restrict__ a,
                               const float* __restrict__ b,
                               const int* __restrict__ lo,
                               const int* __restrict__ hi, int L, int W,
                               float p, const float* __restrict__ wt,
                               const float* ga, const float* gb, size_t gs,
                               float* diag, int stride) {
  int o_cur = 0, o_p1 = W, o_p2 = 2 * W;  // slot offsets of the buffers
  for (int k = W; k < 3 * W; ++k) diag[k * stride] = kInf;
  int lo_1 = lo[0], lo_2 = lo[0];  // lo[max(d-1, 0)], lo[max(d-2, 0)]
  for (int d = 0; d < 2 * L - 1; ++d) {
    const int l = lo[d];
    const int live = min(hi[d] - l, W - 1);
    const int s1 = l - lo_1;
    const int s2 = l - lo_2 - 1;
    const int sh = (s1 > 0) - (s1 < 0);
    const int sv = (s1 - 1 > 0) - (s1 - 1 < 0);
    const int sd = (s2 > 0) - (s2 < 0);
    for (int t = 0; t < W; ++t) {
      float cell = kInf;
      if (t <= live) {
        const int kh = t + sh, kv = t + sv, kd = t + sd;
        float h = (kh >= 0 && kh < W) ? diag[(o_p1 + kh) * stride] : kInf;
        float v = (kv >= 0 && kv < W) ? diag[(o_p1 + kv) * stride] : kInf;
        float dg = (kd >= 0 && kd < W) ? diag[(o_p2 + kd) * stride] : kInf;
        const int i = l + t, j = d - i;
        const int ic = min(max(i, 0), L - 1), jc = min(max(j, 0), L - 1);
        const float x = a[ic];
        const float y = b[jc];
        if (MEAS == kERP) {
          if (i == 0) {
            v = gb[jc * gs];
            dg = (j > 0) ? gb[min(j - 1, L - 1) * gs] : 0.f;
          } else if (j == 0) {
            dg = ga[min(i - 1, L - 1) * gs];
          }
          if (j == 0) h = ga[ic * gs];
        }
        if (i == 0 && j == 0) dg = 0.f;  // (0, 0) starts from 0 diagonally
        const float df = x - y;
        if (MEAS == kDTW) {
          cell = __fmaf_rn(df, df, fminf(fminf(dg, h), v));
        } else if (MEAS == kWDTW) {
          cell = __fmaf_rn(wt[min(abs(i - j), L - 1)], df * df,
                           fminf(fminf(dg, h), v));
        } else if (MEAS == kERP) {
          cell = fminf(fminf(dg + fabsf(x - y), v + fabsf(x - p)),
                       h + fabsf(y - p));
        } else {
          const float xp = a[max(ic - 1, 0)];  // a[0] at the border
          const float yp = b[max(jc - 1, 0)];
          cell = fminf(fminf(dg + fabsf(x - y), v + msm_move(x, xp, y, p)),
                       h + msm_move(y, yp, x, p));
        }
        cell = fminf(cell, kInf);
      }
      diag[(o_cur + t) * stride] = cell;
    }
    const int spare = o_p2;
    o_p2 = o_p1;
    o_p1 = o_cur;
    o_cur = spare;
    lo_2 = lo_1;
    lo_1 = l;
  }
  return diag[o_p1 * stride];  // diagonal 2L-2: cell (L-1, L-1) in slot 0
}

// ---------------------------------------------------------------------------
// One warp per pair inside the corridor (every measure)
// ---------------------------------------------------------------------------
//
// corridor_cost<MEAS> swept by the 32 lanes of one warp together: slot t
// of diagonal d is lane t / C, register t % C (32 * C >= W), so a pair
// costs 2L-1 dependent diagonal steps of C cells a lane.  The shifts
// sign(s1), sign(s1 - 1) and sign(s2) belong to the pair, so they are
// uniform across the warp: diagonal d-1 is read at shifts {sh, sv}, which
// never differ in sign and are never both 0 ({1, 0} or {0, -1} for a
// valid corridor), and d-2 at sd.  One shuffle of d-1's boundary register
// in direction e1 (sh if nonzero, else sv) and one of d-2's in direction
// sd bring the one neighbouring slot that lies in another lane; no lane
// diverges.  lo[d] and hi[d] are loaded 32 diagonals at a time,
// one a lane, and broadcast by shuffle.  Non-live slots hold +inf, every
// live cell is corridor_cell<MEAS> of the same predecessors, elements and
// borders as corridor_cost's, with the same clamped indices, and fminf is
// exact and order-free, so the cost equals corridor_cost<MEAS>'s to the
// bit, for any corridor.  a, b (and the measure's wt, ga, gb) may point to
// shared memory (staged rows) or to device memory.  Every lane returns the
// cost of cell (L-1, L-1), slot 0 of diagonal 2L-2.

// What a measure reads besides a and b: p (erp's gap value, msm's split
// cost), wt (wdtw's L weights by |i - j|), ga and gb (erp's border sums,
// L floats each, formed as gap_prefix_sum forms them).  A measure ignores
// what it does not use; dtw uses none.
struct MeasureArgs {
  float p = 0.f;
  const float* wt = nullptr;
  const float* ga = nullptr;
  const float* gb = nullptr;
};

// corridor_cost's float32 cell of measure MEAS from its predecessors h
// (i, j-1), v (i-1, j), dg (i-1, j-1), the elements x = a[i], y = b[j],
// msm's xp = a[i-1] and yp = b[j-1] (element 0 at the border) and wdtw's
// weight wgt, clamped at +inf.
template <int MEAS>
__device__ __forceinline__ float corridor_cell(float x, float y, float xp,
                                               float yp, float h, float v,
                                               float dg, float wgt, float p) {
  float cell;
  if (MEAS == kDTW) {
    const float df = x - y;
    cell = __fmaf_rn(df, df, fminf(fminf(dg, h), v));
  } else if (MEAS == kWDTW) {
    const float df = x - y;
    cell = __fmaf_rn(wgt, df * df, fminf(fminf(dg, h), v));
  } else if (MEAS == kERP) {
    cell = fminf(fminf(dg + fabsf(x - y), v + fabsf(x - p)),
                 h + fabsf(y - p));
  } else {
    cell = fminf(fminf(dg + fabsf(x - y), v + msm_move(x, xp, y, p)),
                 h + msm_move(y, yp, x, p));
  }
  return fminf(cell, kInf);
}

// ERP's border predecessors of cell (i, j) as corridor_cost selects them
// (ic, jc: i and j clamped to the table).
__device__ __forceinline__ void erp_borders(int i, int j, int ic, int jc,
                                            int L, const MeasureArgs& m,
                                            float& h, float& v, float& dg) {
  if (i == 0) {
    v = m.gb[jc];
    dg = (j > 0) ? m.gb[min(j - 1, L - 1)] : 0.f;
  } else if (j == 0) {
    dg = m.ga[min(i - 1, L - 1)];
  }
  if (j == 0) h = m.ga[ic];
}

// reg[c + s] across the lanes, s in {-1, 0, 1}: edge is the neighbour
// lane's boundary register (lane + s), +inf beyond the warp.
template <int C>
__device__ __forceinline__ float slot_at(const float* reg, int c, int s,
                                         float edge) {
  const float up = (c < C - 1) ? reg[c < C - 1 ? c + 1 : 0] : edge;
  const float down = (c > 0) ? reg[c > 0 ? c - 1 : 0] : edge;
  return s == 0 ? reg[c] : (s > 0 ? up : down);
}

// The neighbour lane's boundary register for shift s (+inf off the warp).
template <int C>
__device__ __forceinline__ float lane_edge(const float* reg, int s,
                                           int lane) {
  const float mine = s > 0 ? reg[0] : reg[C - 1];
  const int src = lane + s;
  const float got = __shfl_sync(0xffffffffu, mine, src & 31);
  return (src < 0 || src > 31) ? kInf : got;
}

template <int MEAS, int C>
__device__ float corridor_cost_warp(const float* a, const float* b,
                                    const int* __restrict__ lo,
                                    const int* __restrict__ hi, int L, int W,
                                    int lane, MeasureArgs m) {
  const int t0 = lane * C;  // this lane's first slot
  float cur[C], p1[C], p2[C];
#pragma unroll
  for (int c = 0; c < C; ++c) p1[c] = p2[c] = kInf;
  const int D = 2 * L - 1;
  int lo_1 = lo[0], lo_2 = lo[0];
  for (int d0 = 0; d0 < D; d0 += 32) {
    const int dl = min(d0 + lane, D - 1);
    const int lo_r = lo[dl], hi_r = hi[dl];
    const int nd = min(32, D - d0);
    for (int k = 0; k < nd; ++k) {
      const int d = d0 + k;
      const int l = __shfl_sync(0xffffffffu, lo_r, k);
      const int live = min(__shfl_sync(0xffffffffu, hi_r, k) - l, W - 1);
      const int s1 = l - lo_1;
      const int s2 = l - lo_2 - 1;
      const int sh = (s1 > 0) - (s1 < 0);
      const int sv = (s1 - 1 > 0) - (s1 - 1 < 0);
      const int sd = (s2 > 0) - (s2 < 0);
      const int e1 = sh != 0 ? sh : sv;
      const float edge1 = lane_edge<C>(p1, e1, lane);
      const float edge2 = lane_edge<C>(p2, sd, lane);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int t = t0 + c;
        float h = slot_at<C>(p1, c, sh, edge1);
        float v = slot_at<C>(p1, c, sv, edge1);
        float dg = slot_at<C>(p2, c, sd, edge2);
        const int i = l + t, j = d - i;
        const int ic = min(max(i, 0), L - 1), jc = min(max(j, 0), L - 1);
        if (MEAS == kERP) erp_borders(i, j, ic, jc, L, m, h, v, dg);
        if (i == 0 && j == 0) dg = 0.f;
        float xp = 0.f, yp = 0.f, wgt = 0.f;
        if (MEAS == kMSM) {
          xp = a[max(ic - 1, 0)];  // a[0] at the border
          yp = b[max(jc - 1, 0)];
        }
        if (MEAS == kWDTW) wgt = m.wt[min(abs(i - j), L - 1)];
        const float cell =
            corridor_cell<MEAS>(a[ic], b[jc], xp, yp, h, v, dg, wgt, m.p);
        cur[c] = (t <= live) ? cell : kInf;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        p2[c] = p1[c];
        p1[c] = cur[c];
      }
      lo_2 = lo_1;
      lo_1 = l;
    }
  }
  return __shfl_sync(0xffffffffu, p1[0], 0);  // slot 0 of diagonal 2L-2
}

// ---------------------------------------------------------------------------
// The warp sweep on staged rows, for corridors that keep the invariants
// ---------------------------------------------------------------------------
//
// A corridor as core/corridor.py builds it has lo[0] = 0, drift s1 =
// lo[d] - lo[d-1] in {0, 1}, each diagonal's base cell (lo[d], d - lo[d])
// in the table, and its live cells too (lo[d] + live <= min(d, L-1)).
// Then (0, 0) is slot 0 of diagonal 0 alone, a live cell never leaves the
// table, and a slot past the live ones reads at most 32C - 1 floats beyond
// the end of a or before the start of b.  corridor_cost_warp_padded takes
// a and b from one staged buffer [a | warp_pad(C) floats | b], so it
// clamps no element index (a non-live slot's read lands in the pad, and
// its cell is masked); it peels diagonal 0, so no cell tests for (0, 0);
// and the pair's shifts (s1, s2) take six values (s2 = lo[d] - lo[d-2] - 1
// in {-1, 0, 1}), so a warp-uniform branch a diagonal picks a body that
// reads its predecessors with no select: h at slot t + s1, v at t + s1 -
// 1, dg at t + s2.  The lanes check the invariants as they load lo and hi,
// 32 diagonals at a time, and pack each diagonal's live count and case
// into one int, broadcast by one shuffle a diagonal; lo[d] itself is
// carried as a running sum of s1.  Where a diagonal breaks the invariants
// the function returns false at once and the caller sweeps the pair again
// with corridor_cost_warp.  Where it returns true its cost is
// corridor_cost_warp's to the bit: the same live cells from the same
// elements, the same float32 expression, +inf elsewhere.
//
// The measures beyond dtw:
//   msm reads a[i-1] and b[j-1] through max(i-1, 0) and max(j-1, 0), so
//       at i = 0 or j = 0 a live cell reads element 0, as corridor_cost
//       does, and never the pad before b or the word before a (before the
//       warp's slice: at warp 0, before shared memory).  The term that
//       reads it adds to a +inf predecessor there (T[-1, j] or T[i, -1]),
//       so the select keeps the read in bounds; the bits would not move;
//   wdtw reads wt[min(|i - j|, L - 1)];
//   erp's border predecessors (erp_borders, indices clamped as in
//       corridor_cost) matter only on a diagonal where some slot of the
//       warp has i = 0 (lo[d] = 0) or j = 0 (d - lo[d] < 32C): the lanes
//       flag such a diagonal in the packed int, and only its body tests
//       i and j; the diagonals past them take the plain body.
// Diagonal 0's one live cell (0, 0) is corridor_cell with dg = 0, h = v =
// +inf (erp: h = ga[0], v = gb[0]), as corridor_cost_warp forms it.

// One diagonal: slot t = t0 + c at row i0 + c, column j0 - c; the
// predecessors of diagonal d-1 (p1) at shifts S1 and S1 - 1, of d-2 (p2)
// at SD, one shuffle each for the slot that lies in the next lane;
// BORDER: erp's border predecessors.
template <int MEAS, int C, int S1, int SD, bool BORDER>
__device__ __forceinline__ void corridor_diag(float* cur, const float* p1,
                                              const float* p2, const float* a,
                                              const float* b, int i0, int j0,
                                              int live, int t0, int lane,
                                              int L, const MeasureArgs& m) {
  constexpr unsigned kFull = 0xffffffffu;
  float e1, e2 = kInf;
  if (S1 == 1) {
    e1 = __shfl_down_sync(kFull, p1[0], 1);
    if (lane == 31) e1 = kInf;
  } else {
    e1 = __shfl_up_sync(kFull, p1[C - 1], 1);
    if (lane == 0) e1 = kInf;
  }
  if (SD == 1) {
    e2 = __shfl_down_sync(kFull, p2[0], 1);
    if (lane == 31) e2 = kInf;
  } else if (SD == -1) {
    e2 = __shfl_up_sync(kFull, p2[C - 1], 1);
    if (lane == 0) e2 = kInf;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float up1 = (c < C - 1) ? p1[c < C - 1 ? c + 1 : 0] : e1;
    const float dn1 = (c > 0) ? p1[c > 0 ? c - 1 : 0] : e1;
    float h = S1 == 1 ? up1 : p1[c];
    float v = S1 == 1 ? p1[c] : dn1;
    float dg = p2[c];
    if (SD == 1) dg = (c < C - 1) ? p2[c < C - 1 ? c + 1 : 0] : e2;
    if (SD == -1) dg = (c > 0) ? p2[c > 0 ? c - 1 : 0] : e2;
    const int i = i0 + c, j = j0 - c;
    if (BORDER)
      erp_borders(i, j, min(max(i, 0), L - 1), min(max(j, 0), L - 1), L, m,
                  h, v, dg);
    float xp = 0.f, yp = 0.f, wgt = 0.f;
    if (MEAS == kMSM) {
      xp = a[max(i - 1, 0)];
      yp = b[max(j - 1, 0)];
    }
    if (MEAS == kWDTW) wgt = m.wt[min(abs(i - j), L - 1)];
    const float cell =
        corridor_cell<MEAS>(a[i], b[j], xp, yp, h, v, dg, wgt, m.p);
    cur[c] = (t0 + c <= live) ? cell : kInf;
  }
}

// The body of one diagonal for its case code = 3 * s1 + s2 + 1.
template <int MEAS, int C, bool BORDER>
__device__ __forceinline__ void corridor_case(int code, float* cur,
                                              const float* p1,
                                              const float* p2, const float* a,
                                              const float* b, int i0, int j0,
                                              int live, int t0, int lane,
                                              int L, const MeasureArgs& m) {
  switch (code) {
    case 0:
      corridor_diag<MEAS, C, 0, -1, BORDER>(cur, p1, p2, a, b, i0, j0, live,
                                            t0, lane, L, m);
      break;
    case 1:
      corridor_diag<MEAS, C, 0, 0, BORDER>(cur, p1, p2, a, b, i0, j0, live,
                                           t0, lane, L, m);
      break;
    case 2:
      corridor_diag<MEAS, C, 0, 1, BORDER>(cur, p1, p2, a, b, i0, j0, live,
                                           t0, lane, L, m);
      break;
    case 3:
      corridor_diag<MEAS, C, 1, -1, BORDER>(cur, p1, p2, a, b, i0, j0, live,
                                            t0, lane, L, m);
      break;
    case 4:
      corridor_diag<MEAS, C, 1, 0, BORDER>(cur, p1, p2, a, b, i0, j0, live,
                                           t0, lane, L, m);
      break;
    default:
      corridor_diag<MEAS, C, 1, 1, BORDER>(cur, p1, p2, a, b, i0, j0, live,
                                           t0, lane, L, m);
      break;
  }
}

template <int MEAS, int C>
__device__ bool corridor_cost_warp_padded(const float* a, const float* b,
                                          const int* __restrict__ lo,
                                          const int* __restrict__ hi, int L,
                                          int W, int lane, float* cost,
                                          MeasureArgs m) {
  constexpr unsigned kFull = 0xffffffffu;
  // the packed int: live << kShift | erp's border flag << 3 | case code
  constexpr int kShift = MEAS == kERP ? 4 : 3;
  const int t0 = lane * C;  // this lane's first slot
  const int D = 2 * L - 1;
  // cell (0, 0): corridor_cost_warp's cell with dg = 0, h = v = +inf
  float h00 = kInf, v00 = kInf;
  if (MEAS == kERP) {
    h00 = m.ga[0];
    v00 = m.gb[0];
  }
  const float c00 = corridor_cell<MEAS>(a[0], b[0], a[0], b[0], h00, v00, 0.f,
                                        MEAS == kWDTW ? m.wt[0] : 0.f, m.p);
  float cur[C], p1[C], p2[C];
  int l = 0;  // lo[d], carried
  for (int d0 = 0; d0 < D; d0 += 32) {
    const int dl = d0 + lane;
    bool ok = true;
    int pk = 0;
    if (dl < D) {
      const int ld = lo[dl];
      const int s1 = ld - lo[max(dl - 1, 0)];
      const int s2 = ld - lo[max(dl - 2, 0)] - 1;
      const int live = max(min(hi[dl] - ld, W - 1), -1);
      ok = ld >= 0 && ld <= min(dl, L - 1) && dl - ld <= L - 1 &&
           (dl == 0 ? ld == 0 : (s1 == 0 || s1 == 1)) &&
           ld + live <= min(dl, L - 1);
      pk = live * (1 << kShift) + 3 * s1 + s2 + 1;
      if (MEAS == kERP && (ld == 0 || dl - ld < 32 * C)) pk += 8;
    }
    if (!__all_sync(kFull, ok)) return false;
    const int nd = min(32, D - d0);
    int k = 0;
    if (d0 == 0) {  // diagonal 0
      const bool live0 = (__shfl_sync(kFull, pk, 0) >> kShift) >= 0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        p1[c] = (t0 + c == 0 && live0) ? c00 : kInf;
        p2[c] = kInf;
      }
      k = 1;
    }
    for (; k < nd; ++k) {
      const int q = __shfl_sync(kFull, pk, k);
      const int live = q >> kShift;
      const int code = q & 7;
      l += code >= 3;
      const int i0 = l + t0, j0 = d0 + k - l - t0;
      if (MEAS == kERP && (q & 8))
        corridor_case<MEAS, C, true>(code, cur, p1, p2, a, b, i0, j0, live,
                                     t0, lane, L, m);
      else
        corridor_case<MEAS, C, false>(code, cur, p1, p2, a, b, i0, j0, live,
                                      t0, lane, L, m);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        p2[c] = p1[c];
        p1[c] = cur[c];
      }
    }
  }
  *cost = __shfl_sync(kFull, p1[0], 0);  // slot 0 of diagonal 2L-2
  return true;
}

// ---------------------------------------------------------------------------
// One warp per pair: the band's anti-diagonals across the lanes
// ---------------------------------------------------------------------------
//
// The same banded DTW as band_cost<kDTW>, swept by the 32 lanes of one
// warp together, so that one pair costs 2L-1 dependent diagonal steps
// instead of L*(2w+1) dependent cells.  Diagonal d holds the band cells
// (i, d-i) with |2i - d| <= w; slot s of d is row i = i0(d) + s with
// base row i0(d) = ceil((d-w)/2), so a diagonal has w+1 slots when d-w
// is even and w when it is odd.  Lane l keeps slots l*C .. l*C+C-1 in
// registers (C cells a lane, 32*C >= w+1).
//
// The base row moves by delta = (d-w) & 1 from d-1 to d, and by exactly
// one from d-2 to d, so the predecessors of slot s are
//
//   (i,   j-1) on d-1: slot s + delta
//   (i-1, j  ) on d-1: slot s + delta - 1
//   (i-1, j-1) on d-2: slot s
//
// delta alternates with d, so the sweep takes diagonals in pairs with
// delta a template constant in each: one shuffle a diagonal brings the
// one neighbouring slot that lies in another lane (left for delta 0,
// right for delta 1), and no select depends on it.  Diagonal d overwrites
// d-2 in place (slot s reads d-2 only at slot s), so two register arrays
// alternate and nothing is copied.  A slot outside the band or the table
// holds +inf (3e38), as band_cost's sentinel and initial rows do; cell
// (0, 0) starts from 0, planted in diagonal -2.  Every cell is
// band_cost's float32 expression, fminf(__fmaf_rn(df, df, fminf(fminf(
// dg, h), v)), kInf); fminf is exact and order-free, so the cost equals
// band_cost's to the bit.
//
// PADDED: a and b point into rows padded with NaN on both sides by
// warp_pad(C) floats (the caller stages them so in shared memory).  A cell
// outside the table then reads a NaN, its fused multiply-add is NaN, and
// fminf(NaN, 3e38) = 3e38: the table's edge costs no test.  Otherwise a
// and b are the bare rows (device memory) and the indices are clamped and
// tested.  Every lane returns the cost of cell (L-1, L-1), on diagonal
// 2L-2.  Needs w <= L-1 and w + 1 <= 32 * C.

// NaN floats the caller stages on each side of a row for PADDED sweeps.
__host__ __device__ constexpr int warp_pad(int C) { return 32 * C; }

template <int C, int DELTA, bool PADDED>
__device__ __forceinline__ void warp_diag(float* cur, const float* nb,
                                          const float* a, const float* b,
                                          int L, int w, int d, int i0, int s0,
                                          int lane) {
  constexpr unsigned kFull = 0xffffffffu;
  // the neighbour slot in the next lane: s0 - 1 (delta 0) or s0 + C
  float edge;
  if (DELTA == 0) {
    edge = __shfl_up_sync(kFull, nb[C - 1], 1);
    if (lane == 0) edge = kInf;
  } else {
    edge = __shfl_down_sync(kFull, nb[0], 1);
    if (lane == 31) edge = kInf;
  }
  const int i_base = i0 + s0;
  const int j_base = d - i_base;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float h, v;
    if (DELTA == 0) {
      h = nb[c];
      v = (c > 0) ? nb[c > 0 ? c - 1 : 0] : edge;
    } else {
      h = (c < C - 1) ? nb[c < C - 1 ? c + 1 : 0] : edge;
      v = nb[c];
    }
    const int i = i_base + c;
    const int j = j_base - c;
    float x, y;
    bool in_table = true;
    if (PADDED) {
      x = a[i];
      y = b[j];
    } else {
      in_table = i >= 0 && i < L && j >= 0 && j < L;
      x = a[min(max(i, 0), L - 1)];
      y = b[min(max(j, 0), L - 1)];
    }
    const float df = x - y;
    const float cell =
        fminf(__fmaf_rn(df, df, fminf(fminf(cur[c], h), v)), kInf);
    const bool live = in_table && s0 + c < w + 1 - DELTA;
    cur[c] = live ? cell : kInf;
  }
}

// Diagonals 0 .. 2L-2 in pairs (even d: delta DE, odd d: DO = 1 - DE);
// x ends holding diagonal 2L-2.
template <int C, int DE, bool PADDED>
__device__ __forceinline__ void warp_sweep(float* x, float* y,
                                           const float* a, const float* b,
                                           int L, int w, int s0, int lane) {
  int i0 = (1 - w) >> 1;  // i0(0) = ceil(-w/2), arithmetic shift
  int d = 0;
  for (; d < 2 * L - 2; d += 2, ++i0) {
    warp_diag<C, DE, PADDED>(x, y, a, b, L, w, d, i0, s0, lane);
    warp_diag<C, 1 - DE, PADDED>(y, x, a, b, L, w, d + 1, i0 + 1 - DE, s0,
                                 lane);
  }
  warp_diag<C, DE, PADDED>(x, y, a, b, L, w, d, i0, s0, lane);
}

template <int C, bool PADDED>
__device__ float band_cost_warp(const float* a, const float* b, int L, int w,
                                int lane) {
  const int s0 = lane * C;  // this lane's first slot
  float x[C], y[C];  // even and odd diagonals
#pragma unroll
  for (int c = 0; c < C; ++c) {
    x[c] = (s0 + c == (w >> 1)) ? 0.f : kInf;  // diagonal -2: (0, 0)'s start
    y[c] = kInf;                               // diagonal -1
  }
  if (w & 1)
    warp_sweep<C, 1, PADDED>(x, y, a, b, L, w, s0, lane);
  else
    warp_sweep<C, 0, PADDED>(x, y, a, b, L, w, s0, lane);
  // cell (L-1, L-1): slot L-1 - i0(2L-2) of the last diagonal
  const int s_end = (L - 1) - ((2 * L - 1 - w) >> 1);
  float mine = kInf;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (s0 + c == s_end) mine = x[c];
  return __shfl_sync(0xffffffffu, mine, s_end / C);
}

// ---------------------------------------------------------------------------
// The band row in registers (narrow bands)
// ---------------------------------------------------------------------------
//
// band_cost with the row held in a register array of WB slots (WB a
// compile-time bucket, 2w + 2 <= WB) in place of shared memory: one thread
// still owns one pair, but the k-loop is unrolled over all WB slots, so
// each cell is register arithmetic plus one broadcast load of b[j], and a
// cell outside the table or the band keeps its slot by a select, not by a
// loop bound.  The sweep, the predecessors and every float32 expression
// are band_cost's, so the cost equals band_cost's to the bit, for every
// measure:
//
//   cell k of row i (j = i - w + k) sits in slot k; its diagonal
//   predecessor is the old slot k, the vertical one the old slot k + 1,
//   the horizontal one the new slot k - 1 (+inf at k = 0).  Written in
//   place with k ascending, as band_cost does; slot 2w + 1 stays +inf.
//
// Row -1 is planted before the sweep: T[-1, -1] = 0 in slot w starts cell
// (0, 0), every other slot is +inf.  ERP's borders, summed left to right
// as band_cost sums them, enter by selects on the row's first cell (its
// horizontal predecessor T[i, -1] = ga[i] and its diagonal one ga[i-1]
// where j = 0 lies in the row) and on row 0 (vertical T[-1, j] = gb[j],
// diagonal gb[j-1]), so no register is indexed by a runtime value: an
// array indexed so would live in local memory.
//
// a[i] sits at a[i * as]: as = 1 for a row of its own, or the codebook's
// K for a centroid of a codebook stored (M, S, K), so that the threads of
// a warp, one centroid each, read a row's elements at consecutive
// addresses.  b points at a row padded on both sides by WB copies of its edge
// elements (the caller stages it so in shared memory), so b[j] needs no
// test and MSM's b[j-1] at j = 0 reads b[0], band_cost's sentinel.  wt:
// WDTW's weights by |i - j| = |w - k| (the caller stages them in shared
// memory beside the row).
//
// Chunked sweep: a caller may pass a restage functor and a row count; then
// before rows 0, rows, 2 rows, ... it calls b = restage(i) and reads b[j]
// for rows [i, i + rows) only in [i - w - 1, i + rows - 1 - w + WB - 2]
// (dtw_band.cu's zipped pairs restage their B columns so).  Without one
// (NoRestage) that test is compiled out.

struct NoRestage {
  __device__ const float* operator()(int) const { return nullptr; }
};

template <int MEAS, int WB, class Restage = NoRestage>
__device__ float band_cost_reg(const float* __restrict__ a, const float* b,
                               int L, int w, float p, const float* wt,
                               int as, Restage restage = Restage{},
                               int rows = 0) {
  constexpr bool kChunked = !std::is_same<Restage, NoRestage>::value;
  float r[WB];
#pragma unroll
  for (int s = 0; s < WB; ++s) r[s] = (s == w) ? 0.f : kInf;
  float ga = 0.f;
  int next = 0;  // the next row at which to restage
  for (int i = 0; i < L; ++i) {
    if (kChunked && i == next) {
      b = restage(i);
      next += rows;
    }
    const float x = a[(size_t)i * as];
    const float xp = (i > 0) ? a[(size_t)(i - 1) * as] : a[0];
    const float ga_prev = ga;
    if (MEAS == kERP) ga = ga + fabsf(x - p);
    const int k_lo = max(0, w - i);
    const int k_hi = min(2 * w, L - 1 - i + w);
    const float* bj = b + (i - w);  // bj[k] = b[j] of cell k
    // ERP: the first cell's border predecessors where j = 0 is in the row
    const int k_col = (i <= w) ? k_lo : -1;
    const int k_dcol = (i >= 1 && i <= w) ? k_lo : -1;
    float gb = 0.f;  // ERP, row 0: T[-1, j]
#pragma unroll
    for (int k = 0; k < WB - 1; ++k) {
      float dg = r[k];
      float v = r[k + 1];
      float h = (k > 0) ? r[k > 0 ? k - 1 : 0] : kInf;
      const float y = bj[k];
      if (MEAS == kERP) {
        const bool live = k >= k_lo && k <= k_hi;
        if (i == 0) {
          dg = (k == w) ? 0.f : gb;       // T[-1, j-1]
          gb = live ? gb + fabsf(y - p) : gb;
          v = gb;                         // T[-1, j]
        }
        h = (k == k_col) ? ga : h;
        dg = (k == k_dcol) ? ga_prev : dg;
      }
      float cell;
      if (MEAS == kDTW) {
        const float df = x - y;
        cell = __fmaf_rn(df, df, fminf(fminf(dg, h), v));
      } else if (MEAS == kWDTW) {
        const float df = x - y;
        cell = __fmaf_rn(wt[min(abs(w - k), L - 1)], df * df,
                         fminf(fminf(dg, h), v));
      } else if (MEAS == kERP) {
        cell = fminf(fminf(dg + fabsf(x - y), v + fabsf(x - p)),
                     h + fabsf(y - p));
      } else {
        const float yp = bj[k - 1];
        cell = fminf(fminf(dg + fabsf(x - y), v + msm_move(x, xp, y, p)),
                     h + msm_move(y, yp, x, p));
      }
      cell = fminf(cell, kInf);
      r[k] = (k >= k_lo && k <= k_hi) ? cell : r[k];
    }
  }
  float out = kInf;
#pragma unroll
  for (int s = 0; s < WB; ++s) out = (s == w) ? r[s] : out;
  return out;  // cell (L-1, L-1) sits at k = w
}

}  // namespace pqdtw
