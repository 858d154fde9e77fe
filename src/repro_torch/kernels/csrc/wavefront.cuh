// Banded elastic DP shared by every kernel of the port that sweeps an
// alignment table: dtw_band.cu (zipped pairs and all pairs),
// lb_cascade.cu (the refine step of the LB cascade) and prealign_encode.cu
// (segment x centroid 1-NN).  corridor_cost, at the end, is the same DP
// inside a per-pair adaptive corridor (dtw_band.cu and lb_cascade.cu).
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
// expression of band_cost: __fmaf_rn for the dtw/wdtw cell, the 3e38
// clamp after it.  So with the static band as the corridor and W at
// least its widest diagonal, the cost equals band_cost's to the bit.
//
// Storage: diagonals d, d-1 and d-2, W floats each, at diag[(k*W + t) *
// stride] (shared memory column of this thread, or global scratch, as
// band_row gives it); the three buffers rotate.  The DP reads lo[d] and
// hi[d] once per diagonal.  A pair costs (2L-1) * W slot updates, against
// band_cost's L * (2w+1) cells.  Only DTW and WDTW are swept (the
// shared-cost cell); the wrappers raise for other measures on the card.
//
// Indices into a, b and wt are clamped, so a corridor that breaks the
// structural invariants gives a wrong cost, never a fault.

template <int MEAS>
__device__ float corridor_cost(const float* __restrict__ a,
                               const float* __restrict__ b,
                               const int* __restrict__ lo,
                               const int* __restrict__ hi, int L, int W,
                               const float* __restrict__ wt, float* diag,
                               int stride) {
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
        const float h =
            (kh >= 0 && kh < W) ? diag[(o_p1 + kh) * stride] : kInf;
        const float v =
            (kv >= 0 && kv < W) ? diag[(o_p1 + kv) * stride] : kInf;
        float dg = (kd >= 0 && kd < W) ? diag[(o_p2 + kd) * stride] : kInf;
        const int i = l + t, j = d - i;
        if (i == 0 && j == 0) dg = 0.f;  // (0, 0) starts from 0 diagonally
        const float x = a[min(max(i, 0), L - 1)];
        const float y = b[min(max(j, 0), L - 1)];
        const float df = x - y;
        if (MEAS == kDTW) {
          cell = __fmaf_rn(df, df, fminf(fminf(dg, h), v));
        } else {
          cell = __fmaf_rn(wt[min(abs(i - j), L - 1)], df * df,
                           fminf(fminf(dg, h), v));
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

}  // namespace pqdtw
