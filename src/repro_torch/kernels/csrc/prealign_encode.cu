// Fused MODWT pre-alignment + elastic 1-NN encode on the H100.
//
// Replaces repro/kernels/prealign_encode/kernel.py::prealign_encode_kernel
// (launched by make_prealign_encode_call): X (N, D) against centroids
// (M, K, S) -> codes (N, M) int32, equal to modwt.prealign followed by an
// exact per-subspace 1-NN scan, first index on ties.
//
// One block per series.  Everything before the scan lives in shared
// memory, so the (N, M, S) segment tensor never reaches device memory:
//   1. Haar MODWT scale recursion: `level` circular halvings
//      v_j[i] = 0.5 * (v_{j-1}[i] + v_{j-1}[i - 2^(j-1) mod D]);
//   2. signs of x - v_J, zeros forward-filled with the previous nonzero
//      sign, and change points where consecutive signs differ;
//   3. each interior split l = m*(D/M) snaps to the right-most change
//      point in [l - tail, l] (never position 0);
//   4. every segment is re-interpolated to S points on the lerp grid
//      `lin` (built on the host by jnp.linspace's float32 formula).
// Then, per subspace, every thread sweeps its own centroids against the
// segment, and an argmin keeps the lowest index among equal distances.
// Two forms of that step, the wrapper picking by the band alone
// (prealign_encode/ops.py::encode_geometry):
//
//   register form (2w + 2 fits a register bucket WB: 8, 16, 32; for dtw
//   also 64 and 128), row 2's design: step 4 writes each segment padded by
//   WB copies of its edge elements, and each thread sweeps its centroid
//   against it with pqdtw::band_cost_reg<MEAS, WB>, the centroid as the
//   thread's operand (one load a row, the codebook given as (M, S, K) so
//   that a warp's loads of a row coalesce) and the staged segment as the
//   broadcast row.  This is the cost of (centroid, segment), the table
//   transposed: the banded cost is symmetric to the bit for every measure
//   (each cell the same float32 expression of the same predecessors; see
//   dtw_band.cu's register form), so the codes do not move.  The argmin
//   is a shuffle butterfly in each warp and one pass over the warps'
//   winners, one __syncthreads a subspace (the winners double-buffered).
//
//   shared-memory form (wider bands): pqdtw::band_cost, the band row in
//   shared memory, the centroid read from (M, K, S) at every cell, and a
//   block tree argmin.
//
// What bounds it on the H100: the DP's instructions, about K*M*S*(2w+1)
// cells a series (the register form spends its arithmetic, a broadcast
// load and a select a cell; the shared-memory form adds a load, a store
// and the loop's control, and a strided load of b[j] from L2); the
// pre-alignment is O(D * level) per series and the centroids (M*K*S
// floats, 606 KB at the main-path geometry) stay in L2.
//
// Rounding: built with --fmad=false, and the two lines that the
// reference's compiler (XLA) contracts are explicit fused multiply-adds:
// pos = fma(lin, n-1, start) and seg = fma(x_hi, frac, x_lo * (1 - frac))
// (prealign_encode/kernel.py:97, :103; modwt.py:92, :96).  The segments
// then match the reference to the bit.

#include <cuda_runtime.h>

#include "wavefront.cuh"

namespace {

using pqdtw::band_cost;

constexpr unsigned kFull = 0xffffffffu;

// Steps 1-4 for the block's series x: the series in xs, its segments in
// segs, segment m at segs + m * (S + 2 * pad) + pad, each padded by pad
// copies of its edge elements (the lerp of the clamped point, so the same
// bits).  vs, tmp: D floats of work space; bounds: M + 1 ints.  Ends on a
// __syncthreads.
__device__ void prealign_segments(const float* __restrict__ x,
                                  const float* __restrict__ lin, float* xs,
                                  float* vs, float* tmp, float* segs,
                                  int* bounds, int D, int M, int S,
                                  int level, int tail, int pad) {
  const int bd = blockDim.x, t = threadIdx.x;
  for (int i = t; i < D; i += bd) {
    xs[i] = x[i];
    vs[i] = x[i];
  }
  __syncthreads();

  // 1. Haar MODWT scale coefficients (circular boundary).
  for (int j = 1; j <= level; ++j) {
    const int sh = (1 << (j - 1)) % D;
    for (int i = t; i < D; i += bd) {
      const int src = (i - sh + D) % D;
      tmp[i] = 0.5f * (vs[i] + vs[src]);
    }
    __syncthreads();
    for (int i = t; i < D; i += bd) vs[i] = tmp[i];
    __syncthreads();
  }

  // 2. signs of x - v, zeros carry the previous nonzero sign.
  for (int i = t; i < D; i += bd) {
    const float d = xs[i] - vs[i];
    tmp[i] = (float)((d > 0.f) - (d < 0.f));
  }
  __syncthreads();
  if (t == 0) {
    float last = 0.f;
    for (int i = 0; i < D; ++i) {
      if (tmp[i] != 0.f) last = tmp[i];
      vs[i] = last;
    }
  }
  __syncthreads();

  // 3. snap each interior split to the right-most change point in its
  //    tail window (change at c: c >= 1 and sign(c) * sign(c-1) < 0).
  const int seg = D / M;
  for (int m = t; m <= M; m += bd) {
    int b;
    if (m == 0) {
      b = 0;
    } else if (m == M) {
      b = D;
    } else {
      const int l = m * seg;
      b = l;
      for (int o = 0; o <= tail; ++o) {
        const int c = l - o;
        if (c < 1) break;
        if (c < D && vs[c] * vs[c - 1] < 0.f) {
          b = c;
          break;
        }
      }
    }
    bounds[m] = b;
  }
  __syncthreads();

  // 4. linear re-interpolation of every segment to S points.
  const int P = S + 2 * pad;
  for (int e = t; e < M * P; e += bd) {
    const int m = e / P;
    const int s = min(max(e % P - pad, 0), S - 1);
    const int start = bounds[m], stop = bounds[m + 1];
    const float pos =
        __fmaf_rn(lin[s], (float)(stop - start - 1), (float)start);
    const int lo = min(max((int)floorf(pos), 0), D - 1);
    const int hi = min(max(lo + 1, 0), D - 1);
    const float frac = pos - (float)lo;
    segs[e] = __fmaf_rn(xs[hi], frac, xs[lo] * (1.0f - frac));
  }
  __syncthreads();
}

// The shared-memory form: centroids (M, K, S).
template <int MEAS>
__global__ void prealign_encode_kernel(
    const float* __restrict__ X, const float* __restrict__ cents,
    const float* __restrict__ lin, const float* __restrict__ wt,
    int* __restrict__ codes, int D, int M, int K, int S, int level, int tail,
    int w, float p) {
  extern __shared__ float smem[];
  const int bd = blockDim.x, t = threadIdx.x;
  float* xs = smem;                    // D: the series
  float* vs = xs + D;                  // D: MODWT scale / forward-filled sign
  float* tmp = vs + D;                 // D: MODWT double buffer
  float* segs = tmp + D;               // M * S: re-interpolated segments
  float* rows = segs + M * S;          // bd * (2w + 2): band rows
  float* red_d = rows + bd * (2 * w + 2);  // bd: argmin distances
  int* red_k = reinterpret_cast<int*>(red_d + bd);  // bd: argmin indices
  int* bounds = red_k + bd;            // M + 1 segment boundaries

  const long long n = blockIdx.x;
  prealign_segments(X + n * D, lin, xs, vs, tmp, segs, bounds, D, M, S,
                    level, tail, 0);

  // 5. per subspace: elastic 1-NN over the K centroids, first index wins.
  float* row = rows + t;
  for (int m = 0; m < M; ++m) {
    float best = __int_as_float(0x7f800000);  // +inf: no centroid yet
    int best_k = 0x7fffffff;
    for (int k = t; k < K; k += bd) {
      const float d = band_cost<MEAS>(segs + m * S,
                                      cents + ((long long)m * K + k) * S, S,
                                      w, p, wt, row, bd);
      if (d < best) {  // k ascends per thread: strict < keeps the first
        best = d;
        best_k = k;
      }
    }
    red_d[t] = best;
    red_k[t] = best_k;
    __syncthreads();
    for (int half = bd / 2; half > 0; half >>= 1) {
      if (t < half) {
        const float od = red_d[t + half];
        const int ok = red_k[t + half];
        if (od < red_d[t] || (od == red_d[t] && ok < red_k[t])) {
          red_d[t] = od;
          red_k[t] = ok;
        }
      }
      __syncthreads();
    }
    if (t == 0) codes[n * M + m] = red_k[0];
    __syncthreads();
  }
}

// (od, ok) replaces (d, k) if it is nearer, or as near with a lower index.
__device__ __forceinline__ void keep_first_min(float od, int ok, float* d,
                                               int* k) {
  if (od < *d || (od == *d && ok < *k)) {
    *d = od;
    *k = ok;
  }
}

// The register form: centroids (M, S, K), 2w + 2 <= WB, blockDim.x a
// multiple of 32.
template <int MEAS, int WB>
__global__ void prealign_encode_reg_kernel(
    const float* __restrict__ X, const float* __restrict__ cents_t,
    const float* __restrict__ lin, const float* __restrict__ wt,
    int* __restrict__ codes, int D, int M, int K, int S, int level, int tail,
    int w, float p) {
  extern __shared__ float smem[];
  const int bd = blockDim.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nw = bd >> 5;
  const int P = S + 2 * WB;            // a padded segment
  float* xs = smem;                    // D: the series
  float* vs = xs + D;                  // D: MODWT scale / forward-filled sign
  float* tmp = vs + D;                 // D: MODWT double buffer
  float* segs = tmp + D;               // M * P: padded segments
  float* sw = segs + M * P;            // S: WDTW weights
  float* red_d = sw + S;               // 2 * nw: the warps' winners
  int* red_k = reinterpret_cast<int*>(red_d + 2 * nw);  // 2 * nw
  int* bounds = red_k + 2 * nw;        // M + 1 segment boundaries

  if (MEAS == pqdtw::kWDTW)
    for (int k = t; k < S; k += bd) sw[k] = wt[k];
  const long long n = blockIdx.x;
  prealign_segments(X + n * D, lin, xs, vs, tmp, segs, bounds, D, M, S,
                    level, tail, WB);

  for (int m = 0; m < M; ++m) {
    float best = __int_as_float(0x7f800000);  // +inf: no centroid yet
    int best_k = 0x7fffffff;
    const float* cm = cents_t + (size_t)m * S * K;
    for (int k = t; k < K; k += bd) {
      const float d = pqdtw::band_cost_reg<MEAS, WB>(cm + k, segs + m * P + WB,
                                                     S, w, p, sw, K);
      if (d < best) {  // k ascends per thread: strict < keeps the first
        best = d;
        best_k = k;
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      keep_first_min(__shfl_xor_sync(kFull, best, off),
                     __shfl_xor_sync(kFull, best_k, off), &best, &best_k);
    // subspace m's winners in buffer m & 1: a warp writes m + 2's only
    // after the barrier of m + 1, which thread 0 passes after reading m's
    float* rd = red_d + (m & 1) * nw;
    int* rk = red_k + (m & 1) * nw;
    if (lane == 0) {
      rd[warp] = best;
      rk[warp] = best_k;
    }
    __syncthreads();
    if (t == 0) {
      float win_d = rd[0];
      int win_k = rk[0];
      for (int v = 1; v < nw; ++v)
        keep_first_min(rd[v], rk[v], &win_d, &win_k);
      codes[n * M + m] = win_k;
    }
  }
}

template <int MEAS>
int launch(const float* X, const float* cents, const float* lin,
           const float* wt, int* codes, int N, int D, int M, int K, int S,
           int level, int tail, int w, float p, int threads, size_t smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        prealign_encode_kernel<MEAS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  prealign_encode_kernel<MEAS><<<N, threads, smem, stream>>>(
      X, cents, lin, wt, codes, D, M, K, S, level, tail, w, p);
  return (int)cudaGetLastError();
}

template <int MEAS, int WB>
int launch_reg_bucket(const float* X, const float* cents_t, const float* lin,
                      const float* wt, int* codes, int N, int D, int M, int K,
                      int S, int level, int tail, int w, float p, int threads,
                      cudaStream_t stream) {
  const int nw = threads / 32;
  const size_t smem =
      sizeof(float) * ((size_t)3 * D + (size_t)M * (S + 2 * WB) + S +
                       2 * nw) +
      sizeof(int) * ((size_t)2 * nw + M + 1);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        prealign_encode_reg_kernel<MEAS, WB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  prealign_encode_reg_kernel<MEAS, WB><<<N, threads, smem, stream>>>(
      X, cents_t, lin, wt, codes, D, M, K, S, level, tail, w, p);
  return (int)cudaGetLastError();
}

template <int MEAS>
int launch_reg(const float* X, const float* cents_t, const float* lin,
               const float* wt, int* codes, int N, int D, int M, int K, int S,
               int level, int tail, int w, float p, int bucket, int threads,
               cudaStream_t s) {
  switch (bucket) {
    case 8:
      return launch_reg_bucket<MEAS, 8>(X, cents_t, lin, wt, codes, N, D, M,
                                        K, S, level, tail, w, p, threads, s);
    case 16:
      return launch_reg_bucket<MEAS, 16>(X, cents_t, lin, wt, codes, N, D, M,
                                         K, S, level, tail, w, p, threads, s);
    case 32:
      return launch_reg_bucket<MEAS, 32>(X, cents_t, lin, wt, codes, N, D, M,
                                         K, S, level, tail, w, p, threads, s);
    case 64:
      if (MEAS != pqdtw::kDTW) return (int)cudaErrorInvalidValue;
      return launch_reg_bucket<pqdtw::kDTW, 64>(X, cents_t, lin, wt, codes, N,
                                                D, M, K, S, level, tail, w, p,
                                                threads, s);
    case 128:
      if (MEAS != pqdtw::kDTW) return (int)cudaErrorInvalidValue;
      return launch_reg_bucket<pqdtw::kDTW, 128>(X, cents_t, lin, wt, codes,
                                                 N, D, M, K, S, level, tail,
                                                 w, p, threads, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// bucket = 0: the shared-memory form, cents (M, K, S); else the register
// form with WB = bucket (2w + 2 <= bucket), cents (M, S, K), threads a
// multiple of 32.
int pq_prealign_encode(const float* X, const float* cents, const float* lin,
                       const float* wt, int* codes, int N, int D, int M,
                       int K, int S, int level, int tail, int w, int measure,
                       float p, int bucket, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bucket != 0) {
    if (w < 0 || w > S - 1 || 2 * w + 2 > bucket || threads % 32 != 0 ||
        threads < 32 || threads > 1024)
      return (int)cudaErrorInvalidValue;
    switch (measure) {
      case pqdtw::kDTW:
        return launch_reg<pqdtw::kDTW>(X, cents, lin, wt, codes, N, D, M, K,
                                       S, level, tail, w, p, bucket, threads,
                                       s);
      case pqdtw::kWDTW:
        return launch_reg<pqdtw::kWDTW>(X, cents, lin, wt, codes, N, D, M, K,
                                        S, level, tail, w, p, bucket,
                                        threads, s);
      case pqdtw::kERP:
        return launch_reg<pqdtw::kERP>(X, cents, lin, wt, codes, N, D, M, K,
                                       S, level, tail, w, p, bucket, threads,
                                       s);
      case pqdtw::kMSM:
        return launch_reg<pqdtw::kMSM>(X, cents, lin, wt, codes, N, D, M, K,
                                       S, level, tail, w, p, bucket, threads,
                                       s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  const size_t smem = sizeof(float) * ((size_t)3 * D + (size_t)M * S +
                                       (size_t)threads * (2 * w + 2) +
                                       threads) +
                      sizeof(int) * ((size_t)threads + M + 1);
  switch (measure) {
    case pqdtw::kDTW:
      return launch<pqdtw::kDTW>(X, cents, lin, wt, codes, N, D, M, K, S,
                                 level, tail, w, p, threads, smem, s);
    case pqdtw::kWDTW:
      return launch<pqdtw::kWDTW>(X, cents, lin, wt, codes, N, D, M, K, S,
                                  level, tail, w, p, threads, smem, s);
    case pqdtw::kERP:
      return launch<pqdtw::kERP>(X, cents, lin, wt, codes, N, D, M, K, S,
                                 level, tail, w, p, threads, smem, s);
    case pqdtw::kMSM:
      return launch<pqdtw::kMSM>(X, cents, lin, wt, codes, N, D, M, K, S,
                                 level, tail, w, p, threads, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
