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
// Then, per subspace, the threads sweep the segment against the K
// centroids with pqdtw::band_cost (wavefront.cuh), one centroid at a time
// per thread, and a block argmin keeps the lowest index among equal
// distances.
//
// What bounds it on the H100: the K*M dependent DP chains per series
// (see wavefront.cuh); the pre-alignment is O(D * level) per series and
// the centroids (M*K*S floats, 606 KB at the main-path geometry) stay in
// L2.  The design keeps the series, its segments and the band rows in
// shared memory and gives every thread its own centroids.
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
  const float* x = X + n * D;
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
  for (int e = t; e < M * S; e += bd) {
    const int m = e / S, s = e % S;
    const int start = bounds[m], stop = bounds[m + 1];
    const float pos =
        __fmaf_rn(lin[s], (float)(stop - start - 1), (float)start);
    const int lo = min(max((int)floorf(pos), 0), D - 1);
    const int hi = min(max(lo + 1, 0), D - 1);
    const float frac = pos - (float)lo;
    segs[e] = __fmaf_rn(xs[hi], frac, xs[lo] * (1.0f - frac));
  }
  __syncthreads();

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

}  // namespace

extern "C" {

int pq_prealign_encode(const float* X, const float* cents, const float* lin,
                       const float* wt, int* codes, int N, int D, int M,
                       int K, int S, int level, int tail, int w, int measure,
                       float p, int threads, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)3 * D + (size_t)M * S +
                                       (size_t)threads * (2 * w + 2) +
                                       threads) +
                      sizeof(int) * ((size_t)threads + M + 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
