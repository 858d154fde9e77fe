// Fused LB cascade + conditional banded-DTW refine on the H100.
//
// Replaces repro/kernels/lb_cascade/kernel.py::lb_cascade_kernel as
// launched by make_lb_refine_call (adaptive=False), and
// ::lb_cascade_adaptive_kernel (adaptive=True, below): zipped pairs of a
// query a, a candidate b, a's Keogh envelope (up, lo) and a threshold t, all
// (N, L) float32 with t (N,), give
//
//   lb      = max(LB_Kim(a, b), LB_Keogh(b, env(a)))
//   d       = squared banded DTW(a, b)  where lb < t, else lb
//   refined = lb < t                    (int32 0/1)
//
// One thread owns one pair.  It sums the bound in one sequential pass over
// b, up and lo, then a survivor sweeps the band with pqdtw::band_cost
// (wavefront.cuh, shared with dtw_band.cu).  The band row lives in shared
// memory up to w = 190 and in a wrapper-allocated scratch buffer beyond,
// as in dtw_band.cu.  The TPU kernel skips the wavefront of a whole tile
// with a lax.cond when no pair in it survives, because its shapes cannot
// depend on data; here the branch is per thread, so a warp whose 32 pairs
// are all pruned never enters the DP, and in a warp with survivors only
// the survivors sweep (the others wait, masked).  Pairs the caller wants
// ignored (padding, already-processed filler) carry t = -inf and never
// refine.
//
// What bounds it on the H100: for a pruned pair, the bound pass reads 3L
// floats (b, up, lo) and does about 5 operations per point, so it is bound
// by bytes; each survivor adds the DP's L*(2w+1) dependent cells, bound by
// dependent arithmetic as in dtw_band.cu.  The callers (lb_search waves)
// send the lowest bounds first, so survivors crowd the early waves.
//
// Rounding: built with --fmad=false; the bound is formed with the same
// float32 operations as the plain version (core/lb.py: lb_kim, lb_keogh),
// but LB_Keogh is summed sequentially here and as a tree by torch.sum, so
// a bound within an ulp or two of its threshold may flip its flag.  The
// refined distance is the DP of dtw_band.cu, bit-identical to it.
//
// The adaptive form keeps the bound pass and the per-thread skip as they
// are; only a survivor's refine changes, to pqdtw::corridor_cost inside
// the pair's corridor lo, hi (N, 2L-1) int32 with register cap W, the DP
// of dtw_band.cu's adaptive kernel.  Its refined value is the
// corridor-restricted cost, an upper bound of the static one.

#include <cuda_runtime.h>

#include "wavefront.cuh"

namespace {

// max(LB_Kim, LB_Keogh) of one pair, LB_Keogh summed left to right.
__device__ __forceinline__ float cascade_lb(const float* __restrict__ a,
                                            const float* __restrict__ b,
                                            const float* __restrict__ u,
                                            const float* __restrict__ l,
                                            int L) {
  const float d0 = a[0] - b[0];
  const float d1 = a[L - 1] - b[L - 1];
  const float kim = d0 * d0 + d1 * d1;
  float keogh = 0.f;
  for (int i = 0; i < L; ++i) {
    const float x = b[i];
    const float hi_gap = x - u[i];
    const float lo_gap = l[i] - x;
    const float above = (x > u[i]) ? hi_gap * hi_gap : 0.f;
    const float below = (x < l[i]) ? lo_gap * lo_gap : 0.f;
    keogh = keogh + (above + below);
  }
  return fmaxf(kim, keogh);
}

__global__ void lb_refine_kernel(const float* __restrict__ A,
                                 const float* __restrict__ B,
                                 const float* __restrict__ up,
                                 const float* __restrict__ lo,
                                 const float* __restrict__ thresh,
                                 float* __restrict__ d_out,
                                 int* __restrict__ flag, float* scratch,
                                 int n, int L, int w) {
  float* row;
  int stride;
  pqdtw::band_row(scratch, &row, &stride);
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < n;
       q += step) {
    const float* a = A + q * L;
    const float* b = B + q * L;
    const float lb = cascade_lb(a, b, up + q * L, lo + q * L, L);
    const bool surv = lb < thresh[q];
    d_out[q] = surv ? pqdtw::band_cost<pqdtw::kDTW>(a, b, L, w, 0.f, nullptr,
                                                    row, stride)
                    : lb;
    flag[q] = surv ? 1 : 0;
  }
}

__global__ void lb_refine_adaptive_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    const float* __restrict__ up, const float* __restrict__ lo,
    const float* __restrict__ thresh, const int* __restrict__ clo,
    const int* __restrict__ chi, float* __restrict__ d_out,
    int* __restrict__ flag, float* scratch, int n, int L, int W) {
  float* row;
  int stride;
  pqdtw::band_row(scratch, &row, &stride);
  const long long D = 2LL * L - 1;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < n;
       q += step) {
    const float* a = A + q * L;
    const float* b = B + q * L;
    const float lb = cascade_lb(a, b, up + q * L, lo + q * L, L);
    const bool surv = lb < thresh[q];
    d_out[q] = surv ? pqdtw::corridor_cost<pqdtw::kDTW>(
                          a, b, clo + q * D, chi + q * D, L, W, nullptr, row,
                          stride)
                    : lb;
    flag[q] = surv ? 1 : 0;
  }
}

}  // namespace

extern "C" {

int pq_lb_refine(const float* A, const float* B, const float* up,
                 const float* lo, const float* thresh, float* d_out,
                 int* flag, float* scratch, int n, int L, int w, int threads,
                 int blocks, void* stream) {
  const size_t smem = pqdtw::band_smem_bytes(scratch, threads, w);
  lb_refine_kernel<<<blocks, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      A, B, up, lo, thresh, d_out, flag, scratch, n, L, w);
  return (int)cudaGetLastError();
}

int pq_lb_refine_adaptive(const float* A, const float* B, const float* up,
                          const float* lo, const float* thresh,
                          const int* clo, const int* chi, float* d_out,
                          int* flag, float* scratch, int n, int L, int width,
                          int threads, int blocks, void* stream) {
  const size_t smem = pqdtw::state_smem_bytes(scratch, threads, 3 * width);
  lb_refine_adaptive_kernel<<<blocks, threads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      A, B, up, lo, thresh, clo, chi, d_out, flag, scratch, n, L, width);
  return (int)cudaGetLastError();
}

}  // extern "C"
