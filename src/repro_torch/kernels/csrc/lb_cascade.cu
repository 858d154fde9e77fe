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
// What bounds it on the H100: for a pruned pair, the bound pass reads 3L
// floats (b, up, lo) and does about 5 operations per point, so it is bound
// by bytes; each survivor adds the DP's L*(2w+1) cells, 6 float32
// operations each.  At the search shape (L=512, w=51, a wave of 7680
// pairs of which most refine) that is about 0.035 ms of operations.  But
// the cells of one pair form a dependent chain, and the searches send
// waves of a few hundred pairs (lb_search: Nq * max(k, 4) a wave), so what
// a wave costs is one pair's latency unless that chain is cut short.
//
// Design (w <= 255): one warp per pair, lb_refine_warp_kernel.
//   1. Bound pass: the lanes read b, up and lo in stride (coalesced), each
//      forms the same per-point float32 terms as the plain version
//      (core/lb.py: lb_kim, lb_keogh) and sums its own points; an
//      xor-shuffle reduction gives every lane lb.  A pruned pair's warp
//      writes lb and flag 0 and leaves; a filler pair (t = -inf) never
//      refines.
//   2. Refine: the warp stages a and b in its slice of the CTA's shared
//      memory, each padded with 32*C NaNs on both sides (2(L + 64C)
//      floats; read from device memory when even one warp's slice does not
//      fit) and sweeps the band's anti-diagonals across its lanes with
//      pqdtw::band_cost_warp (wavefront.cuh): 2L-1 dependent steps of
//      C cells a lane (C = ceil((w+1)/32) rounded up to 1, 2, 4 or 8), in
//      place of the L*(2w+1) dependent cells of one thread.  4 warps a CTA, so a wave of
//      512 pairs spreads over 128 SMs, and the hot scan's 7680 pairs keep
//      about 58 warps resident per SM.
//
// Bands wider than w = 255 (C would exceed 8 registers a lane) take
// lb_refine_kernel, one thread per pair: it sums the bound in one
// sequential pass, then a survivor sweeps the band with pqdtw::band_cost
// (the band row in shared memory up to w = 191, in a wrapper-allocated
// scratch buffer beyond, as in dtw_band.cu); a warp whose 32 pairs are all
// pruned never enters the DP.  The wrapper picks the form from w alone
// (kernels/lb_cascade/ops.py::refine_variant); both count as lb_refine.
//
// Rounding: built with --fmad=false; the bound is formed with the same
// float32 operations as the plain version, but LB_Keogh is summed in
// another order here (lane-strided partial sums and a shuffle tree, or
// left to right in the wide form) than by torch.sum, so a bound within an
// ulp or two of its threshold may flip its flag.  The refined distance is
// the DP of dtw_band.cu, bit-identical to it in both forms.
//
// The adaptive form (lb_cascade_adaptive_kernel) refines a survivor
// inside its corridor lo, hi (N, 2L-1) int32 with register cap W, the DP
// of dtw_band.cu's adaptive kernel; its refined value is the
// corridor-restricted cost, an upper bound of the static one.  Up to
// W = 256 one warp per pair (lb_refine_adaptive_warp_kernel): the warp
// form's bound pass and exits, the rows staged in shared memory as
// [a | 32C NaNs | b], then pqdtw::corridor_cost_warp_padded, 2L-1
// dependent steps of C = ceil(W/32) slots a lane (rounded up to 1, 2, 4
// or 8), each step one broadcast of the diagonal's packed live count and
// shift case, one or two shuffles, and per slot two shared-memory loads
// and the cell's arithmetic: bound by those instructions across the
// wave's warps, not by bytes.  A corridor that breaks the invariants
// falls back to the clamped pqdtw::corridor_cost_warp for its pair.
// Beyond W = 256, lb_refine_adaptive_kernel, one thread per pair: a
// sequential bound, then pqdtw::corridor_cost, one chain of (2L-1) * W
// slot updates whose three diagonals live in shared memory (3W floats a
// thread, so 128 threads a CTA at W = 32, and a 7680-pair wave fills 60
// CTAs: bound by that chain's latency).  The wrapper picks the form from
// W alone (kernels/lb_cascade/ops.py::adaptive_variant); both count as
// lb_refine_adaptive and give the same refined bits.

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

// max(LB_Kim, LB_Keogh) of one pair by its warp: lane-strided LB_Keogh
// partial sums, then an xor-shuffle tree, so every lane holds the bound.
__device__ __forceinline__ float warp_cascade_lb(const float* __restrict__ a,
                                                 const float* __restrict__ b,
                                                 const float* __restrict__ u,
                                                 const float* __restrict__ l,
                                                 int L, int lane) {
  float keogh = 0.f;
  for (int i = lane; i < L; i += 32) {
    const float x = b[i];
    const float hi_gap = x - u[i];
    const float lo_gap = l[i] - x;
    const float above = (x > u[i]) ? hi_gap * hi_gap : 0.f;
    const float below = (x < l[i]) ? lo_gap * lo_gap : 0.f;
    keogh = keogh + (above + below);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    keogh = keogh + __shfl_xor_sync(0xffffffffu, keogh, o);
  const float d0 = a[0] - b[0];
  const float d1 = a[L - 1] - b[L - 1];
  return fmaxf(d0 * d0 + d1 * d1, keogh);
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
                          a, b, clo + q * D, chi + q * D, L, W, 0.f, nullptr,
                          nullptr, nullptr, 0, row, stride)
                    : lb;
    flag[q] = surv ? 1 : 0;
  }
}

// One warp per pair (see the head of this file).
template <int C>
__global__ void lb_refine_warp_kernel(const float* __restrict__ A,
                                      const float* __restrict__ B,
                                      const float* __restrict__ up,
                                      const float* __restrict__ lo,
                                      const float* __restrict__ thresh,
                                      float* __restrict__ d_out,
                                      int* __restrict__ flag, int n, int L,
                                      int w, int stage) {
  extern __shared__ float rows[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long q = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (q >= n) return;  // the whole warp: one pair per warp
  const float* a = A + q * L;
  const float* b = B + q * L;
  const float* u = up + q * L;
  const float* l = lo + q * L;
  const float lb = warp_cascade_lb(a, b, u, l, L, lane);
  if (!(lb < thresh[q])) {
    if (lane == 0) {
      d_out[q] = lb;
      flag[q] = 0;
    }
    return;
  }
  float cost;
  if (stage) {
    // the pair's rows with warp_pad(C) NaNs on each side: the sweep's
    // table edges then cost no test (wavefront.cuh)
    constexpr int P = pqdtw::warp_pad(C);
    const int padded = L + 2 * P;
    float* sa = rows + (size_t)warp * 2 * padded;
    float* sb = sa + padded;
    const float nan = __int_as_float(0x7fc00000);
    for (int k = lane; k < padded; k += 32) {
      const bool in = k >= P && k < P + L;
      sa[k] = in ? a[k - P] : nan;
      sb[k] = in ? b[k - P] : nan;
    }
    __syncwarp();
    cost = pqdtw::band_cost_warp<C, true>(sa + P, sb + P, L, w, lane);
  } else {
    cost = pqdtw::band_cost_warp<C, false>(a, b, L, w, lane);
  }
  if (lane == 0) {
    d_out[q] = cost;
    flag[q] = 1;
  }
}

template <int C>
int launch_warp(const float* A, const float* B, const float* up,
                const float* lo, const float* thresh, float* d_out, int* flag,
                int n, int L, int w, int warps, int blocks, size_t smem,
                cudaStream_t stream) {
  auto kernel = lb_refine_warp_kernel<C>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, warps * 32, smem, stream>>>(A, B, up, lo, thresh, d_out,
                                               flag, n, L, w, smem > 0);
  return (int)cudaGetLastError();
}

// The adaptive refine, one warp per pair (W <= 256): the bound pass and
// the exits of lb_refine_warp_kernel, then a survivor's warp stages a and
// b in its slice of shared memory as [a | warp_pad(C) NaNs | b] (2L +
// 32C floats) and sweeps the corridor with
// pqdtw::corridor_cost_warp_padded<kDTW, C> (no clamps, no (0, 0) test, a
// body per shift case; dtw_band.cu's adaptive kernel sweeps the same for
// every measure), C = ceil(W / 32) rounded up to 1, 2, 4 or 8.  A
// corridor that breaks its invariants is swept again with the clamped
// pqdtw::corridor_cost_warp<kDTW, C> on the same staged rows, as are all
// pairs with padded == 0 (the earlier form, kept for comparison) and, from
// device memory, all pairs when even one warp's slice does not fit.
template <int C>
__global__ void lb_refine_adaptive_warp_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    const float* __restrict__ up, const float* __restrict__ lo,
    const float* __restrict__ thresh, const int* __restrict__ clo,
    const int* __restrict__ chi, float* __restrict__ d_out,
    int* __restrict__ flag, int n, int L, int W, int stage, int padded) {
  extern __shared__ float rows[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long q = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (q >= n) return;  // the whole warp: one pair per warp
  const float* a = A + q * L;
  const float* b = B + q * L;
  const float lb = warp_cascade_lb(a, b, up + q * L, lo + q * L, L, lane);
  if (!(lb < thresh[q])) {
    if (lane == 0) {
      d_out[q] = lb;
      flag[q] = 0;
    }
    return;
  }
  const long long D = 2LL * L - 1;
  const int* cl = clo + q * D;
  const int* ch = chi + q * D;
  float cost;
  if (stage) {
    constexpr int P = pqdtw::warp_pad(C);
    float* sa = rows + (size_t)warp * (2 * L + P);
    const float nan = __int_as_float(0x7fc00000);
    for (int k = lane; k < 2 * L + P; k += 32)
      sa[k] = k < L ? a[k] : (k < L + P ? nan : b[k - L - P]);
    __syncwarp();
    a = sa;
    b = sa + L + P;
    const pqdtw::MeasureArgs dtw{};
    if (!(padded && pqdtw::corridor_cost_warp_padded<pqdtw::kDTW, C>(
                        a, b, cl, ch, L, W, lane, &cost, dtw)))
      cost = pqdtw::corridor_cost_warp<pqdtw::kDTW, C>(a, b, cl, ch, L, W,
                                                       lane, dtw);
  } else {
    cost = pqdtw::corridor_cost_warp<pqdtw::kDTW, C>(a, b, cl, ch, L, W, lane,
                                                     pqdtw::MeasureArgs{});
  }
  if (lane == 0) {
    d_out[q] = cost;
    flag[q] = 1;
  }
}

template <int C>
int launch_adaptive_warp(const float* A, const float* B, const float* up,
                         const float* lo, const float* thresh, const int* clo,
                         const int* chi, float* d_out, int* flag, int n,
                         int L, int W, int warps, int blocks, size_t smem,
                         int padded, cudaStream_t stream) {
  auto kernel = lb_refine_adaptive_warp_kernel<C>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, warps * 32, smem, stream>>>(A, B, up, lo, thresh, clo, chi,
                                               d_out, flag, n, L, W,
                                               smem > 0, padded);
  return (int)cudaGetLastError();
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

// One warp per pair, w <= 255 and w <= L-1; warps per CTA and the staging
// shared memory (warps * 2 * (L + 2 * warp_pad(C)) floats, or 0: read a and
// b from device memory) as the wrapper's warp_geometry gives them.
int pq_lb_refine_warp(const float* A, const float* B, const float* up,
                      const float* lo, const float* thresh, float* d_out,
                      int* flag, int n, int L, int w, int warps, int blocks,
                      int smem, void* stream) {
  if (w < 0 || w > L - 1 || w > 255 || warps < 1 || warps > 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int need = (w + 32) / 32;  // ceil((w + 1) / 32)
  if (need <= 1)
    return launch_warp<1>(A, B, up, lo, thresh, d_out, flag, n, L, w, warps,
                          blocks, smem, s);
  if (need <= 2)
    return launch_warp<2>(A, B, up, lo, thresh, d_out, flag, n, L, w, warps,
                          blocks, smem, s);
  if (need <= 4)
    return launch_warp<4>(A, B, up, lo, thresh, d_out, flag, n, L, w, warps,
                          blocks, smem, s);
  return launch_warp<8>(A, B, up, lo, thresh, d_out, flag, n, L, w, warps,
                        blocks, smem, s);
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

// One warp per pair inside the corridor, 1 <= width <= 256; warps per CTA
// and the staging shared memory (warps * (2L + 32C) floats, or 0: read a
// and b from device memory) as the wrapper's corridor_warp_geometry gives
// them.  padded = 1 sweeps valid corridors on the padded rows (the
// wrapper's form), 0 every pair with the clamped sweep.
int pq_lb_refine_adaptive_warp(const float* A, const float* B,
                               const float* up, const float* lo,
                               const float* thresh, const int* clo,
                               const int* chi, float* d_out, int* flag, int n,
                               int L, int width, int warps, int blocks,
                               int smem, int padded, void* stream) {
  if (width < 1 || width > 256 || warps < 1 || warps > 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int need = (width + 31) / 32;
  if (need <= 1)
    return launch_adaptive_warp<1>(A, B, up, lo, thresh, clo, chi, d_out,
                                   flag, n, L, width, warps, blocks, smem,
                                   padded, s);
  if (need <= 2)
    return launch_adaptive_warp<2>(A, B, up, lo, thresh, clo, chi, d_out,
                                   flag, n, L, width, warps, blocks, smem,
                                   padded, s);
  if (need <= 4)
    return launch_adaptive_warp<4>(A, B, up, lo, thresh, clo, chi, d_out,
                                   flag, n, L, width, warps, blocks, smem,
                                   padded, s);
  return launch_adaptive_warp<8>(A, B, up, lo, thresh, clo, chi, d_out, flag,
                                 n, L, width, warps, blocks, smem, padded,
                                 s);
}

}  // extern "C"
