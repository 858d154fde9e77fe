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
//
// The encode's LB filter (lb_filter_topk_kernel, below) replaces no Pallas
// kernel: the JAX package leaves this step to XLA, which fuses it
// (repro/core/pq.py:252-256, the bounds and jax.lax.top_k).  Its notes are
// above the kernel.

#include <cuda_pipeline.h>
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


// A float's place in torch.sort's order as an unsigned key: numbers by
// value (-0 and +0 equal), every NaN after +inf.
__device__ __forceinline__ unsigned order_key(float v) {
  if (v != v) return 0xffffffffu;
  const unsigned u = __float_as_uint(v + 0.f);  // -0 + 0 = +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The float of an order_key (a NaN for the NaN key).
__device__ __forceinline__ float key_value(unsigned key) {
  if (key == 0xffffffffu) return __int_as_float(0x7fc00000);
  return __uint_as_float((key & 0x80000000u) ? (key ^ 0x80000000u) : ~key);
}

// ---------------------------------------------------------------------------
// The encode's LB filter: segments segs (N, M, S) against every centroid of
// their subspace, cents (M, K, S) with its Keogh envelope up, lo (M, K, S),
// all float32.  For each (series n, subspace m):
//
//   bound[k] = max(LB_Kim(x, c_k), LB_Keogh(x, env(c_k)))     (x = segs[n, m])
//   cand[n, m, :]  = the T centroids of smallest bound, in the order of a
//                    stable sort (lower index first among equal bounds,
//                    every NaN after every number, as torch.sort)
//   next_lb[n, m]  = the (T+1)-th smallest bound
//
// The per-point terms are the plain version's (core/lb.py::cascade_bound,
// and cascade_lb above): fmaxf(x - u, 0)^2 + fmaxf(l - x, 0)^2 is
// where(x > u, (x - u)^2, 0) + where(x < l, (l - x)^2, 0) bit for bit, NaN
// segments included, and LB_Kim is (x0 - c0)^2 + (x_{S-1} - c_{S-1})^2.
// LB_Keogh is summed over s = 0, 1, ..., S-1 in that order into one float32
// accumulator (torch.sum takes another order, so a bound may differ by a
// few ulps from the plain version's); the max propagates NaN as
// torch.maximum does.  No bound is skipped or abandoned early.
//
// What bounds it on the H100: operations.  About 5 a point per (series,
// centroid): 12.5 GFLOP a batch at N = 8236, M = 8, K = 256, S = 147,
// 0.19 ms at 67 TFLOP/s, against 13 MB of segments and envelopes read and
// N * M * (8T + 4) bytes written.  The eager version wrote five (N, K, S)
// temporaries a subspace and sorted all K bounds.  Here nothing of size
// N * K * S exists, and nothing of size K leaves the block.
//
// Design: one CTA per (tile of R = 8 * ROWS series, subspace m), 8 warps.
//   1. The CTA stages its R series' first and last points (LB_Kim) and
//      every centroid's first and last point in shared memory.
//   2. It streams its segments, [s][r] (series-minor), and the subspace's
//      envelopes, [s][k] at a pitch of KT + 1 (the transposing copy is
//      conflict-free), through shared memory in stages of SC points x KT =
//      32 * KC centroids, double-buffered by cp.async: the next stage is
//      in flight while the block sums this one.  Points are the outer
//      loop, so a segment chunk is read once and serves every centroid
//      tile, and no length of segment exceeds the block's shared memory.
//      A whole subspace is 301 KB at starlight's shape, more than a
//      block's 227 KB.
//   3. Register tile: warp w owns series w*ROWS .. w*ROWS+ROWS-1; lane l
//      owns centroids k = 32 j + l.  For each point, a warp reads its ROWS
//      segment values as broadcast vector loads and each lane its KC
//      (u, l) pairs, then does ROWS * KC point-pairs of 8 float32
//      operations: 6 shared-memory loads for 128 operations at ROWS = 8,
//      KC = 2, so the ALUs set the pace.  The KJ = K / 32 sums of each of
//      its series stay in the lane's registers (ROWS * KJ <= 64).
//   4. Selection, by the warp, a series at a time, from registers: a
//      bitwise radix select on the bound's order-preserving 32-bit key
//      (32 rounds of KJ compares and one __reduce_add_sync) finds the
//      (T+1)-th key; the keys below it and the first equal ones by index
//      (ballots) are compacted into T+1 (key, index) slots of shared
//      memory; each slot's rank among them is its place in the stable
//      order.  Ranks below T write cand, rank T writes next_lb.
// The wrapper's filter_geometry picks KJ (K rounded up to 32, 64, 128,
// 256, 512 or 1024), ROWS and KC with it (ROWS * KJ <= 64 registers) and
// SC from (K, S, T) alone: 104 KB at starlight's shape, so two CTAs share
// an SM.
template <int KJ, int ROWS, int KC>
__global__ void __launch_bounds__(256, 2)
    lb_filter_topk_kernel(const float* __restrict__ segs,
                          const float* __restrict__ cents,
                          const float* __restrict__ up,
                          const float* __restrict__ lo,
                          long long* __restrict__ cand,
                          float* __restrict__ next_lb, int N, int M, int K,
                          int S, int T, int SC) {
  constexpr int KT = 32 * KC;  // centroids a stage
  constexpr int NT = KJ / KC;  // stages along K
  constexpr int pitch = KT + 1;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int R = (blockDim.x >> 5) * ROWS;
  const int m = blockIdx.y;
  const long long n0 = (long long)blockIdx.x * R;
  float* xs = smem;                      // [2 buffers][SC][R]
  float* xf = xs + 2 * SC * R;           // [R] first points
  float* xl = xf + R;                    // [R] last points
  float* c0 = xl + R;                    // [32 KJ] first points
  float* c1 = c0 + 32 * KJ;              // [32 KJ] last points
  float* env = c1 + 32 * KJ;             // [2 buffers][u, l][SC][pitch]
  const int nfl = 2 * SC * R + 2 * R + 64 * KJ + 4 * SC * pitch;
  unsigned long long* slots = reinterpret_cast<unsigned long long*>(
      smem + ((nfl + 3) & ~3)) + (size_t)warp * (T + 1);

  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const long long n = n0 + r;
    xf[r] = n < N ? segs[(n * M + m) * S] : 0.f;
    xl[r] = n < N ? segs[(n * M + m) * S + S - 1] : 0.f;
  }
  const float* cm = cents + (long long)m * K * S;
  for (int k = threadIdx.x; k < 32 * KJ; k += blockDim.x) {
    c0[k] = k < K ? cm[(long long)k * S] : 0.f;
    c1[k] = k < K ? cm[(long long)k * S + S - 1] : 0.f;
  }

  const int NC = (S + SC - 1) / SC;  // stages along S
  const int P = NC * NT;
  const float* um = up + (long long)m * K * S;
  const float* lm = lo + (long long)m * K * S;
  // stage p = (c, t): points [c SC, ...) x centroids [t KT, t KT + KT);
  // the first stage of each c also brings that chunk of the segments
  auto issue = [&](int p) {
    const int c = p / NT;
    const int t = p - c * NT;
    const int s0 = c * SC;
    const int len = min(SC, S - s0);
    if (t == 0) {
      float* bx = xs + (c & 1) * SC * R;
      for (int e = threadIdx.x; e < R * len; e += blockDim.x) {
        const int r = e % R;
        const int ss = e / R;
        const long long n = n0 + r;
        if (n < N)
          __pipeline_memcpy_async(&bx[e], segs + (n * M + m) * S + s0 + ss,
                                  4);
        else
          bx[e] = 0.f;
      }
    }
    float* bu = env + (p & 1) * 2 * SC * pitch;
    float* bl = bu + SC * pitch;
    for (int e = threadIdx.x; e < KT * len; e += blockDim.x) {
      const int kk = e / len;
      const int ss = e - kk * len;
      const int k = t * KT + kk;
      if (k < K) {
        const long long g = (long long)k * S + s0 + ss;
        __pipeline_memcpy_async(&bu[ss * pitch + kk], um + g, 4);
        __pipeline_memcpy_async(&bl[ss * pitch + kk], lm + g, 4);
      } else {
        bu[ss * pitch + kk] = 0.f;
        bl[ss * pitch + kk] = 0.f;
      }
    }
    __pipeline_commit();
  };

  float acc[ROWS][KJ];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < KJ; ++j) acc[i][j] = 0.f;

  issue(0);
  for (int c = 0; c < NC; ++c) {
    const int s0 = c * SC;
    const int len = min(SC, S - s0);
    const float* xrow = xs + (c & 1) * SC * R + warp * ROWS;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int p = c * NT + t;
      // the buffers it fills were last read before the last barrier
      if (p + 1 < P)
        issue(p + 1);
      else
        __pipeline_commit();  // an empty group: wait_prior(1) below holds
      __pipeline_wait_prior(1);
      __syncthreads();
      const float* bu = env + (p & 1) * 2 * SC * pitch + lane;
      const float* bl = bu + SC * pitch;
#pragma unroll 2
      for (int ss = 0; ss < len; ++ss) {
        float x[ROWS];
        if constexpr (ROWS % 4 == 0) {
#pragma unroll
          for (int i = 0; i < ROWS; i += 4) {
            const float4 v =
                *reinterpret_cast<const float4*>(xrow + ss * R + i);
            x[i] = v.x;
            x[i + 1] = v.y;
            x[i + 2] = v.z;
            x[i + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < ROWS; i += 2) {
            const float2 v =
                *reinterpret_cast<const float2*>(xrow + ss * R + i);
            x[i] = v.x;
            x[i + 1] = v.y;
          }
        }
        float u[KC], l[KC];
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          u[j] = bu[ss * pitch + 32 * j];
          l[j] = bl[ss * pitch + 32 * j];
        }
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
#pragma unroll
          for (int j = 0; j < KC; ++j) {
            const float a = fmaxf(x[i] - u[j], 0.f);
            const float b = fmaxf(l[j] - x[i], 0.f);
            acc[i][t * KC + j] = acc[i][t * KC + j] + (a * a + b * b);
          }
      }
      __syncthreads();  // the next issue overwrites these buffers
    }
  }

  const unsigned lanes_below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const long long n = n0 + warp * ROWS + i;
    if (n >= N) break;  // the warp's remaining series lie past the end too
    const float x0 = xf[warp * ROWS + i];
    const float x1 = xl[warp * ROWS + i];
    unsigned key[KJ];
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int k = 32 * j + lane;
      const float d0 = x0 - c0[k];
      const float d1 = x1 - c1[k];
      const float kim = d0 * d0 + d1 * d1;
      const float keogh = acc[i][j];
      const float bound = (kim != kim || keogh != keogh)
                              ? __int_as_float(0x7fc00000)
                              : fmaxf(kim, keogh);
      // padding centroids (k >= K) take the last key, after every NaN
      key[j] = k < K ? order_key(bound) : 0xffffffffu;
    }
    // the largest key v with #(keys < v) <= T: the (T+1)-th smallest key
    unsigned pivot = 0;
    for (int b = 31; b >= 0; --b) {
      const unsigned v = pivot | (1u << b);
      unsigned below = 0;
#pragma unroll
      for (int j = 0; j < KJ; ++j) below += key[j] < v ? 1u : 0u;
      if (__reduce_add_sync(0xffffffffu, below) <= (unsigned)T) pivot = v;
    }
    unsigned less = 0;
#pragma unroll
    for (int j = 0; j < KJ; ++j) less += key[j] < pivot ? 1u : 0u;
    const unsigned need = T + 1 - __reduce_add_sync(0xffffffffu, less);
    // the keys below the pivot and the first `need` equal to it, in index
    // order (j, then lane), into T + 1 slots of (key, index)
    unsigned base = 0, equal_before = 0;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const bool eq = key[j] == pivot;
      const unsigned beq = __ballot_sync(0xffffffffu, eq);
      const bool pick =
          key[j] < pivot ||
          (eq && equal_before + __popc(beq & lanes_below) < need);
      const unsigned bp = __ballot_sync(0xffffffffu, pick);
      if (pick)
        slots[base + __popc(bp & lanes_below)] =
            ((unsigned long long)key[j] << 32) | (unsigned)(32 * j + lane);
      base += __popc(bp);
      equal_before += __popc(beq);
    }
    __syncwarp();
    const long long row = n * M + m;
    for (int e = lane; e <= T; e += 32) {
      const unsigned long long mine = slots[e];
      int rank = 0;
      for (int f = 0; f <= T; ++f) rank += slots[f] < mine ? 1 : 0;
      if (rank < T)
        cand[row * T + rank] = (long long)(mine & 0xffffffffu);
      else
        next_lb[row] = key_value((unsigned)(mine >> 32));
    }
    __syncwarp();  // the slots are the next series'
  }
}

template <int KJ, int ROWS, int KC>
int launch_filter(const float* segs, const float* cents, const float* up,
                  const float* lo, long long* cand, float* next_lb, int N,
                  int M, int K, int S, int T, int warps, int SC, int smem,
                  cudaStream_t stream) {
  auto kernel = lb_filter_topk_kernel<KJ, ROWS, KC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int R = warps * ROWS;
  const dim3 grid((N + R - 1) / R, M);
  kernel<<<grid, warps * 32, smem, stream>>>(segs, cents, up, lo, cand,
                                             next_lb, N, M, K, S, T, SC);
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

// The encode's LB filter, one launch: 1 <= T < K <= 32 * kj; (kj, rows, kc)
// one of the forms below, warps * 32 threads a CTA and smem bytes as the
// wrapper's filter_geometry gives them; cand (N, M, T) int64 and next_lb
// (N, M) float32 written in full.
int pq_lb_filter(const float* segs, const float* cents, const float* up,
                 const float* lo, long long* cand, float* next_lb, int N,
                 int M, int K, int S, int T, int kj, int rows, int kc,
                 int warps, int sc, int smem, void* stream) {
  if (N < 1 || M < 1 || S < 1 || T < 1 || T >= K || K > 32 * kj ||
      warps < 1 || warps > 8 || sc < 1 || sc > S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PQ_FILTER_FORM(KJ, ROWS, KC)                                        \
  if (kj == KJ && rows == ROWS && kc == KC)                                 \
    return launch_filter<KJ, ROWS, KC>(segs, cents, up, lo, cand, next_lb, \
                                       N, M, K, S, T, warps, sc, smem, s);
  PQ_FILTER_FORM(1, 8, 1)
  PQ_FILTER_FORM(2, 8, 2)
  PQ_FILTER_FORM(4, 8, 2)
  PQ_FILTER_FORM(8, 8, 2)
  PQ_FILTER_FORM(16, 4, 2)
  PQ_FILTER_FORM(32, 2, 2)
#undef PQ_FILTER_FORM
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
