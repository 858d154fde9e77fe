// Banded elastic cost on the H100: zipped pairs and all pairs.
//
// Replaces repro/kernels/dtw_band/kernel.py::dtw_band_compressed_kernel as
// launched by make_dtw_band_call (mode="compressed", zipped pairs
// (N,L) x (N,L) -> (N,)) and by make_dtw_band_cdist_call (broadcast_b,
// all pairs (N,L) x (M,L) -> (N,M)).
//
// One thread sweeps one pair with pqdtw::band_cost (wavefront.cuh, which
// says what bounds the DP and why).  Threads walk the pairs grid-stride,
// so the wrapper may cap the grid when the band rows live in a global
// scratch buffer.  In the all-pairs form consecutive threads take
// consecutive rows of A against the same row of B, so a warp reads one B
// row (broadcast) and the N*M pairs are never materialised.

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

}  // namespace

extern "C" {

int pq_dtw_band(const float* A, const float* B, float* out, const float* wt,
                float* scratch, int n, int L, int w, int measure, float p,
                int threads, int blocks, void* stream) {
  const size_t smem = pqdtw::band_smem_bytes(scratch, threads, w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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

const char* pq_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
