// PQ distance scans on the H100: symmetric (code x code through the
// M x K x K LUT) and asymmetric (code x per-query M x K table).
//
// Replaces repro/kernels/pq_adc/kernel.py::adc_sym_kernel (launched by
// make_adc_sym_call) and ::adc_lookup_kernel (make_adc_lookup_call).  The
// TPU kernels rewrite each lookup as a one-hot matrix product because TPU
// gathers are slow; on Hopper a gather from L1/L2 or shared memory is the
// natural form, so these kernels gather and add.
//
// What bounds them on the H100: no arithmetic to speak of (M adds per
// output).  adc_sym is bound by M dependent gathers per output from a LUT
// that stays in L2 (8 x 256 x 256 float32 = 2 MiB at the main-path
// geometry) plus writing the (Na, Nb) output; adc_lookup by the output
// write, with each query's M x K table staged once per block in shared
// memory.  Codes of a tile are staged in shared memory so that each code
// is read from device memory once per tile, not once per output.
//
// The sum over subspaces runs in the reference's order:
//   acc = 0; for m: acc += table[m, ...]; out = sqrtf(fmaxf(acc, 0)).

#include <cuda_runtime.h>

namespace {

constexpr int kTileJ = 32;  // outputs along Nb (threadIdx.x): coalesced writes
constexpr int kTileI = 8;   // outputs along Na (threadIdx.y)

__global__ void adc_sym_kernel(const int* __restrict__ ca,
                               const int* __restrict__ cb,
                               const float* __restrict__ lut,
                               float* __restrict__ out, int Na, int Nb, int M,
                               int K) {
  extern __shared__ int codes_tile[];
  // Odd row pitch: threads of a warp read rows pitch apart without bank
  // conflicts.
  const int pitch = (M % 2 == 0) ? M + 1 : M;
  int* sa = codes_tile;                  // kTileI rows of A's codes
  int* sb = codes_tile + kTileI * pitch;  // kTileJ rows of B's codes
  const int flat = threadIdx.y * kTileJ + threadIdx.x;
  const int nthr = kTileI * kTileJ;
  const int j0 = blockIdx.x * kTileJ;
  for (int e = flat; e < kTileJ * M; e += nthr) {
    const int r = e / M, m = e % M, gj = j0 + r;
    sb[r * pitch + m] = gj < Nb ? cb[(long long)gj * M + m] : 0;
  }
  for (int i0 = blockIdx.y * kTileI; i0 < Na; i0 += gridDim.y * kTileI) {
    __syncthreads();  // the previous tile's reads of sa are done
    for (int e = flat; e < kTileI * M; e += nthr) {
      const int r = e / M, m = e % M, gi = i0 + r;
      sa[r * pitch + m] = gi < Na ? ca[(long long)gi * M + m] : 0;
    }
    __syncthreads();
    const int i = i0 + threadIdx.y, j = j0 + threadIdx.x;
    if (i < Na && j < Nb) {
      const int* ra = sa + threadIdx.y * pitch;
      const int* rb = sb + threadIdx.x * pitch;
      float acc = 0.f;
      for (int m = 0; m < M; ++m) {
        acc += __ldg(lut + ((long long)m * K + ra[m]) * K + rb[m]);
      }
      out[(long long)i * Nb + j] = sqrtf(fmaxf(acc, 0.f));
    }
  }
}

__global__ void adc_lookup_kernel(const float* __restrict__ qlut,
                                  const int* __restrict__ codes,
                                  float* __restrict__ out, int Nq, int N,
                                  int M, int K) {
  extern __shared__ float table[];  // one query's (M, K) table
  const int MK = M * K;
  for (int q = blockIdx.y; q < Nq; q += gridDim.y) {
    __syncthreads();  // the previous query's reads of table are done
    for (int e = threadIdx.x; e < MK; e += blockDim.x) {
      table[e] = qlut[(long long)q * MK + e];
    }
    __syncthreads();
    for (int n = blockIdx.x * blockDim.x + threadIdx.x; n < N;
         n += gridDim.x * blockDim.x) {
      const int* c = codes + (long long)n * M;
      float acc = 0.f;
      for (int m = 0; m < M; ++m) acc += table[m * K + __ldg(c + m)];
      out[(long long)q * N + n] = sqrtf(fmaxf(acc, 0.f));
    }
  }
}

}  // namespace

extern "C" {

int pq_adc_sym(const int* ca, const int* cb, const float* lut, float* out,
               int Na, int Nb, int M, int K, int grid_y, void* stream) {
  const int pitch = (M % 2 == 0) ? M + 1 : M;
  const size_t smem = (size_t)(kTileI + kTileJ) * pitch * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        adc_sym_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Nb + kTileJ - 1) / kTileJ, grid_y);
  dim3 block(kTileJ, kTileI);
  adc_sym_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      ca, cb, lut, out, Na, Nb, M, K);
  return (int)cudaGetLastError();
}

int pq_adc_lookup(const float* qlut, const int* codes, float* out, int Nq,
                  int N, int M, int K, int threads, int grid_x, int grid_y,
                  void* stream) {
  const size_t smem = (size_t)M * K * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        adc_lookup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(grid_x, grid_y);
  adc_lookup_kernel<<<grid, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(qlut, codes, out,
                                                           Nq, N, M, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
