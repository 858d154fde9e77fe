// PQ distance scans on the H100: symmetric (code x code through the
// M x K x K LUT) and asymmetric (code x per-query M x K table), over a
// float32 table or a quantised int8 / bfloat16 one.
//
// Replaces repro/kernels/pq_adc/kernel.py::adc_sym_kernel (launched by
// make_adc_sym_call), ::adc_lookup_kernel (make_adc_lookup_call) and their
// quantised forms ::adc_sym_quant_kernel (make_adc_sym_quant_call) and
// ::adc_lookup_quant_kernel (make_adc_lookup_quant_call).  The TPU kernels
// rewrite each lookup as a one-hot matrix product because TPU gathers are
// slow; on Hopper a gather from L1/L2 or shared memory is the natural
// form, so these kernels gather and add.  Each body is a template on the
// table's type T; a quantised entry is dequantised as it is selected,
// scale_m * q + zero_m with one rounding (the reference's compiler
// contracts that line into a fused multiply-add), per subspace m.
//
// What bounds them on the H100: no arithmetic to speak of (M adds per
// output, M fused multiply-adds more when quantised).  adc_sym is bound by
// M dependent gathers per output from a LUT that stays in L2 (8 x 256 x
// 256 at the main-path geometry: 2 MiB in float32, 512 KiB in int8) plus
// writing the (Na, Nb) output; adc_lookup by the output write, with each
// query's M x K table staged once per block in shared memory.  Codes of a
// tile are staged in shared memory so that each code is read from device
// memory once per tile, not once per output.
//
// The sum over subspaces runs in the reference's order:
//   acc = 0; for m: acc += entry(m, ...); out = sqrtf(fmaxf(acc, 0)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTileJ = 32;  // outputs along Nb (threadIdx.x): coalesced writes
constexpr int kTileI = 8;   // outputs along Na (threadIdx.y)

enum TableType : int { kInt8 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Subspace m's selected table entry as float32: itself, or dequantised
// (sc, zp are only read for a quantised table).
template <typename T>
__device__ __forceinline__ float entry(T v, const float* sc, const float* zp,
                                       int m) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __fmaf_rn(sc[m], to_f32(v), zp[m]);
  }
}

template <typename T>
__host__ __device__ constexpr int affine_floats(int M) {
  return std::is_same<T, float>::value ? 0 : 2 * M;
}

template <typename T>
__global__ void adc_sym_kernel(const int* __restrict__ ca,
                               const int* __restrict__ cb,
                               const T* __restrict__ lut,
                               const float* __restrict__ scale,
                               const float* __restrict__ zero,
                               float* __restrict__ out, int Na, int Nb, int M,
                               int K) {
  extern __shared__ int codes_tile[];
  // Odd row pitch: threads of a warp read rows pitch apart without bank
  // conflicts.
  const int pitch = (M % 2 == 0) ? M + 1 : M;
  int* sa = codes_tile;                  // kTileI rows of A's codes
  int* sb = codes_tile + kTileI * pitch;  // kTileJ rows of B's codes
  float* s_sc = reinterpret_cast<float*>(sb + kTileJ * pitch);  // (M,)
  float* s_zp = s_sc + M;                                       // (M,)
  const int flat = threadIdx.y * kTileJ + threadIdx.x;
  const int nthr = kTileI * kTileJ;
  const int j0 = blockIdx.x * kTileJ;
  for (int e = flat; e < kTileJ * M; e += nthr) {
    const int r = e / M, m = e % M, gj = j0 + r;
    sb[r * pitch + m] = gj < Nb ? cb[(long long)gj * M + m] : 0;
  }
  if (affine_floats<T>(M) > 0) {
    for (int m = flat; m < M; m += nthr) {
      s_sc[m] = scale[m];
      s_zp[m] = zero[m];
    }
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
        const T v = lut[((long long)m * K + ra[m]) * K + rb[m]];
        acc += entry<T>(v, s_sc, s_zp, m);
      }
      out[(long long)i * Nb + j] = sqrtf(fmaxf(acc, 0.f));
    }
  }
}

template <typename T>
__global__ void adc_lookup_kernel(const T* __restrict__ qlut,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ zero,
                                  const int* __restrict__ codes,
                                  float* __restrict__ out, int Nq, int N,
                                  int M, int K) {
  // one query's (M, K) table, then its (M,) scale and zero when quantised
  extern __shared__ float smem_f[];
  const int MK = M * K;
  T* table = reinterpret_cast<T*>(smem_f);
  float* s_sc = smem_f + (MK * (int)sizeof(T) + 3) / 4;
  float* s_zp = s_sc + M;
  for (int q = blockIdx.y; q < Nq; q += gridDim.y) {
    __syncthreads();  // the previous query's reads of the table are done
    for (int e = threadIdx.x; e < MK; e += blockDim.x) {
      table[e] = qlut[(long long)q * MK + e];
    }
    if (affine_floats<T>(M) > 0) {
      for (int m = threadIdx.x; m < M; m += blockDim.x) {
        s_sc[m] = scale[(long long)q * M + m];
        s_zp[m] = zero[(long long)q * M + m];
      }
    }
    __syncthreads();
    for (int n = blockIdx.x * blockDim.x + threadIdx.x; n < N;
         n += gridDim.x * blockDim.x) {
      const int* c = codes + (long long)n * M;
      float acc = 0.f;
      for (int m = 0; m < M; ++m) {
        acc += entry<T>(table[m * K + __ldg(c + m)], s_sc, s_zp, m);
      }
      out[(long long)q * N + n] = sqrtf(fmaxf(acc, 0.f));
    }
  }
}

template <typename T>
int launch_sym(const int* ca, const int* cb, const T* lut, const float* sc,
               const float* zp, float* out, int Na, int Nb, int M, int K,
               int grid_y, cudaStream_t stream) {
  const int pitch = (M % 2 == 0) ? M + 1 : M;
  const size_t smem = (size_t)(kTileI + kTileJ) * pitch * sizeof(int) +
                      (size_t)affine_floats<T>(M) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        adc_sym_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Nb + kTileJ - 1) / kTileJ, grid_y);
  dim3 block(kTileJ, kTileI);
  adc_sym_kernel<T><<<grid, block, smem, stream>>>(ca, cb, lut, sc, zp, out,
                                                   Na, Nb, M, K);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_lookup(const T* qlut, const float* sc, const float* zp,
                  const int* codes, float* out, int Nq, int N, int M, int K,
                  int threads, int grid_x, int grid_y, cudaStream_t stream) {
  const size_t table_floats = ((size_t)M * K * sizeof(T) + 3) / 4;
  const size_t smem =
      (table_floats + (size_t)affine_floats<T>(M)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        adc_lookup_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(grid_x, grid_y);
  adc_lookup_kernel<T><<<grid, threads, smem, stream>>>(qlut, sc, zp, codes,
                                                        out, Nq, N, M, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pq_adc_sym(const int* ca, const int* cb, const float* lut, float* out,
               int Na, int Nb, int M, int K, int grid_y, void* stream) {
  return launch_sym<float>(ca, cb, lut, nullptr, nullptr, out, Na, Nb, M, K,
                           grid_y, static_cast<cudaStream_t>(stream));
}

int pq_adc_lookup(const float* qlut, const int* codes, float* out, int Nq,
                  int N, int M, int K, int threads, int grid_x, int grid_y,
                  void* stream) {
  return launch_lookup<float>(qlut, nullptr, nullptr, codes, out, Nq, N, M,
                              K, threads, grid_x, grid_y,
                              static_cast<cudaStream_t>(stream));
}

int pq_adc_sym_quant(const int* ca, const int* cb, const void* lut,
                     const float* scale, const float* zero, float* out,
                     int Na, int Nb, int M, int K, int type, int grid_y,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (type) {
    case kInt8:
      return launch_sym<int8_t>(ca, cb, static_cast<const int8_t*>(lut),
                                scale, zero, out, Na, Nb, M, K, grid_y, s);
    case kBF16:
      return launch_sym<__nv_bfloat16>(
          ca, cb, static_cast<const __nv_bfloat16*>(lut), scale, zero, out,
          Na, Nb, M, K, grid_y, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int pq_adc_lookup_quant(const void* qlut, const float* scale,
                        const float* zero, const int* codes, float* out,
                        int Nq, int N, int M, int K, int type, int threads,
                        int grid_x, int grid_y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (type) {
    case kInt8:
      return launch_lookup<int8_t>(static_cast<const int8_t*>(qlut), scale,
                                   zero, codes, out, Nq, N, M, K, threads,
                                   grid_x, grid_y, s);
    case kBF16:
      return launch_lookup<__nv_bfloat16>(
          static_cast<const __nv_bfloat16*>(qlut), scale, zero, codes, out,
          Nq, N, M, K, threads, grid_x, grid_y, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
