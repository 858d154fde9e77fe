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
// output, M fused multiply-adds more when quantised), so the (Na, Nb)
// output's write, and before it the M gathers an output makes.
//
// Each scan has two forms.  The row-staged form (adc_rows_kernel, one
// body for both scans, the wrappers' choice wherever one tile of 8
// queries' table rows fits in shared memory, and for the lookup from
// enough queries on) stages each query's M table rows (LUT[m, a^m, 0:K],
// or qlut[i, m, 0:K]) once per block and gathers from shared memory, a
// lane per query (see the note above it).  The symmetric thread form
// (adc_sym_kernel, an output a thread, every gather from the LUT in
// L1/L2: a warp's 32 lanes read one table row at 32 random columns) and
// the lookup's table form (adc_lookup_kernel, an output a thread, one
// query's M x K table staged per block) take the other shapes.  Both
// forms of a scan give the same bits.
//
// The sum over subspaces runs in the reference's order:
//   acc = 0; for m: acc += entry(m, ...); out = sqrtf(fmaxf(acc, 0)).

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTileJ = 32;  // outputs along Nb (threadIdx.x): coalesced writes
constexpr int kTileI = 8;   // outputs along Na (threadIdx.y)

enum TableType : int { kInt8 = 0, kBF16 = 1, kF32 = 2 };

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

// The row-staged scans, symmetric and asymmetric (one body, kLookup).  A
// block owns a tile of TA queries and a chunk of code rows (codes_b, or
// the lookup's codes).  It stages the tile's table rows in shared memory,
// laid out [m][i][pitch] (pitch in 4-byte words, = 32/TA (mod 32): 1 at
// TA = 32), by 4-byte asynchronous copies (the pitch leaves a row 4-byte
// aligned only), once for the whole chunk.  Query i's row for subspace m
// is LUT[m, a_i^m, 0:K] in the symmetric scan and qlut[i, m, 0:K] in the
// lookup (a tile's TA x M rows contiguous in the source).  Lane (i, s) of
// a warp owns query i of the tile and, in each step, code row s of the
// step's 32/TA rows: it reads entry c = b^m of row (m, i) at word
// (m TA + i) pitch + c / (4 / sizeof T), in bank (32/TA) i + c / (4 /
// sizeof T) (mod 32): the TA lanes of one code row hit TA different
// banks, and at TA = 32 a warp's gather is conflict-free (at TA = 16 the
// two rows' lanes fall on the same 16 banks when their columns have the
// same parity: two wavefronts).  Each warp walks groups of 16 code rows on
// its own, 32 warps a block: it holds the next group's codes in registers
// while it works on this one, stages this group's as byte offsets (m TA
// pitch + b^m) sizeof T into the rows (read by broadcast, so a gather is
// one add and one load from a 32-bit shared address), takes two rows a
// lane at a time, writes its TA x 16 outputs to its own tile in shared
// memory, and stores them a query row at a time, 16 consecutive floats:
// coalesced along the code rows.  No block-wide barrier after the
// staging.  A quantised table's affine is per subspace in the symmetric
// scan and per (query, subspace) in the lookup: in registers where M is
// known (each lane its own query's), else a 1 x M or TA x M block in
// shared memory.  What bounds it: the instructions a warp step issues (an
// exact sqrtf a good share of them) and the shared-memory wavefronts of
// its M gathers, the broadcast offsets and the output tile.  The sum runs
// as in adc_sym_kernel and adc_lookup_kernel, so the bits are the same.
constexpr int kRowsWarps = 32;
constexpr int kRowsThreads = 32 * kRowsWarps;
constexpr int kGroupRows = 16;  // code rows a warp takes at a time

// Words of shared memory a warp of the row-staged form keeps for itself:
// its group's code offsets, then its TA x (16 + 32/TA) output tile (the
// pitch over 32/TA is odd, so lanes (i, s) write 32 different banks).
__host__ __device__ inline int rows_warp_words(int ta, int M) {
  return kGroupRows * M + ta * (kGroupRows + 32 / ta);
}

// the staged rows, the warps' words, and a quantised table's scale and
// zero: M of each, or TA x M of each in the lookup
__host__ __device__ inline size_t rows_smem_bytes(int ta, int M, int pitch,
                                                  bool quant, bool lookup) {
  return 4 * ((size_t)M * ta * pitch + (size_t)kRowsWarps *
              rows_warp_words(ta, M) +
              (quant ? 2 * (size_t)M * (lookup ? ta : 1) : 0));
}

// A staged table entry at a 32-bit shared-memory address (on sm_90 the
// shared window's base is not a constant, so a generic pointer would cost
// each gather two additions).
template <typename T>
__device__ __forceinline__ T lds(unsigned addr);
template <>
__device__ __forceinline__ float lds<float>(unsigned addr) {
  float v;
  asm("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}
template <>
__device__ __forceinline__ int8_t lds<int8_t>(unsigned addr) {
  int v;
  asm("ld.shared.s8 %0, [%1];" : "=r"(v) : "r"(addr));
  return static_cast<int8_t>(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 lds<__nv_bfloat16>(unsigned addr) {
  unsigned short v;
  asm("ld.shared.u16 %0, [%1];" : "=h"(v) : "r"(addr));
  return __ushort_as_bfloat16(v);
}

// ca: the symmetric scan's codes_a (unread by the lookup); cb: codes_b or
// the lookup's codes; table: the (M, K, K) LUT or the (Na, M, K) query
// tables; out (Na, Nb).
template <typename T, int TA, int MC, bool kLookup>
__global__ void __launch_bounds__(kRowsThreads, 1)
    adc_rows_kernel(const int* __restrict__ ca, const int* __restrict__ cb,
                    const T* __restrict__ table,
                    const float* __restrict__ scale,
                    const float* __restrict__ zero, float* __restrict__ out,
                    int Na, int Nb, int M_arg, int K, int pitch, int chunk) {
  constexpr int R = 32 / TA;            // code rows a warp step
  constexpr int OP = kGroupRows + R;    // output tile pitch
  constexpr bool kQuant = !std::is_same<T, float>::value;
  constexpr int kAff = kLookup ? TA : 1;  // affine values a subspace
  // codes a lane holds for the next group (M known)
  constexpr int kPer = MC > 0 ? kGroupRows * MC / 32 : 1;
  static_assert(MC == 0 || (kGroupRows * MC) % 32 == 0, "whole lanes");
  const int M = MC > 0 ? MC : M_arg;
  const int pe = pitch * (4 / (int)sizeof(T));  // the pitch in entries
  extern __shared__ __align__(16) uint32_t smem_w[];
  int* offs = reinterpret_cast<int*>(smem_w) + (size_t)M * TA * pitch +
              (size_t)(threadIdx.x / 32) * rows_warp_words(TA, M);
  float* so = reinterpret_cast<float*>(offs + kGroupRows * M);
  float* s_sc = reinterpret_cast<float*>(smem_w) + (size_t)M * TA * pitch +
                (size_t)kRowsWarps * rows_warp_words(TA, M);
  float* s_zp = s_sc + M * kAff;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int qi = lane % TA, sub = lane / TA;
  // a quantised table's affine where M is known (this lane's query's)
  float r_sc[MC > 0 ? MC : 1], r_zp[MC > 0 ? MC : 1];

  const int j_begin = blockIdx.x * chunk;
  const int j_end = min(j_begin + chunk, Nb);
  const int first = j_begin + warp * kGroupRows;
  constexpr int kStride = kRowsWarps * kGroupRows;
  const int words = K * (int)sizeof(T) / 4;  // K sizeof(T) % 4 == 0
  const int n_tiles = (Na + TA - 1) / TA;
  // byte offset of entry c of row (m, i) from row (0, i)
  auto offset = [&](int m, int c) {
    return (m * TA * pe + c) * (int)sizeof(T);
  };
  // a group's codes, lane-strided: code e = r M + m of rows j0 ..
  auto load_codes = [&](int j0, int* dst) {
    const int* src = cb + (long long)j0 * M + lane;
    const int left = min(kGroupRows, j_end - j0) * M - lane;
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      dst[k] = 32 * k < left ? __ldg(src + 32 * k) : 0;
  };
  for (int tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    const int i0 = tile * TA;
    const int valid = min(TA, Na - i0);
    // where subspace m's affine lies for tile query i (lanes past the
    // tile's last query take its values)
    auto affine_at = [&](int i, int m) {
      return kLookup ? (long long)(i0 + min(i, valid - 1)) * M + m
                     : (long long)m;
    };
    __syncthreads();  // the previous tile's rows are no longer read
    // warp w copies rows w, w + 32, ...: in the symmetric scan lane k
    // reads the code of the warp's k-th row up front (one round trip, not
    // one a row), 32 rows a round
    for (int row0 = warp; row0 < M * TA; row0 += 32 * kRowsWarps) {
      int a = 0;
      if constexpr (!kLookup) {
        const int lane_row = row0 + lane * kRowsWarps;
        if (lane_row < M * TA && lane_row % TA < valid)
          a = __ldg(ca + (long long)(i0 + lane_row % TA) * M + lane_row / TA);
      }
      for (int k = 0; k < 32; ++k) {
        const int row = row0 + k * kRowsWarps;
        if (row >= M * TA) break;
        const int m = row / TA, i = row % TA;
        long long src_row;
        if constexpr (kLookup)
          src_row = (long long)(i0 + i) * M + m;
        else
          src_row = (long long)m * K + __shfl_sync(0xffffffffu, a, k);
        if (i >= valid) continue;
        const uint32_t* src =
            reinterpret_cast<const uint32_t*>(table + src_row * K);
        uint32_t* dst = smem_w + (size_t)row * pitch;
        for (int w = lane; w < words; w += 32)
          __pipeline_memcpy_async(dst + w, src + w, 4);
      }
    }
    __pipeline_commit();
    if constexpr (kQuant && MC > 0) {
#pragma unroll
      for (int m = 0; m < MC; ++m) {
        r_sc[m] = __ldg(scale + affine_at(qi, m));
        r_zp[m] = __ldg(zero + affine_at(qi, m));
      }
    } else if constexpr (kQuant) {
      for (int e = threadIdx.x; e < M * kAff; e += kRowsThreads) {
        s_sc[e] = scale[affine_at(e % kAff, e / kAff)];
        s_zp[e] = zero[affine_at(e % kAff, e / kAff)];
      }
    }
    int next[kPer];
    if (MC > 0 && first < j_end) load_codes(first, next);
    __pipeline_wait_prior(0);
    __syncthreads();
    // lanes past the tile's last query read its rows; they store nothing
    const unsigned mine =
        static_cast<unsigned>(__cvta_generic_to_shared(smem_w)) +
        min(qi, valid - 1) * pe * (int)sizeof(T);
    for (int j0 = first; j0 < j_end; j0 += kStride) {
      const int nj = min(kGroupRows, j_end - j0);
      __syncwarp();  // the last group's offsets and outputs are read
      if constexpr (MC > 0) {
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int e = lane + 32 * k;
          offs[e] = offset(e % MC, next[k]);
        }
        if (j0 + kStride < j_end) load_codes(j0 + kStride, next);
      } else {
        for (int e = lane; e < kGroupRows * M; e += 32) {
          const int c = e / M < nj ? __ldg(cb + (long long)j0 * M + e) : 0;
          offs[e] = offset(e % M, c);
        }
      }
      __syncwarp();
      if constexpr (MC > 0) {
        // two code rows a lane at a time: r and r + R
#pragma unroll 1
        for (int r = sub; r < kGroupRows; r += 2 * R) {
          int o0[MC], o1[MC];
#pragma unroll
          for (int q = 0; q < MC / 4; ++q) {
            const int4 u = reinterpret_cast<const int4*>(offs + r * MC)[q];
            const int4 v =
                reinterpret_cast<const int4*>(offs + (r + R) * MC)[q];
            o0[4 * q] = u.x, o0[4 * q + 1] = u.y, o0[4 * q + 2] = u.z;
            o0[4 * q + 3] = u.w;
            o1[4 * q] = v.x, o1[4 * q + 1] = v.y, o1[4 * q + 2] = v.z;
            o1[4 * q + 3] = v.w;
          }
          T e0[MC], e1[MC];
#pragma unroll
          for (int m = 0; m < MC; ++m) {
            e0[m] = lds<T>(mine + o0[m]);
            e1[m] = lds<T>(mine + o1[m]);
          }
          float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
          for (int m = 0; m < MC; ++m) {
            acc0 += entry<T>(e0[m], r_sc, r_zp, m);
            acc1 += entry<T>(e1[m], r_sc, r_zp, m);
          }
          so[qi * OP + r] = sqrtf(fmaxf(acc0, 0.f));
          so[qi * OP + r + R] = sqrtf(fmaxf(acc1, 0.f));
        }
      } else {
        // this lane's affine: subspace m's at s_sc[m kAff + (qi or 0)]
        const int aq = kLookup ? qi : 0;
        for (int r = sub; r < kGroupRows; r += R) {
          const int* o = offs + r * M;
          float acc = 0.f;
          for (int m = 0; m < M; ++m)
            acc += entry<T>(lds<T>(mine + o[m]), s_sc + aq, s_zp + aq,
                            m * kAff);
          so[qi * OP + r] = sqrtf(fmaxf(acc, 0.f));
        }
      }
      __syncwarp();
      // lane l stores column l % 16 of query rows l / 16, + 2, ...
      constexpr int kRowsAStore = 32 / kGroupRows;
      const int c = lane % kGroupRows;
      if (c < nj) {
        const float* src = so + (lane / kGroupRows) * OP + c;
        float* dst = out + (long long)(i0 + lane / kGroupRows) * Nb + j0 + c;
#pragma unroll 4
        for (int i = lane / kGroupRows; i < valid; i += kRowsAStore) {
          *dst = *src;
          src += kRowsAStore * OP;
          dst += (long long)kRowsAStore * Nb;
        }
      }
    }
  }
}

// An output a thread, one query's whole (M, K) table staged per block:
// the lookup's form where a tile of query rows does not fit, or where too
// few queries would leave most of a tile's lanes idle.
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

template <typename T, int TA, int MC, bool kLookup>
int launch_rows_t(const int* ca, const int* cb, const T* table,
                  const float* sc, const float* zp, float* out, int Na,
                  int Nb, int M, int K, int pitch, int chunk, int grid_y,
                  cudaStream_t stream) {
  const size_t smem = rows_smem_bytes(
      TA, M, pitch, !std::is_same<T, float>::value, kLookup);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        adc_rows_kernel<T, TA, MC, kLookup>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Nb + chunk - 1) / chunk, grid_y);
  adc_rows_kernel<T, TA, MC, kLookup><<<grid, kRowsThreads, smem, stream>>>(
      ca, cb, table, sc, zp, out, Na, Nb, M, K, pitch, chunk);
  return (int)cudaGetLastError();
}

// TA queries a tile (8, 16 or 32), the subspaces' loop unrolled at M = 8
template <typename T, bool kLookup>
int launch_rows(const int* ca, const int* cb, const T* table,
                const float* sc, const float* zp, float* out, int Na, int Nb,
                int M, int K, int ta, int pitch, int chunk, int grid_y,
                cudaStream_t stream) {
  if ((K * (int)sizeof(T)) % 4 != 0 || pitch < K * (int)sizeof(T) / 4 ||
      chunk < 1 || grid_y < 1)
    return (int)cudaErrorInvalidValue;
#define PQ_ADC_ROWS(TA)                                                    \
  (M == 8 ? launch_rows_t<T, TA, 8, kLookup>(ca, cb, table, sc, zp, out,  \
                                             Na, Nb, M, K, pitch, chunk,  \
                                             grid_y, stream)              \
          : launch_rows_t<T, TA, 0, kLookup>(ca, cb, table, sc, zp, out,  \
                                             Na, Nb, M, K, pitch, chunk,  \
                                             grid_y, stream))
  switch (ta) {
    case 8:
      return PQ_ADC_ROWS(8);
    case 16:
      return PQ_ADC_ROWS(16);
    case 32:
      return PQ_ADC_ROWS(32);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PQ_ADC_ROWS
}

// the row-staged form over a float32 (type 2), int8 (0) or bfloat16 (1)
// table; scale and zero are read for the last two only
template <bool kLookup>
int launch_rows_typed(const int* ca, const int* cb, const void* table,
                      const float* sc, const float* zp, float* out, int Na,
                      int Nb, int M, int K, int type, int ta, int pitch,
                      int chunk, int grid_y, cudaStream_t s) {
  switch (type) {
    case kF32:
      return launch_rows<float, kLookup>(
          ca, cb, static_cast<const float*>(table), nullptr, nullptr, out,
          Na, Nb, M, K, ta, pitch, chunk, grid_y, s);
    case kInt8:
      return launch_rows<int8_t, kLookup>(
          ca, cb, static_cast<const int8_t*>(table), sc, zp, out, Na, Nb, M,
          K, ta, pitch, chunk, grid_y, s);
    case kBF16:
      return launch_rows<__nv_bfloat16, kLookup>(
          ca, cb, static_cast<const __nv_bfloat16*>(table), sc, zp, out, Na,
          Nb, M, K, ta, pitch, chunk, grid_y, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
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

// The row-staged symmetric scan, table type 2 (float32), 0 (int8) or 1
// (bfloat16).
int pq_adc_sym_rows(const int* ca, const int* cb, const void* lut,
                    const float* scale, const float* zero, float* out, int Na,
                    int Nb, int M, int K, int type, int ta, int pitch,
                    int chunk, int grid_y, void* stream) {
  return launch_rows_typed<false>(ca, cb, lut, scale, zero, out, Na, Nb, M,
                                  K, type, ta, pitch, chunk, grid_y,
                                  static_cast<cudaStream_t>(stream));
}

// The row-staged lookup: codes (N, M) against query tables (Nq, M, K) of
// type 2, 0 or 1; scale and zero (Nq * M,) for a quantised table.
int pq_adc_lookup_rows(const void* qlut, const float* scale,
                       const float* zero, const int* codes, float* out,
                       int Nq, int N, int M, int K, int type, int ta,
                       int pitch, int chunk, int grid_y, void* stream) {
  return launch_rows_typed<true>(nullptr, codes, qlut, scale, zero, out, Nq,
                                 N, M, K, type, ta, pitch, chunk, grid_y,
                                 static_cast<cudaStream_t>(stream));
}

// Shared memory a block of the row-staged form takes (the selectors in
// pq_adc/ops.py compute the same).
size_t pq_adc_sym_rows_smem_bytes(int type, int ta, int M, int pitch) {
  return rows_smem_bytes(ta, M, pitch, type != kF32, false);
}
size_t pq_adc_lookup_rows_smem_bytes(int type, int ta, int M, int pitch) {
  return rows_smem_bytes(ta, M, pitch, type != kF32, true);
}

}  // extern "C"
