// Decode attention over a PQ-coded key cache on the H100 (flash-decoding,
// split over the cached positions).
//
// Replaces repro/kernels/pq_attn/kernel.py::pq_attn_kernel as launched by
// make_pq_attn_call: one new token's query heads against a cache whose
// keys are M codes each.  The score of cached position s for head h is
//
//   scale * sum_m qlut[h, m, code[s, g(h), m]]
//
// (the paper's asymmetric distance, specialised to dot products), masked
// to the positions [start, valid_len); softmax over positions; the output
// is the softmax-weighted sum of the exact cached values.  start > 0 is a
// sliding window's first position (gemma2's local layers: the coded tail
// (pos - window, pos - W]); start = 0 is the whole prefix.
//
// Layouts (row-major, contiguous):
//   qlut   (B, G*R, M, K)  float32 or bf16: head h = g*R + r reads group g
//   codes  (B, S, G, M)    uint8 or int32 (the PQ cache's own layout)
//   v      (B, S, G, Dv)   float32 or bf16
//   out    (B, G*R, Dv)    float32, normalised
//   m, l   (B, G*R)        float32: the largest score and the denominator
//                          sum exp(score - m), so that a caller can merge
//                          another softmax piece
//
// What bounds it: bytes.  Each position costs M code bytes and Dv value
// elements per group, read once; the table is read once per CTA from L2.
// At the serving shapes (B=8, tail 1921, G=8, R=2, M=8, K=256, Dv=128,
// bf16 table and values, uint8 codes) that is about 32.5 MB a call,
// 0.0099 ms at 3.35 TB/s.  The TPU kernel walks KV blocks sequentially on
// one core; one CTA per (row, group) would give 64 CTAs on 132 SMs, each
// waiting on one tile's loads at a time.
//
// Design.  The grid is (B*G, n_split): the range [start, valid_len) is
// cut into n_split chunks of `chunk` positions, split s taking
// [start + s * chunk, ...) (kernels/pq_attn/ops.py::split_geometry over
// valid_len - start: at the serving shape 8 chunks of 256, 512 CTAs,
// about 4 on each SM).  A CTA of 256 threads:
//
//   1. stages its group's R x M x K table in shared memory (8 KiB in bf16)
//      in the type the caller gives it, in 16-byte pieces;
//   2. scores its whole chunk, one thread a position: the M code bytes in
//      one 8-byte load (uint8, M = 8), a shared-memory gather and sum per
//      head, into R x chunk floats of shared memory;
//   3. takes one block max per head, one exp pass over the chunk in place
//      and one block sum (no online rescale: the chunk is scored whole);
//   4. accumulates the weighted values: thread t owns VW adjacent value
//      columns (VW = 8 bf16 or 4 float32: 16 bytes) of column group
//      t % (Dv/VW) and every (256/(Dv/VW))-th position of the chunk, so
//      the 16 threads of one bf16 position read its 256 bytes side by side;
//      the position lanes' sums meet in shared memory in a fixed order.
//
// Merge, in the same launch.  With one split the CTA writes out, m and l
// itself.  Otherwise it writes (m, l, acc[R][Dv]) for its split to a
// float32 workspace that the wrapper allocates, fences, and takes a ticket
// on its (row, group)'s counter with atomicAdd; the CTA that draws the
// last ticket merges the n_split partials in split order 0..n-1 (m = max
// m_s, l = sum l_s exp(m_s - m), out = sum acc_s exp(m_s - m) / l),
// writes out, m and l, and resets the counter to 0.  The result does not
// depend on the order the CTAs arrive in, and the decode step gains no
// launch.  The counters (int32, one per row x group) are zeroed once by
// the wrapper and left at 0 by every launch; launches that share them
// must be ordered (one stream).
//
// Masked positions never enter the sums.  An empty range (start >=
// valid_len, one split) returns out = 0, m = -1e30, l = 0, the TPU
// kernel's initial scratch.  A code >= K is clamped to K - 1 (never a fault; the wrapper
// documents the range).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 8;
constexpr float kNegInit = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void bf2(unsigned bits, float* o) {
  const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(&bits);
  o[0] = __low2float(t);
  o[1] = __high2float(t);
}

// VW adjacent values as float32: 16 bytes of float or of bf16 (VW = 8), or
// 8 bytes of bf16 (VW = 4, a value width not divisible by 8).
template <int VW>
__device__ __forceinline__ void load_values(const float* p, float* o) {
  static_assert(VW == 4, "float32 values are read 4 at a time");
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = t.x;
  o[1] = t.y;
  o[2] = t.z;
  o[3] = t.w;
}
template <int VW>
__device__ __forceinline__ void load_values(const __nv_bfloat16* p,
                                            float* o) {
  if constexpr (VW == 8) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    bf2(t.x, o);
    bf2(t.y, o + 2);
    bf2(t.z, o + 4);
    bf2(t.w, o + 6);
  } else {
    static_assert(VW == 4, "bf16 values are read 4 or 8 at a time");
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    bf2(t.x, o);
    bf2(t.y, o + 2);
  }
}

// Add the R heads' table entries of code `code` in subspace mm to sc.
template <int RB, typename TT>
__device__ __forceinline__ void add_entry(const TT* lut, int M, int K, int R,
                                          int mm, unsigned code, float* sc) {
  const TT* e = lut + mm * K + (code < (unsigned)K ? code : K - 1);
#pragma unroll
  for (int r = 0; r < RB; ++r)
    if (r < R) sc[r] += to_f(e[(size_t)r * M * K]);
}

// Sum one position's codes c[0..M) into sc.  vec: M divides into whole
// 8-byte (uint8) or 16-byte (int32) loads and the codes are aligned to them.
template <int RB, typename TT>
__device__ __forceinline__ void score(const TT* lut, const uint8_t* c, int M,
                                      int K, int R, bool vec, float* sc) {
  if (vec) {
    for (int mm = 0; mm < M; mm += 8) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(c + mm));
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const unsigned word = k < 4 ? t.x : t.y;
        add_entry<RB>(lut, M, K, R, mm + k, (word >> (8 * (k & 3))) & 0xffu,
                      sc);
      }
    }
  } else {
    for (int mm = 0; mm < M; ++mm) add_entry<RB>(lut, M, K, R, mm, c[mm], sc);
  }
}

template <int RB, typename TT>
__device__ __forceinline__ void score(const TT* lut, const int32_t* c, int M,
                                      int K, int R, bool vec, float* sc) {
  if (vec) {
    for (int mm = 0; mm < M; mm += 4) {
      const int4 t = __ldg(reinterpret_cast<const int4*>(c + mm));
      add_entry<RB>(lut, M, K, R, mm, (unsigned)t.x, sc);
      add_entry<RB>(lut, M, K, R, mm + 1, (unsigned)t.y, sc);
      add_entry<RB>(lut, M, K, R, mm + 2, (unsigned)t.z, sc);
      add_entry<RB>(lut, M, K, R, mm + 3, (unsigned)t.w, sc);
    }
  } else {
    for (int mm = 0; mm < M; ++mm)
      add_entry<RB>(lut, M, K, R, mm, (unsigned)c[mm], sc);
  }
}

// Position lanes of the value pass: 256 threads over Dv / VW column groups.
__host__ __device__ __forceinline__ int position_lanes(int Dv, int vw) {
  return kThreads / (Dv / vw);
}

// RB: the register bound on R (2 or kMaxR); VW: values per load.  At the
// serving shape (R = 2, bf16 values 8 a load) RB = 2 takes 64 registers a
// thread and RB = kMaxR 98, which halves the CTAs resident on an SM (4 to
// 2) and makes the launch about 1.6x slower on the H100 (PERF.md).
template <int RB, typename TT, typename CT, typename VT, int VW>
__global__ void __launch_bounds__(kThreads)
    pq_attn_kernel(const TT* __restrict__ qlut, const CT* __restrict__ codes,
                   const VT* __restrict__ v, float* __restrict__ out,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   float* __restrict__ ws, int* __restrict__ counters, int S,
                   int G, int R, int M, int K, int Dv, int range_start,
                   int valid_len, int chunk, float scale, int codes_vec,
                   int table_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_cg = Dv / VW;                  // column groups
  const int n_pl = position_lanes(Dv, VW);   // position lanes (>= 2)
  float* sc_s = reinterpret_cast<float*>(smem);       // (R, chunk)
  float* red_max = sc_s + (size_t)R * chunk;          // (R, kWarps)
  float* red_sum = red_max + R * kWarps;              // (R, kWarps)
  float* part = red_sum + R * kWarps;                 // (n_pl, R, Dv)
  TT* lut = reinterpret_cast<TT*>(part + (size_t)n_pl * R * Dv);

  const int row = blockIdx.x;  // b * G + g
  const int b = row / G;
  const int g = row % G;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int start = range_start + split * chunk;
  const int n = max(0, min(chunk, valid_len - start));
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int RMK = R * M * K;

  // 1. the group's table
  const TT* q_src = qlut + (size_t)row * RMK;
  if (table_vec) {
    const int n16 = RMK * (int)sizeof(TT) / 16;
    const uint4* src = reinterpret_cast<const uint4*>(q_src);
    uint4* dst = reinterpret_cast<uint4*>(lut);
    for (int i = tid; i < n16; i += kThreads) dst[i] = __ldg(src + i);
  } else {
    for (int i = tid; i < RMK; i += kThreads) lut[i] = q_src[i];
  }
  __syncthreads();

  // 2. scores of the chunk, and this thread's max per head
  const size_t c_stride = (size_t)G * M;
  const CT* c_base = codes + ((size_t)b * S + start) * c_stride +
                     (size_t)g * M;
  float mx[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) mx[r] = kNegInit;
  for (int p = tid; p < n; p += kThreads) {
    float sc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) sc[r] = 0.f;
    score<RB>(lut, c_base + (size_t)p * c_stride, M, K, R, codes_vec != 0,
              sc);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < R) {
        const float s = sc[r] * scale;
        sc_s[(size_t)r * chunk + p] = s;
        mx[r] = fmaxf(mx[r], s);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r < R) {
      float x = mx[r];
      for (int o = 16; o > 0; o >>= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
      if (lane == 0) red_max[r * kWarps + warp] = x;
    }
  }
  __syncthreads();

  // 3. one block max, one exp pass in place, one block sum
  float bmax[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    bmax[r] = kNegInit;
    if (r < R) {
      for (int w = 0; w < kWarps; ++w)
        bmax[r] = fmaxf(bmax[r], red_max[r * kWarps + w]);
      float sum = 0.f;
      for (int p = tid; p < n; p += kThreads) {
        float* e = sc_s + (size_t)r * chunk + p;
        const float x = expf(*e - bmax[r]);
        *e = x;
        sum += x;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) red_sum[r * kWarps + warp] = sum;
    }
  }
  __syncthreads();

  // 4. the weighted values: VW columns of group cg over position lane pl
  const int cg = tid % n_cg;
  const int pl = tid / n_cg;
  if (pl < n_pl) {
    float acc[RB][VW];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int c = 0; c < VW; ++c) acc[r][c] = 0.f;
    const size_t v_stride = (size_t)G * Dv;
    const VT* v_base = v + ((size_t)b * S + start) * v_stride +
                       (size_t)g * Dv + (size_t)cg * VW;
#pragma unroll 4
    for (int j = pl; j < n; j += n_pl) {
      float vv[VW];
      load_values<VW>(v_base + (size_t)j * v_stride, vv);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < R) {
          const float p = sc_s[(size_t)r * chunk + j];
#pragma unroll
          for (int c = 0; c < VW; ++c) acc[r][c] = __fmaf_rn(p, vv[c], acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < R) {
#pragma unroll
        for (int c = 0; c < VW; ++c)
          part[((size_t)pl * R + r) * Dv + cg * VW + c] = acc[r][c];
      }
    }
  }
  __syncthreads();

  // this split's (m, l, acc): the lanes' sums in lane order
  const size_t head0 = (size_t)row * R;
  float* ws_acc = ws;
  float* ws_ml = ws + (size_t)gridDim.x * n_split * R * Dv;
  const size_t slot = (size_t)row * n_split + split;
  for (int idx = tid; idx < R * Dv; idx += kThreads) {
    const int r = idx / Dv;
    const int d = idx % Dv;
    float a = 0.f;
    for (int q = 0; q < n_pl; ++q) a += part[((size_t)q * R + r) * Dv + d];
    float l = 0.f;
    for (int w = 0; w < kWarps; ++w) l += red_sum[r * kWarps + w];
    float mr = kNegInit;
    for (int w = 0; w < kWarps; ++w) mr = fmaxf(mr, red_max[r * kWarps + w]);
    if (n_split == 1) {
      out[(head0 + r) * Dv + d] = a / fmaxf(l, 1e-30f);
      if (d == 0) {
        m_out[head0 + r] = mr;
        l_out[head0 + r] = l;
      }
    } else {
      ws_acc[(slot * R + r) * Dv + d] = a;
      if (d == 0) {
        ws_ml[(slot * R + r) * 2] = mr;
        ws_ml[(slot * R + r) * 2 + 1] = l;
      }
    }
  }
  if (n_split == 1) return;

  // the last CTA of this (row, group) to finish merges the splits in order
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + row, 1) == n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const size_t first = (size_t)row * n_split;
  for (int idx = tid; idx < R * Dv; idx += kThreads) {
    const int r = idx / Dv;
    const int d = idx % Dv;
    float mr = kNegInit;
    for (int s = 0; s < n_split; ++s)
      mr = fmaxf(mr, __ldcg(ws_ml + ((first + s) * R + r) * 2));
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float w =
          expf(__ldcg(ws_ml + ((first + s) * R + r) * 2) - mr);
      l += __ldcg(ws_ml + ((first + s) * R + r) * 2 + 1) * w;
      a += __ldcg(ws_acc + ((first + s) * R + r) * Dv + d) * w;
    }
    out[(head0 + r) * Dv + d] = a / fmaxf(l, 1e-30f);
    if (d == 0) {
      m_out[head0 + r] = mr;
      l_out[head0 + r] = l;
    }
  }
  if (tid == 0) counters[row] = 0;
}

struct Args {
  const void* qlut;
  const void* codes;
  const void* v;
  float* out;
  float* m;
  float* l;
  float* ws;
  int* counters;
  int rows, n_split, S, G, R, M, K, Dv, start, valid_len, chunk;
  float scale;
  int codes_vec, table_vec;
  size_t smem;
  cudaStream_t stream;
};

template <int RB, typename TT, typename CT, typename VT, int VW>
int launch(const Args& a) {
  auto kernel = pq_attn_kernel<RB, TT, CT, VT, VW>;
  if (a.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(a.rows, a.n_split), kThreads, a.smem, a.stream>>>(
      static_cast<const TT*>(a.qlut), static_cast<const CT*>(a.codes),
      static_cast<const VT*>(a.v), a.out, a.m, a.l, a.ws, a.counters, a.S,
      a.G, a.R, a.M, a.K, a.Dv, a.start, a.valid_len, a.chunk, a.scale,
      a.codes_vec, a.table_vec);
  return (int)cudaGetLastError();
}

template <int RB, typename TT, typename CT>
int by_values(int values_bf16, int vw, const Args& a) {
  if (!values_bf16) return launch<RB, TT, CT, float, 4>(a);
  return vw == 8 ? launch<RB, TT, CT, __nv_bfloat16, 8>(a)
                 : launch<RB, TT, CT, __nv_bfloat16, 4>(a);
}

template <int RB, typename TT>
int by_codes(int codes_u8, int values_bf16, int vw, const Args& a) {
  return codes_u8 ? by_values<RB, TT, uint8_t>(values_bf16, vw, a)
                  : by_values<RB, TT, int32_t>(values_bf16, vw, a);
}

template <int RB>
int by_table(int table_bf16, int codes_u8, int values_bf16, int vw,
             const Args& a) {
  return table_bf16
             ? by_codes<RB, __nv_bfloat16>(codes_u8, values_bf16, vw, a)
             : by_codes<RB, float>(codes_u8, values_bf16, vw, a);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA, in bytes (the wrapper checks it
// against the card's 227 KB before launching): the chunk's scores, the
// block reductions, the position lanes' value sums and the table.
size_t pq_attn_smem_bytes(int R, int M, int K, int Dv, int chunk, int vw,
                          int table_bf16) {
  const int n_pl = position_lanes(Dv, vw);
  return sizeof(float) * ((size_t)R * chunk + (size_t)2 * R * kWarps +
                          (size_t)n_pl * R * Dv) +
         (size_t)R * M * K * (table_bf16 ? 2 : 4);
}

// ws: rows * n_split * R * (Dv + 2) floats when n_split > 1 (unused at 1);
// counters: rows int32, all 0.  vw: values per load (4, or 8 for bf16
// values whose width and storage allow 16-byte loads).  The range is
// [start, valid_len); the splits cover its max(valid_len - start, 0)
// positions, none of them empty.
int pq_attn(const void* qlut, const void* codes, const void* v, float* out,
            float* m, float* l, float* ws, int* counters, int B, int S,
            int G, int R, int M, int K, int Dv, int start, int valid_len,
            int chunk, int n_split, int vw, float scale, int table_bf16,
            int codes_u8, int values_bf16, void* stream) {
  const long long len = valid_len > start ? valid_len - start : 0;
  if (R < 1 || R > kMaxR || Dv < 4 || Dv > 512 || Dv % vw != 0 ||
      (vw != 4 && vw != 8) || (vw == 8 && !values_bf16) || valid_len < 0 ||
      valid_len > S || start < 0 || start > S || chunk < 1 || n_split < 1 ||
      n_split > 65535 ||
      (long long)(n_split - 1) * chunk >= (len > 0 ? len : 1) ||
      (long long)n_split * chunk < len ||
      (n_split > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.qlut = qlut;
  a.codes = codes;
  a.v = v;
  a.out = out;
  a.m = m;
  a.l = l;
  a.ws = ws;
  a.counters = counters;
  a.rows = B * G;
  a.n_split = n_split;
  a.S = S;
  a.G = G;
  a.R = R;
  a.M = M;
  a.K = K;
  a.Dv = Dv;
  a.start = start;
  a.valid_len = valid_len;
  a.chunk = chunk;
  a.scale = scale;
  const int code_bytes = codes_u8 ? 1 : 4;
  const int code_vec = codes_u8 ? 8 : 4;  // codes per load
  a.codes_vec = M % code_vec == 0 &&
                reinterpret_cast<uintptr_t>(codes) % (code_vec * code_bytes)
                    == 0;
  const size_t table_bytes = (size_t)R * M * K * (table_bf16 ? 2 : 4);
  // 16-byte copies need the table's source and its place in shared
  // memory (after R * chunk + 16 R + n_pl R Dv floats) aligned to 16
  a.table_vec = table_bytes % 16 == 0 &&
                reinterpret_cast<uintptr_t>(qlut) % 16 == 0 &&
                ((size_t)R * chunk) % 4 == 0;
  a.smem = pq_attn_smem_bytes(R, M, K, Dv, chunk, vw, table_bf16);
  a.stream = static_cast<cudaStream_t>(stream);
  return R <= 2 ? by_table<2>(table_bf16, codes_u8, values_bf16, vw, a)
                : by_table<kMaxR>(table_bf16, codes_u8, values_bf16, vw, a);
}

}  // extern "C"
