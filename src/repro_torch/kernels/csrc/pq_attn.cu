// Decode attention over a PQ-coded key cache on the H100 (flash-decoding).
//
// Replaces repro/kernels/pq_attn/kernel.py::pq_attn_kernel as launched by
// make_pq_attn_call: one new token's query heads against a cache whose
// keys are M codes each.  The score of cached position s for head h is
//
//   scale * sum_m qlut[h, m, code[s, g(h), m]]
//
// (the paper's asymmetric distance, specialised to dot products), masked
// to the first valid_len positions; softmax over positions; the output is
// the softmax-weighted sum of the exact cached values.
//
// Layouts (row-major, contiguous):
//   qlut   (B, G*R, M, K)  float32 or bf16: head h = g*R + r reads group g
//   codes  (B, S, G, M)    uint8 or int32 (the PQ cache's own layout)
//   v      (B, S, G, Dv)   float32 or bf16
//   out    (B, G*R, Dv)    float32, normalised
//   m, l   (B, G*R)        float32: running max and denominator, so that a
//                          caller can merge another softmax piece
//
// Design.  The TPU kernel walks KV blocks sequentially on one core and
// forms scores as one-hot MXU contractions.  Here one CTA owns one
// (batch row, KV group) and walks its positions in tiles of 128:
//
//   1. the group's R x M x K query table is staged in shared memory once
//      (16 KiB at R=2, M=8, K=256 in float32, 8 KiB in bf16), in the type
//      the caller gives it;
//   2. one thread per position of the tile sums its M table entries
//      (a shared-memory gather, not a one-hot product) for each of the R
//      heads;
//   3. a warp-shuffle max and sum per head, combined across the 4 warps
//      in shared memory, update the running max m and denominator l
//      (online softmax, the TPU kernel's scratch m_ref / l_ref);
//   4. the value sum: thread t owns the 4 adjacent value columns of
//      group t % (Dv/4) and the tile positions j = t / (Dv/4) + k * n_pl
//      (n_pl = 128 / (Dv/4) position lanes; 4 at Dv = 128), so a warp
//      reads whole value rows in 8- or 16-byte pieces (coalesced); it
//      keeps R x 4 float32 accumulators in registers, rescaled by
//      exp(m_old - m_new) at every tile;
//   5. at the end the position lanes' partial sums are added in shared
//      memory and divided by l.
//
// What bounds it: bytes.  Each position costs M code bytes and Dv value
// elements per group, read once; the table stays in shared memory.  At
// the serving shapes (B=8, S~2k, G=8, M=8, Dv=128 bf16) that is about
// 32 MB, 0.01 ms at 3.35 TB/s.  One CTA per (row, group) gives 64 CTAs,
// under the 132 SMs, so this simple form is latency-bound; splitting the
// positions over more CTAs (a second merge pass) is the known next step.
//
// Masked positions never enter the sums (the tile loop stops at
// valid_len).  An empty prefix (valid_len = 0) returns out = 0, m = -1e30,
// l = 0, the TPU kernel's initial scratch.  A code >= K is clamped to
// K - 1 (never a fault; the wrapper documents the range).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 8;
constexpr float kNegInit = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four adjacent values as float32 (16 bytes of float, 8 of bf16).
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x;
  o[1] = t.y;
  o[2] = t.z;
  o[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  o[0] = __low2float(lo);
  o[1] = __high2float(lo);
  o[2] = __low2float(hi);
  o[3] = __high2float(hi);
}

template <typename TT, typename CT, typename VT>
__global__ void __launch_bounds__(kThreads)
    pq_attn_kernel(const TT* __restrict__ qlut, const CT* __restrict__ codes,
                   const VT* __restrict__ v, float* __restrict__ out,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   int S, int G, int R, int M, int K, int Dv, int valid_len,
                   float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_cg = Dv / 4;              // column groups of 4 values
  const int n_pl = kThreads / n_cg;     // position lanes (>= 1: Dv <= 512)
  float* p_s = reinterpret_cast<float*>(smem);        // (R, kThreads)
  float* red_max = p_s + R * kThreads;                // (R, kWarps)
  float* red_sum = red_max + R * kWarps;              // (R, kWarps)
  float* part = red_sum + R * kWarps;                 // (n_pl, R, Dv)
  TT* lut = reinterpret_cast<TT*>(part + (size_t)n_pl * R * Dv);

  const int b = blockIdx.x / G;
  const int g = blockIdx.x % G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cg = tid % n_cg;
  const int pl = tid / n_cg;            // >= n_pl: idle in the value sum
  const int RMK = R * M * K;

  const TT* q_src = qlut + ((size_t)b * G + g) * RMK;
  for (int i = tid; i < RMK; i += kThreads) lut[i] = q_src[i];

  float m_run[kMaxR], l_run[kMaxR], acc[kMaxR][4];
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    m_run[r] = kNegInit;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  }
  __syncthreads();

  const size_t c_stride = (size_t)G * M;    // codes: one position
  const size_t v_stride = (size_t)G * Dv;   // values: one position
  const CT* c_base = codes + (size_t)b * S * c_stride + (size_t)g * M;
  const VT* v_base = v + (size_t)b * S * v_stride + (size_t)g * Dv + 4 * cg;

  for (int t0 = 0; t0 < valid_len; t0 += kThreads) {
    // 2. scores of this thread's position for the R heads
    const int s = t0 + tid;
    const bool live = s < valid_len;
    float sc[kMaxR];
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) sc[r] = 0.f;
    if (live) {
      const CT* c = c_base + (size_t)s * c_stride;
      for (int mm = 0; mm < M; ++mm) {
        const unsigned code = static_cast<unsigned>(c[mm]);
        const TT* e = lut + mm * K + (code < (unsigned)K ? code : K - 1);
#pragma unroll
        for (int r = 0; r < kMaxR; ++r)
          if (r < R) sc[r] += to_f(e[(size_t)r * M * K]);
      }
    }
    // 3. tile max per head, then the running max, weights and sums
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      if (r < R) {
        sc[r] = live ? sc[r] * scale : kNegInit;
        float mx = sc[r];
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        if (lane == 0) red_max[r * kWarps + warp] = mx;
      }
    }
    __syncthreads();
    float corr[kMaxR];
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      corr[r] = 1.f;
      if (r < R) {
        float mx = red_max[r * kWarps];
        for (int w = 1; w < kWarps; ++w)
          mx = fmaxf(mx, red_max[r * kWarps + w]);
        const float m_new = fmaxf(m_run[r], mx);
        corr[r] = expf(m_run[r] - m_new);
        m_run[r] = m_new;
        const float p = live ? expf(sc[r] - m_new) : 0.f;
        p_s[r * kThreads + tid] = p;
        float sum = p;
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) red_sum[r * kWarps + warp] = sum;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      if (r < R) {
        float sum = 0.f;
        for (int w = 0; w < kWarps; ++w) sum += red_sum[r * kWarps + w];
        l_run[r] = l_run[r] * corr[r] + sum;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] *= corr[r];
      }
    }
    // 4. this thread's 4 columns over its position lane of the tile
    if (pl < n_pl) {
      const int n_live = min(kThreads, valid_len - t0);
#pragma unroll 4
      for (int j = pl; j < n_live; j += n_pl) {
        float vv[4];
        load4(v_base + (size_t)(t0 + j) * v_stride, vv);
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) {
          if (r < R) {
            const float p = p_s[r * kThreads + j];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] += p * vv[c];
          }
        }
      }
    }
    __syncthreads();  // p_s and red_* are rewritten by the next tile
  }

  // 5. add the position lanes' partial sums, normalise, write
  if (pl < n_pl) {
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      if (r < R) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          part[((size_t)pl * R + r) * Dv + 4 * cg + c] = acc[r][c];
      }
    }
  }
  __syncthreads();
  const size_t head0 = ((size_t)b * G + g) * R;
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    if (r < R) {
      const float denom = fmaxf(l_run[r], 1e-30f);
      for (int d = tid; d < Dv; d += kThreads) {
        float a = 0.f;
        for (int q = 0; q < n_pl; ++q) a += part[((size_t)q * R + r) * Dv + d];
        out[(head0 + r) * Dv + d] = a / denom;
      }
      if (tid == 0) {
        m_out[head0 + r] = m_run[r];
        l_out[head0 + r] = l_run[r];
      }
    }
  }
}

template <typename TT, typename CT, typename VT>
int launch(const void* qlut, const void* codes, const void* v, float* out,
           float* m, float* l, int B, int S, int G, int R, int M, int K,
           int Dv, int valid_len, float scale, size_t smem,
           cudaStream_t stream) {
  auto kernel = pq_attn_kernel<TT, CT, VT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<B * G, kThreads, smem, stream>>>(
      static_cast<const TT*>(qlut), static_cast<const CT*>(codes),
      static_cast<const VT*>(v), out, m, l, S, G, R, M, K, Dv, valid_len,
      scale);
  return (int)cudaGetLastError();
}

template <typename TT, typename CT>
int by_values(int values_bf16, const void* qlut, const void* codes,
              const void* v, float* out, float* m, float* l, int B, int S,
              int G, int R, int M, int K, int Dv, int valid_len, float scale,
              size_t smem, cudaStream_t stream) {
  return values_bf16
             ? launch<TT, CT, __nv_bfloat16>(qlut, codes, v, out, m, l, B, S,
                                             G, R, M, K, Dv, valid_len,
                                             scale, smem, stream)
             : launch<TT, CT, float>(qlut, codes, v, out, m, l, B, S, G, R,
                                     M, K, Dv, valid_len, scale, smem,
                                     stream);
}

template <typename TT>
int by_codes(int codes_u8, int values_bf16, const void* qlut,
             const void* codes, const void* v, float* out, float* m,
             float* l, int B, int S, int G, int R, int M, int K, int Dv,
             int valid_len, float scale, size_t smem, cudaStream_t stream) {
  return codes_u8
             ? by_values<TT, uint8_t>(values_bf16, qlut, codes, v, out, m, l,
                                      B, S, G, R, M, K, Dv, valid_len, scale,
                                      smem, stream)
             : by_values<TT, int32_t>(values_bf16, qlut, codes, v, out, m, l,
                                      B, S, G, R, M, K, Dv, valid_len, scale,
                                      smem, stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA, in bytes (the wrapper checks it
// against the card's 227 KB before launching).
size_t pq_attn_smem_bytes(int R, int M, int K, int Dv, int table_bf16) {
  const int n_pl = kThreads / (Dv / 4);
  return sizeof(float) * ((size_t)R * (kThreads + 2 * kWarps) +
                          (size_t)n_pl * R * Dv) +
         (size_t)R * M * K * (table_bf16 ? 2 : 4);
}

int pq_attn(const void* qlut, const void* codes, const void* v, float* out,
            float* m, float* l, int B, int S, int G, int R, int M, int K,
            int Dv, int valid_len, float scale, int table_bf16, int codes_u8,
            int values_bf16, void* stream) {
  if (R < 1 || R > kMaxR || Dv < 4 || Dv % 4 != 0 || Dv / 4 > kThreads ||
      valid_len < 0 || valid_len > S)
    return (int)cudaErrorInvalidValue;
  const size_t smem = pq_attn_smem_bytes(R, M, K, Dv, table_bf16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return table_bf16
             ? by_codes<__nv_bfloat16>(codes_u8, values_bf16, qlut, codes, v,
                                       out, m, l, B, S, G, R, M, K, Dv,
                                       valid_len, scale, smem, s)
             : by_codes<float>(codes_u8, values_bf16, qlut, codes, v, out, m,
                               l, B, S, G, R, M, K, Dv, valid_len, scale,
                               smem, s);
}

}  // extern "C"
