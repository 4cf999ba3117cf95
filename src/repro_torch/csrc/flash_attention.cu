// Causal flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _kernel).
//
// What it computes: q [B, H, S, d] attends over k, v [B, KV, T, d] with
// GQA (query head h reads KV head h / (H / KV)), an optional tanh softcap
// on the scaled scores, and a causal mask aligned bottom-right,
// col <= row + (T - S), so one kernel serves a whole-prompt prefill
// (T == S) and a suffix prefill over a reused prefix (T > S).  Softmax and
// both products accumulate in fp32; the output is written in q's dtype.
//
// What bounds it on the H100: at serving prompt lengths (S, T of a few
// hundred, d = 64..128) the work is about 2 * S * T * d * H multiply-adds
// against S * d + 2 * T * d elements per head, so operations bound it once
// S reaches a few hundred; at short suffixes it is bound by bytes.  This
// first version runs its products on the CUDA cores in fp32 (no wgmma), so
// it is far from the tensor-core bound; its times sit beside that bound in
// PERF.md.
//
// What this design does about it: one block per (b, h, 16-row query tile)
// keeps the query tile and a 32-key K/V tile in shared memory (fp32), so
// each K/V element read from memory serves 16 query rows.  Each warp owns 4
// query rows; for a row, lane j scores key j of the tile, the warp takes
// max and sum with shuffles, and each lane accumulates its own head-dim
// elements of P @ V.  The head dim is a compile-time constant (16, 32, 64,
// 80, 128 or 256; 80 is zamba2-2.7b's shared attention, whose rows lanes
// 0-15 finish in a third pass), so the score loop unrolls into float4 shared-memory loads
// (K rows padded by four words: the 8 lanes of a quarter-warp hit
// different banks) feeding four independent partial sums.  Key tiles
// wholly above the diagonal are never loaded; the diagonal and the ragged
// ends of S and T are masked element by element, so any S and T work with
// no change of tile size.  Reading strides from the caller lets q and k/v
// arrive as views of the model's [B, S, H, d] activations and [B, T, KV, d]
// cache: nothing is transposed per call.

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;   // query rows per block
constexpr int kBK = 32;                      // keys per tile (one per lane)

struct Strides {   // element strides of the (batch, head, sequence) axes
  int64_t b, h, s;
};

// Lane l owns head-dim elements l, l + 32, ... of its rows' accumulators.
template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int H, int KV, int S,
             int T_len, Strides qs, Strides ks, Strides vs, Strides os,
             float scale, float softcap, int causal) {
  constexpr int VEC = (D + 31) / 32;         // head-dim elements per lane
  constexpr int KROW = D + 4;                // padded K row (float4-aligned)
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                         // [kBQ][D]
  float* k_s = q_s + kBQ * D;                // [kBK][D + 4]
  float* v_s = k_s + kBK * KROW;             // [kBK][D]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int offset = T_len - S;              // bottom-right causal alignment

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  for (int idx = threadIdx.x; idx < kBQ * D; idx += blockDim.x) {
    const int r = idx / D, e = idx % D;
    q_s[idx] = q0 + r < S ? to_f32(qb[(q0 + r) * qs.s + e]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][VEC];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kMaskValue;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[rr][i] = 0.f;
  }

  const int last_row = min(q0 + kBQ, S) - 1;
  const int kv_end = causal ? min(T_len, last_row + offset + 1) : T_len;
  for (int kt = 0; kt < kv_end; kt += kBK) {
    __syncthreads();                         // previous tile fully consumed
    for (int idx = threadIdx.x; idx < kBK * D; idx += blockDim.x) {
      const int j = idx / D, e = idx % D;
      const bool in = kt + j < T_len;
      k_s[j * KROW + e] = in ? to_f32(kb[(kt + j) * ks.s + e]) : 0.f;
      v_s[j * D + e] = in ? to_f32(vb[(kt + j) * vs.s + e]) : 0.f;
    }
    __syncthreads();
    const int col = kt + lane;
    const float4* k4 = reinterpret_cast<const float4*>(k_s + lane * KROW);
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int row = q0 + r;
      if (row >= S) break;                   // uniform across the warp
      const bool valid = col < T_len && (!causal || col <= row + offset);
      float s = kMaskValue;
      if (valid) {
        const float4* q4 = reinterpret_cast<const float4*>(q_s + r * D);
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
        for (int e = 0; e < D / 4; ++e) {
          const float4 qa = q4[e], ka = k4[e];
          a0 += qa.x * ka.x;
          a1 += qa.y * ka.y;
          a2 += qa.z * ka.z;
          a3 += qa.w * ka.w;
        }
        s = ((a0 + a1) + (a2 + a3)) * scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      }
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float alpha = expf(m[rr] - m_new);
      const float p = valid ? expf(s - m_new) : 0.f;
      l[rr] = l[rr] * alpha + warp_sum(p);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[rr][i] *= alpha;
#pragma unroll
      for (int j = 0; j < kBK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int e = lane + 32 * i;
          if (e < D) acc[rr][i] += pj * v_s[j * D + e];
        }
      }
      m[rr] = m_new;
    }
  }

  T* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + warp * kRowsPerWarp + rr;
    if (row >= S) break;
    const float inv = 1.f / fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int e = lane + 32 * i;
      if (e < D) ob[row * os.s + e] = from_f32<T>(acc[rr][i] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dim(const void* q, const void* k, const void* v, void* out,
                       int B, int H, int KV, int S, int T_len, Strides qs,
                       Strides ks, Strides vs, Strides os, float softcap,
                       int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kBQ * D + kBK * (D + 4) + kBK * D);
  auto kernel = flash_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B), block(kWarps * 32);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, KV, S, T_len, qs, ks, vs, os, scale, softcap, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* out,
                         int B, int H, int KV, int S, int T_len, int d, Strides qs,
                         Strides ks, Strides vs, Strides os, float softcap,
                         int causal, cudaStream_t stream) {
  switch (d) {
#define REPRO_FLASH_DIM(D)                                                        \
  case D:                                                                         \
    return launch_dim<T, D>(q, k, v, out, B, H, KV, S, T_len, qs, ks, vs, os,     \
                            softcap, causal, stream);
    REPRO_FLASH_DIM(16)
    REPRO_FLASH_DIM(32)
    REPRO_FLASH_DIM(64)
    REPRO_FLASH_DIM(80)
    REPRO_FLASH_DIM(128)
    REPRO_FLASH_DIM(256)
#undef REPRO_FLASH_DIM
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// Strides are in elements; the head-dim axis must be contiguous.
// d is 16, 32, 64, 80, 128 or 256.
// Returns the launch's cudaError_t (0 on success).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int KV, int S, int T_len, int d, int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
    int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss, float softcap,
    int causal, int dtype, void* stream) {
  if (B < 1 || S < 1 || T_len < 1 || KV < 1 || H % KV != 0 ||
      (causal && T_len < S) || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = launch_typed<float>(q, k, v, out, B, H, KV, S, T_len, d, qs, ks, vs, os,
                              softcap, causal, s);
  else if (dtype == 1)
    err = launch_typed<__nv_bfloat16>(q, k, v, out, B, H, KV, S, T_len, d, qs, ks, vs,
                                      os, softcap, causal, s);
  return static_cast<int>(err);
}
