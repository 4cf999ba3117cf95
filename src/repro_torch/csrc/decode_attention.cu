// Decode attention over a dense KV cache for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention, body _kernel).
//
// What it computes: one query token per sequence, q [B, H, d], attends over
// the first lengths[b] rows of its sequence's dense cache; rows at or past
// the length are masked.  The G = H / KV query heads of one KV head share
// one pass over its rows.  Softmax is online, in fp32, normalised at the
// end; the output is written in q's dtype.
//
// What bounds it on the H100: bytes.  Each K/V row is read once and used
// for G dot products (G = 3 for smollm-135m, 4 for llama3-8b, 8 for
// gemma-2b), far below the ~295 operations per byte where the tensor cores
// would become the limit, so the least time is the K/V bytes the lengths
// select over 3.35 TB/s.
//
// What this design does about it: k and v arrive as strided views of the
// model's [B, T, KV, d] layer cache (only the head dim must be contiguous),
// so the cache is read in its storage layout and nothing is transposed per
// step (the JAX caller transposes the whole cache to [B, KV, T, d] first).
// The structure is that of paged_decode_attention.cu without the page
// steering: one block per (b, KV head) holds the G query rows in registers;
// its 8 warps take chunks of rows in turn (8 rows at d <= 64, 4 at
// d <= 128, 2 at d <= 256), and a warp issues the loads of a whole chunk
// before it computes with any of them; a warp reads a row with 32
// consecutive lanes (coalesced).  Each warp keeps its own online-softmax
// state, updated once per chunk, and the warps' states are merged through
// shared memory at the end.  Rows past the length are never read.
// B * KV blocks fill only part of the card's 132 SMs at small batch:
// splitting the sequence across blocks (split-KV) and tensor cores are
// later work.
//
// Facts carried over from the TPU kernel: the mask value is the finite
// float32 minimum; the normaliser is clamped at 1e-30, so a sequence of
// length 0 gives zeros; element offsets are 64-bit.

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxG = 8;

struct CacheStrides {   // element strides of the (batch, row, KV head) axes
  int64_t b, t, h;
};

// Lane l of a warp owns head-dim elements l, l + 32, ...  VEC = ceil(d / 32),
// and every per-lane loop masks e < d, so a width that is not a multiple of
// 32 works too: d = 80 (zamba2-2.7b's shared attention) takes VEC = 4 and
// lanes 16-31 hold nothing in their third and fourth elements.
template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int32_t* __restrict__ lengths,
              T* __restrict__ out, int H, int KV, int G, int d, int T_len,
              CacheStrides ks, CacheStrides vs, float scale) {
  constexpr int R = ChunkRows<VEC>::value;
  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x % KV;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float qr[kMaxG][VEC];
  float m[kMaxG], l[kMaxG], acc[kMaxG][VEC];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kMaskValue;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int e = lane + 32 * i;
      acc[g][i] = 0.f;
      qr[g][i] = (g < G && e < d)
          ? to_f32(q[(static_cast<int64_t>(b) * H + kvh * G + g) * d + e]) : 0.f;
    }
  }

  const int n = min(lengths[b], T_len);
  const T* kb = k + static_cast<int64_t>(b) * ks.b + static_cast<int64_t>(kvh) * ks.h;
  const T* vb = v + static_cast<int64_t>(b) * vs.b + static_cast<int64_t>(kvh) * vs.h;
  // chunk c covers rows c * R .. c * R + R - 1; warps take chunks in turn
  for (int r0 = warp * R; r0 < n; r0 += kWarps * R) {
    bool live[R];
    float kx[R][VEC], vx[R][VEC];
#pragma unroll
    for (int r = 0; r < R; ++r) {                    // all loads first
      live[r] = r0 + r < n;
      const int64_t t = r0 + r;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int e = lane + 32 * i;
        const bool in = live[r] && e < d;
        kx[r][i] = in ? to_f32(kb[t * ks.t + e]) : 0.f;
        vx[r][i] = in ? to_f32(vb[t * vs.t + e]) : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float s[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) part += qr[g][i] * kx[r][i];
        s[r] = part;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = warp_sum(s[r]) * scale;
      float m_new = m[g];
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (live[r]) m_new = fmaxf(m_new, s[r]);
      const float alpha = expf(m[g] - m_new);
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!live[r]) continue;
        const float p = expf(s[r] - m_new);
        l[g] += p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] += p * vx[r][i];
      }
      m[g] = m_new;
    }
  }

  // merge the warps' online-softmax states, one query head at a time
  __shared__ float sm_m[kWarps][kMaxG];
  __shared__ float sm_l[kWarps][kMaxG];
  __shared__ float sm_acc[kWarps][VEC * 32];
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;                               // G is block-uniform
#pragma unroll
    for (int i = 0; i < VEC; ++i) sm_acc[warp][lane + 32 * i] = acc[g][i];
    __syncthreads();
    for (int e = threadIdx.x; e < d; e += blockDim.x) {
      float mx = kMaskValue;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
      float lsum = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = expf(sm_m[w][g] - mx);
        lsum += sm_l[w][g] * c;
        a += sm_acc[w][e] * c;
      }
      out[(static_cast<int64_t>(b) * H + kvh * G + g) * d + e] =
          from_f32<T>(a / fmaxf(lsum, 1e-30f));
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const void* lens, void* out, int B, int H, int KV,
                         int d, int T_len, CacheStrides ks, CacheStrides vs,
                         cudaStream_t stream) {
  const int G = H / KV;
  const float scale = 1.f / sqrtf(static_cast<float>(d));
  const dim3 grid(B * KV), block(kWarps * 32);
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  const auto* lp = static_cast<const int32_t*>(lens);
  auto* op = static_cast<T*>(out);
#define REPRO_DECODE_LAUNCH(VEC)                                                 \
  decode_kernel<T, VEC><<<grid, block, 0, stream>>>(qp, kp, vp, lp, op, H, KV, G, \
                                                    d, T_len, ks, vs, scale)
  if (d <= 64) REPRO_DECODE_LAUNCH(2);
  else if (d <= 128) REPRO_DECODE_LAUNCH(4);
  else REPRO_DECODE_LAUNCH(8);
#undef REPRO_DECODE_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  k and v strides are in elements
// over the (batch, row, KV head) axes of the caller's cache view; the head
// dim is contiguous.  Returns the launch's cudaError_t (0 on success).
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths, void* out,
    int B, int H, int KV, int d, int T_len, int64_t k_sb, int64_t k_st,
    int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh, int dtype,
    void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || H / KV > kMaxG || d < 1 || d > 256 ||
      T_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const CacheStrides ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  if (dtype == 0)
    return static_cast<int>(
        launch_typed<float>(q, k, v, lengths, out, B, H, KV, d, T_len, ks, vs, s));
  if (dtype == 1)
    return static_cast<int>(launch_typed<__nv_bfloat16>(q, k, v, lengths, out, B, H,
                                                         KV, d, T_len, ks, vs, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
