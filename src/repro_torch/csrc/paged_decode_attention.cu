// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_decode_attention.py
// (paged_decode_attention, bodies _kernel / _dequant_kernel / _accumulate).
//
// What it computes: one query token per sequence attends over a block-paged
// KV arena.  page_table[b, t] names the physical page of logical block t of
// sequence b; positions >= lengths[b] are masked.  The G = H / KV query
// heads of one KV head share one pass over its rows.  Softmax is online, in
// fp32, normalised at the end.  The int8 variant dequantizes each row with
// its fp32 scale on chip (row * scale), so fp K/V never exists in memory.
//
// What bounds it on the H100: bytes.  Each K/V row is read once and used
// for G <= 8 dot products, far below the ~295 operations per byte where the
// tensor cores would become the limit, so the least time is the K/V bytes
// the lengths select over 3.35 TB/s.
//
// What this design does about it: it reads the arena in its storage layout
// [P, ps, KV, d] (and scales in [P, ps, KV]) straight from the pages, with
// no per-call transpose or gather of the arena; each row is read once per
// (sequence, KV head) and feeds all G query heads; a warp reads a row with
// 32 consecutive lanes (coalesced).  One block per (b, kv_head) holds the G
// query rows in registers.  Its 8 warps take chunks of a page's rows in
// turn (8 rows at d <= 64, fewer at wider heads), and a warp issues the
// loads of a whole chunk before it computes with any of them, so several
// rows are in flight per warp instead of one dependent load after another.
// Each warp keeps its own online-softmax state, updated once per chunk,
// and the warps' states are merged through shared memory at the end.
// B * KV blocks fill only part of the card's 132 SMs at small batch:
// splitting the KV sequence across blocks is later work.
//
// Facts carried over from the TPU kernel: the mask value is the finite
// float32 minimum, so exp(m_prev - m_new) never produces NaN; the
// normaliser is clamped at 1e-30; rows of free slots point at the null
// page 0, which is read like any other page; element offsets are 64-bit.

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxG = 8;

// Lane l of a warp owns head-dim elements l, l + 32, ..., so a row is read
// with 32 consecutive lanes per step.  VEC = ceil(d / 32).
template <typename TQ, typename TKV, int VEC, bool QUANT>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int32_t* __restrict__ page_table,
                    const int32_t* __restrict__ lengths, TQ* __restrict__ out,
                    int H, int KV, int G, int d, int ps, int NB, float scale) {
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

  const int len = lengths[b];
  const int nblocks = min((len + ps - 1) / ps, NB);
  const int chunks_per_page = (ps + R - 1) / R;
  // work item = (logical block t, chunk of R rows); warps take them in turn
  for (int w = warp; w < nblocks * chunks_per_page; w += kWarps) {
    const int t = w / chunks_per_page;
    const int r0 = (w - t * chunks_per_page) * R;
    const int64_t page = page_table[static_cast<int64_t>(b) * NB + t];
    bool live[R];
    float kx[R][VEC], vx[R][VEC];
#pragma unroll
    for (int r = 0; r < R; ++r) {                    // all loads first
      live[r] = r0 + r < ps && t * ps + r0 + r < len;   // tail-block mask
      const int64_t row = (page * ps + r0 + r) * KV + kvh;
      const float ks = (QUANT && live[r]) ? k_scales[row] : 1.f;
      const float vs = (QUANT && live[r]) ? v_scales[row] : 1.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int e = lane + 32 * i;
        const bool in = live[r] && e < d;
        kx[r][i] = in ? to_f32(k[row * d + e]) * ks : 0.f;
        vx[r][i] = in ? to_f32(v[row * d + e]) * vs : 0.f;
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
          from_f32<TQ>(a / fmaxf(lsum, 1e-30f));
    }
    __syncthreads();
  }
}

template <typename TQ, typename TKV, bool QUANT>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const void* ks, const void* vs, const void* pt,
                         const void* lens, void* out, int B, int H, int KV,
                         int d, int ps, int NB, cudaStream_t stream) {
  const int G = H / KV;
  const float scale = 1.f / sqrtf(static_cast<float>(d));
  const dim3 grid(B * KV), block(kWarps * 32);
  const auto* qp = static_cast<const TQ*>(q);
  const auto* kp = static_cast<const TKV*>(k);
  const auto* vp = static_cast<const TKV*>(v);
  const auto* ksp = static_cast<const float*>(ks);
  const auto* vsp = static_cast<const float*>(vs);
  const auto* ptp = static_cast<const int32_t*>(pt);
  const auto* lp = static_cast<const int32_t*>(lens);
  auto* op = static_cast<TQ*>(out);
#define REPRO_PAGED_LAUNCH(VEC)                                                  \
  paged_decode_kernel<TQ, TKV, VEC, QUANT><<<grid, block, 0, stream>>>(          \
      qp, kp, vp, ksp, vsp, ptp, lp, op, H, KV, G, d, ps, NB, scale)
  if (d <= 32) REPRO_PAGED_LAUNCH(1);
  else if (d <= 64) REPRO_PAGED_LAUNCH(2);
  else if (d <= 128) REPRO_PAGED_LAUNCH(4);
  else REPRO_PAGED_LAUNCH(8);
#undef REPRO_PAGED_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (arena only).
// Returns the launch's cudaError_t (0 on success).
extern "C" int repro_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* page_table,
    const void* lengths, void* out, int B, int H, int KV, int d, int ps,
    int NB, int q_dtype, int kv_dtype, void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || H / KV > kMaxG || d < 1 || d > 256 ||
      ps < 1 || NB < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0)
    err = launch_typed<float, float, false>(q, k_pages, v_pages, k_scales, v_scales,
                                            page_table, lengths, out, B, H, KV, d, ps, NB, s);
  else if (q_dtype == 1 && kv_dtype == 1)
    err = launch_typed<__nv_bfloat16, __nv_bfloat16, false>(
        q, k_pages, v_pages, k_scales, v_scales, page_table, lengths, out, B, H, KV, d,
        ps, NB, s);
  else if (q_dtype == 0 && kv_dtype == 2)
    err = launch_typed<float, int8_t, true>(q, k_pages, v_pages, k_scales, v_scales,
                                            page_table, lengths, out, B, H, KV, d, ps, NB, s);
  else if (q_dtype == 1 && kv_dtype == 2)
    err = launch_typed<__nv_bfloat16, int8_t, true>(
        q, k_pages, v_pages, k_scales, v_scales, page_table, lengths, out, B, H, KV, d,
        ps, NB, s);
  return static_cast<int>(err);
}
