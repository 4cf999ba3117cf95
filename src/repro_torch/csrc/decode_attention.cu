// Decode attention over a dense KV cache for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention, body _kernel).
//
// What it computes: one query token per sequence, q [B, H, d], attends over
// the first lengths[b] rows of its sequence's dense cache; rows at or past
// the length are masked, and a sequence of length 0 gives zeros.  The
// G = H / KV query heads of one KV head share one pass over its rows.
// Softmax is online, in fp32, normalised at the end; the output is written
// in q's dtype.
//
// What bounds it on the H100: bytes.  Each K/V row is read once and used
// for G dot products (G = 3 for smollm-135m, 4 for llama3-8b, 8 for
// gemma-2b): about G * 2 operations per byte, far below the ~295 per byte
// at which the tensor cores would matter, so no tensor cores here (an
// m16n8k16 tile would also be at least half empty with G <= 8 rows).  The
// least time is the K/V bytes the lengths select over 3.35 TB/s; at serving
// sizes that is under a microsecond, so what the kernel can win is latency:
// many blocks in flight, each issuing all its loads at once.
//
// What this design does about it (split-KV, two launches per call; the
// wrapper counts the call once):
//   1. The grid is (B * KV, n_splits): each block takes one span of
//      split_rows(d) cache rows (64 at d <= 128, 32 at d = 256) of one
//      (b, KV head), n_splits = ceil(T / split_rows(d)) over the cache's
//      allocated length T.  The span is fixed per head dim, never chosen
//      from B, KV or the lengths, and the lengths are never read on the
//      host, so a sequence's output does not depend on the batch it decodes
//      in.  A block whose span starts at or past its sequence's length
//      writes an empty partial (m = mask value, l = 0) and exits.
//      Every lane loads 16 bytes at a time (8 bf16 or 4 fp32): a row is
//      read by a group of d * size / 16 lanes, rounded up to 8, 16 or 32
//      (8 lanes at d = 64 bf16, 16 at 128, 32 at 256; at d = 80 bf16, 10
//      lanes of 16 bytes in a group of 16, six idle), so one warp load
//      instruction reads several rows, each coalesced.  A group issues the
//      loads of all its rows of a round before it computes with any of
//      them, reduces each dot product within the group by shuffles, and
//      keeps its own online-softmax state per query head.  The groups'
//      states are merged through shared memory in a fixed order into the
//      block's partial (m, l and an un-normalised fp32 [G, d] accumulator)
//      in a scratch the wrapper allocates.
//   2. One block per (b, KV head, query head, 32 head-dim elements)
//      merges the partials in a fixed order (its warps take every 16th
//      split, lanes the elements), skipping empty ones, and normalises
//      (l clamped at 1e-30).
// No atomics: a repeated call is bit-identical.  k and v arrive as strided
// views of the model's [B, T, KV, d] layer cache (only the head dim must be
// contiguous, rows 16-byte aligned), so the cache is read in its storage
// layout and nothing is transposed per step.
//
// Facts carried over from the TPU kernel: the mask value is the finite
// float32 minimum; the normaliser is clamped at 1e-30, so a sequence of
// length 0 gives zeros; element offsets are 64-bit.

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxG = 8;

struct CacheStrides {   // element strides of the (batch, row, KV head) axes
  int64_t b, t, h;
};

// Cache rows per split; kernels/decode_attention.py:split_rows mirrors it.
constexpr int split_rows(int d) { return d <= 128 ? 64 : 32; }

template <typename T, int D, int GMAX>
struct DecodeCfg {
  static constexpr int VEC = 16 / sizeof(T);       // elements per 16-byte load
  static constexpr int CHUNKS = D / VEC;           // 16-byte chunks per row
  static constexpr int LANES = CHUNKS <= 8 ? 8 : (CHUNKS <= 16 ? 16 : 32);
  static constexpr int PASSES = (CHUNKS + 31) / 32;   // loads per lane per row
  static constexpr int E = VEC * PASSES;           // elements per lane per row
  static constexpr int GROUPS = kWarps * 32 / LANES;
  static constexpr int SPLIT = split_rows(D);
  // rows a group loads before it computes: fewer when q and the
  // accumulators already take many registers
  static constexpr int R_REG = GMAX * E <= 32 ? 8 : 4;
  static constexpr int R = R_REG < SPLIT / GROUPS ? R_REG : SPLIT / GROUPS;
  static constexpr int ROUNDS = SPLIT / (GROUPS * R);
};

template <typename T, int D, int GMAX>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int32_t* __restrict__ lengths,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int H, int KV, int G, int T_len, CacheStrides ks,
                    CacheStrides vs, float scale) {
  using C = DecodeCfg<T, D, GMAX>;
  constexpr int VEC = C::VEC, E = C::E, LANES = C::LANES, R = C::R;
  const int bh = blockIdx.x;
  const int b = bh / KV, kvh = bh % KV;
  const int split = blockIdx.y;
  const int64_t part = static_cast<int64_t>(bh) * gridDim.y + split;
  float* ml = part_ml + part * G * 2;
  const int n = max(0, min(lengths[b], T_len));
  const int r_begin = split * C::SPLIT;
  if (r_begin >= n) {                                // empty partial
    if (threadIdx.x < G) {
      ml[2 * threadIdx.x] = kMaskValue;
      ml[2 * threadIdx.x + 1] = 0.f;
    }
    return;
  }
  const int r_end = min(r_begin + C::SPLIT, n);
  const int lane = threadIdx.x & 31;
  const int li = lane % LANES;                       // lane within the group
  const int grp = threadIdx.x / LANES;

  float qr[GMAX][E], m[GMAX], l[GMAX], acc[GMAX][E];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kMaskValue;
    l[g] = 0.f;
#pragma unroll
    for (int p = 0; p < C::PASSES; ++p) {
      const int c = li + 32 * p;
      const bool in = g < G && c < C::CHUNKS;
      const uint4 raw = in ? *reinterpret_cast<const uint4*>(
          q + (static_cast<int64_t>(b) * H + kvh * G + g) * D + c * VEC) : make_uint4(0, 0, 0, 0);
      unpack16<T>(raw, &qr[g][p * VEC]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][p * VEC + i] = 0.f;
    }
  }

  const T* kb = k + static_cast<int64_t>(b) * ks.b + static_cast<int64_t>(kvh) * ks.h;
  const T* vb = v + static_cast<int64_t>(b) * vs.b + static_cast<int64_t>(kvh) * vs.h;
#pragma unroll 1
  for (int round = 0; round < C::ROUNDS; ++round) {
    const int base = r_begin + round * C::GROUPS * R;
    if (base >= r_end) break;                        // block-uniform
    bool live[R];
    uint4 kx[R][C::PASSES], vx[R][C::PASSES];
#pragma unroll
    for (int r = 0; r < R; ++r) {                    // all loads first
      const int64_t row = base + r * C::GROUPS + grp;
      live[r] = row < r_end;
#pragma unroll
      for (int p = 0; p < C::PASSES; ++p) {
        const int c = li + 32 * p;
        const bool in = live[r] && c < C::CHUNKS;
        kx[r][p] = in ? load16(kb + row * ks.t + c * VEC) : make_uint4(0, 0, 0, 0);
        vx[r][p] = in ? load16(vb + row * vs.t + c * VEC) : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) break;
      float s[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float part_s = 0.f;
#pragma unroll
        for (int p = 0; p < C::PASSES; ++p) {
          float kf[VEC];
          unpack16<T>(kx[r][p], kf);
#pragma unroll
          for (int i = 0; i < VEC; ++i) part_s += qr[g][p * VEC + i] * kf[i];
        }
        s[r] = part_s;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int o = LANES / 2; o > 0; o >>= 1)
          s[r] += __shfl_xor_sync(0xffffffffu, s[r], o);
        s[r] *= scale;
      }
      float m_new = m[g];
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (live[r]) m_new = fmaxf(m_new, s[r]);
      const float alpha = expf(m[g] - m_new);
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < E; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!live[r]) continue;
        const float pr = expf(s[r] - m_new);
        l[g] += pr;
#pragma unroll
        for (int p = 0; p < C::PASSES; ++p) {
          float vf[VEC];
          unpack16<T>(vx[r][p], vf);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[g][p * VEC + i] += pr * vf[i];
        }
      }
      m[g] = m_new;
    }
  }

  // merge the groups' states into the block's partial, in group order
  __shared__ float sm_m[C::GROUPS][GMAX];
  __shared__ float sm_l[C::GROUPS][GMAX];
  __shared__ float sm_acc[C::GROUPS][GMAX][D];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (li == 0) {
      sm_m[grp][g] = m[g];
      sm_l[grp][g] = l[g];
    }
#pragma unroll
    for (int p = 0; p < C::PASSES; ++p) {
      const int c = li + 32 * p;
      if (c < C::CHUNKS) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) sm_acc[grp][g][c * VEC + i] = acc[g][p * VEC + i];
      }
    }
  }
  __syncthreads();
  float* pacc = part_acc + part * G * D;
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, e = idx % D;
    float mx = kMaskValue;
#pragma unroll
    for (int w = 0; w < C::GROUPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < C::GROUPS; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * c;
      a += sm_acc[w][g][e] * c;
    }
    pacc[idx] = a;
    if (e == 0) {
      ml[2 * g] = mx;
      ml[2 * g + 1] = lsum;
    }
  }
}

constexpr int kMergeSlices = 16;   // warps of a merge block at most

// One block per (b, KV head, query head, 32 head-dim elements): the
// partials merged in a fixed order.  Warp 0 finds the largest m of the live
// splits and the normaliser; then lane e of warp w sums element e of every
// w-th split, and warp 0 adds the warps' sums in warp order.  The number of
// warps, min(16, n_splits), depends on T alone.  Empty partials (l = 0) add
// nothing and their accumulators are never used.
template <typename T>
__global__ void __launch_bounds__(kMergeSlices * 32)
decode_merge_kernel(const float* __restrict__ part_acc,
                    const float* __restrict__ part_ml, T* __restrict__ out, int H,
                    int KV, int d, int n_splits) {
  __shared__ float sm_part[kMergeSlices][32];
  __shared__ float sm_max, sm_l;
  const int bh = blockIdx.x, g = blockIdx.y, G = gridDim.y;
  const int b = bh / KV, kvh = bh % KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slices = blockDim.x >> 5;
  const int e = blockIdx.z * 32 + lane;
  const float2* ml = reinterpret_cast<const float2*>(part_ml) +
                     static_cast<int64_t>(bh) * n_splits * G + g;   // stride G
  const float* pacc = part_acc + (static_cast<int64_t>(bh) * n_splits * G + g) * d;
  if (warp == 0) {
    float mx = kMaskValue;
    for (int s = lane; s < n_splits; s += 32) {
      const float2 x = ml[s * G];
      if (x.y > 0.f) mx = fmaxf(mx, x.x);
    }
    mx = warp_max(mx);
    float lsum = 0.f;
    for (int s = lane; s < n_splits; s += 32) {
      const float2 x = ml[s * G];
      if (x.y > 0.f) lsum += x.y * expf(x.x - mx);
    }
    lsum = warp_sum(lsum);
    if (lane == 0) {
      sm_max = mx;
      sm_l = lsum;
    }
  }
  __syncthreads();
  const float mx = sm_max;
  float a = 0.f;
  if (e < d) {
#pragma unroll 4
    for (int s = warp; s < n_splits; s += slices) {
      const float2 x = ml[s * G];
      const float v = pacc[static_cast<int64_t>(s) * G * d + e];
      a += x.y > 0.f ? v * expf(x.x - mx) : 0.f;
    }
  }
  sm_part[warp][lane] = a;
  __syncthreads();
  if (warp == 0 && e < d) {
    for (int w = 1; w < slices; ++w) a += sm_part[w][lane];
    out[(static_cast<int64_t>(b) * H + kvh * G + g) * d + e] =
        from_f32<T>(a / fmaxf(sm_l, 1e-30f));
  }
}

template <typename T, int D, int GMAX>
cudaError_t launch_split(const T* q, const T* k, const T* v, const int32_t* lens,
                         float* part_acc, float* part_ml, int B, int H, int KV,
                         int T_len, int n_splits, CacheStrides ks, CacheStrides vs,
                         cudaStream_t stream) {
  const dim3 grid(B * KV, n_splits), block(kWarps * 32);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  decode_split_kernel<T, D, GMAX><<<grid, block, 0, stream>>>(
      q, k, v, lens, part_acc, part_ml, H, KV, H / KV, T_len, ks, vs, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dim(const T* q, const T* k, const T* v, const int32_t* lens,
                       float* part_acc, float* part_ml, int B, int H, int KV,
                       int T_len, int n_splits, CacheStrides ks, CacheStrides vs,
                       cudaStream_t stream) {
  const int G = H / KV;
  if (G == 1)
    return launch_split<T, D, 1>(q, k, v, lens, part_acc, part_ml, B, H, KV, T_len,
                                 n_splits, ks, vs, stream);
  if (G <= 4)
    return launch_split<T, D, 4>(q, k, v, lens, part_acc, part_ml, B, H, KV, T_len,
                                 n_splits, ks, vs, stream);
  return launch_split<T, D, 8>(q, k, v, lens, part_acc, part_ml, B, H, KV, T_len,
                               n_splits, ks, vs, stream);
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const void* lens, void* part_acc, void* part_ml, void* out,
                         int B, int H, int KV, int d, int T_len, int n_splits,
                         CacheStrides ks, CacheStrides vs, cudaStream_t stream) {
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  const auto* lp = static_cast<const int32_t*>(lens);
  auto* pa = static_cast<float*>(part_acc);
  auto* pm = static_cast<float*>(part_ml);
  cudaError_t err = cudaErrorInvalidValue;
  switch (d) {
#define REPRO_DECODE_DIM(D)                                                       \
  case D:                                                                         \
    err = launch_dim<T, D>(qp, kp, vp, lp, pa, pm, B, H, KV, T_len, n_splits, ks, \
                           vs, stream);                                           \
    break;
    REPRO_DECODE_DIM(64)
    REPRO_DECODE_DIM(80)
    REPRO_DECODE_DIM(128)
    REPRO_DECODE_DIM(256)
#undef REPRO_DECODE_DIM
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const dim3 merge_grid(B * KV, H / KV, (d + 31) / 32);
  const int slices = n_splits < kMergeSlices ? n_splits : kMergeSlices;
  decode_merge_kernel<T><<<merge_grid, slices * 32, 0, stream>>>(
      pa, pm, static_cast<T*>(out), H, KV, d, n_splits);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  k and v strides are in elements
// over the (batch, row, KV head) axes of the caller's cache view; the head
// dim is contiguous, and q, k, v and every stride start rows on 16 bytes
// (else cudaErrorMisalignedAddress).  d is 64, 80, 128 or 256; H / KV <= 8.
// split must be split_rows(d) and n_splits = ceil(T / split); part_acc holds
// B * KV * n_splits * (H / KV) * d floats and part_ml twice
// B * KV * n_splits * (H / KV).  Two launches on the stream; returns the
// first failing cudaError_t (0 on success).
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* part_acc, void* part_ml, void* out, int B, int H, int KV, int d,
    int T_len, int split, int n_splits, int64_t k_sb, int64_t k_st, int64_t k_sh,
    int64_t v_sb, int64_t v_st, int64_t v_sh, int dtype, void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || H / KV > kMaxG || T_len < 1 ||
      split != split_rows(d) || n_splits != (T_len + split - 1) / split ||
      n_splits > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t vec = dtype == 0 ? 4 : 8;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out) ||
      k_sb % vec || k_st % vec || k_sh % vec || v_sb % vec || v_st % vec || v_sh % vec)
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto s = static_cast<cudaStream_t>(stream);
  const CacheStrides ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  if (dtype == 0)
    return static_cast<int>(launch_typed<float>(q, k, v, lengths, part_acc, part_ml,
                                                out, B, H, KV, d, T_len, n_splits,
                                                ks, vs, s));
  return static_cast<int>(launch_typed<__nv_bfloat16>(q, k, v, lengths, part_acc,
                                                       part_ml, out, B, H, KV, d,
                                                       T_len, n_splits, ks, vs, s));
}
