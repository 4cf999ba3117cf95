// The split-KV decode body that decode_attention.cu (a dense cache) and
// paged_decode_attention.cu (a paged arena) both run.
//
// One query token per sequence, q [B, H, d], attends over the first
// lengths[b] logical cache rows of its sequence; the G = H / KV query heads
// of one KV head share one pass over its rows.  Softmax is online, in fp32;
// the output is written in q's dtype.
//
// The two kernels differ only in where a logical row lives, so the body is
// parameterised on a *row source* (below: DenseRows, PagedRows,
// PagedInt8Rows): given (b, KV head, logical row t) it loads the K and V
// row as chunks of VEC elements and widens them to fp32.  Everything else
// is this file's: the span of split_rows(d) logical rows per block, the
// grid (B * KV, n_splits) with n_splits = ceil(T / split_rows(d)) over the
// allocated length T, the empty partial at or past the length, the
// row-to-lane-group schedule, the in-block merge of the groups, and the
// second launch that merges the partials in a fixed order.  So a sequence
// decoded over a paged arena gives the bits it gets over the equal dense
// cache, alone or in any batch, call after call.
//
// The design (split-KV, two launches):
//   1. Each block takes one span of split_rows(d) logical rows (64 at
//      d <= 128, 32 at d = 256) of one (b, KV head).  The span is fixed
//      per head dim, never chosen from B, KV or the lengths, and the
//      lengths are never read on the host.  A block whose span starts at
//      or past its sequence's length writes an empty partial (m = mask
//      value, l = 0) and exits.  A row is read by a group of CHUNKS lanes
//      rounded up to 8, 16 or 32, each lane loading one chunk (16 bytes of
//      bf16 or fp32, 8 bytes of int8: the same elements per lane as bf16),
//      so one warp load instruction reads several rows, each coalesced.  A
//      group issues the loads of all its rows of a round before it
//      computes with any of them, reduces each dot product within the
//      group by shuffles, and keeps its own online-softmax state per query
//      head.  The groups' states are merged through shared memory in group
//      order into the block's partial (m, l and an un-normalised fp32
//      [G, d] accumulator) in a scratch the wrapper allocates.
//   2. One block per (b, KV head, query head, 32 head-dim elements) merges
//      the partials in a fixed order (its warps take every 16th split,
//      lanes the elements), skipping empty ones, and normalises (l clamped
//      at 1e-30, so a sequence of length 0 gives zeros).
// The slice entry of decode_attention.cu runs both over one rank's rows
// of a sequence-sharded cache and also writes each row's log-sum-exp; the
// same merge kernel then combines R ranks' gathered (o, lse) in rank
// order (RankParts), as it combines one call's splits.
// No atomics.  Element offsets are 64-bit.

#pragma once

#include "attention_common.cuh"

namespace {

constexpr int kDecodeWarps = 4;
constexpr int kMaxG = 8;
constexpr int kMaxSplit = 64;      // the largest split_rows(d)

// Logical cache rows per split; kernels/decode_attention.py:split_rows
// mirrors it.
constexpr int split_rows(int d) { return d <= 128 ? 64 : 32; }

template <int VEC, int D, int GMAX>
struct DecodeCfg {
  static constexpr int CHUNKS = D / VEC;           // chunks per row
  static constexpr int LANES = CHUNKS <= 8 ? 8 : (CHUNKS <= 16 ? 16 : 32);
  static constexpr int PASSES = (CHUNKS + 31) / 32;   // loads per lane per row
  static constexpr int E = VEC * PASSES;           // elements per lane per row
  static constexpr int GROUPS = kDecodeWarps * 32 / LANES;
  static constexpr int SPLIT = split_rows(D);
  // rows a group loads before it computes: fewer when q and the
  // accumulators already take many registers
  static constexpr int R_REG = GMAX * E <= 32 ? 8 : 4;
  static constexpr int R = R_REG < SPLIT / GROUPS ? R_REG : SPLIT / GROUPS;
  static constexpr int ROUNDS = SPLIT / (GROUPS * R);
  static_assert(D % VEC == 0 && SPLIT <= kMaxSplit, "head dim");
};

// ---------------------------------------------------------------------------
// Row sources.  Each has Elem, Chunk (one lane's load) and VEC (its
// elements); Shared (block state in shared memory) with begin(), issued
// before the length is read, and ready(), once the block knows it has
// rows; locate(), where logical row t lives (its K and V row and its
// scale's index); scales (1 unless the arena is int8); unpack() to fp32.
// The body computes every row's place before it issues any load, and
// loads a row past the span's live end at the last live row, which it
// then skips: the loads of a round go out back to back, unpredicated by
// the length (a predicated load per row compiled to a branch per row and
// cost up to 14% at zamba2's heads).
// ---------------------------------------------------------------------------

template <typename T>
struct RowAt { const T* k; const T* v; int64_t s; };

template <typename Chunk, typename T>
__device__ __forceinline__ Chunk load_chunk(const T* p) {
  return __ldg(reinterpret_cast<const Chunk*>(p));
}

struct CacheStrides {   // element strides of the (batch, row, KV head) axes
  int64_t b, t, h;
};

// A dense [B, T, KV, d] cache, as a strided view (only the head dim
// contiguous): row t of (b, h) starts at b * s.b + t * s.t + h * s.h.
template <typename T>
struct DenseRows {
  using Elem = T;
  using Chunk = uint4;
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr bool SCALED = false;
  struct Shared {};
  const T* k;
  const T* v;
  CacheStrides ks, vs;

  __device__ void begin(Shared&, int, int, int) const {}
  __device__ void ready() const {}
  __device__ RowAt<T> locate(const Shared&, int b, int kvh, int, int t) const {
    return {k + b * ks.b + kvh * ks.h + t * ks.t,
            v + b * vs.b + kvh * vs.h + t * vs.t, 0};
  }
  __device__ float k_scale(int64_t) const { return 1.f; }
  __device__ float v_scale(int64_t) const { return 1.f; }
  __device__ static void unpack(const Chunk& raw, float, float* out) {
    unpack16<T>(raw, out);
  }
};

// The page walk of a [P, ps, KV, d] arena: logical row t of sequence b is
// row t % ps of page page_table[b, t / ps].  A block loads the page ids
// its span touches into shared memory once (at most kMaxSplit of them, at
// ps = 1), so each page is looked up once per block, not per row or lane.
// Any ps >= 1 works: spans are in logical rows.
template <typename T>
struct PageWalk {
  using Elem = T;
  const int32_t* page_table;   // [B, NB]
  int NB, ps, KV, d;
  const T* k;
  const T* v;
  struct Shared { int32_t page[kMaxSplit]; };

  __device__ void begin(Shared& sm, int b, int r_begin, int r_hi) const {
    const int first = r_begin / ps, count = (r_hi - 1) / ps - first + 1;
    for (int i = threadIdx.x; i < count; i += blockDim.x)
      sm.page[i] = __ldg(page_table + static_cast<int64_t>(b) * NB + first + i);
  }
  __device__ void ready() const { __syncthreads(); }
  __device__ RowAt<T> locate(const Shared& sm, int, int kvh, int r_begin, int t) const {
    const int64_t page = sm.page[t / ps - r_begin / ps];
    const int64_t row = (page * ps + t % ps) * KV + kvh;
    return {k + row * d, v + row * d, row};
  }
};

// A bf16 or fp32 arena, read in 16-byte chunks as the dense cache is.
template <typename T>
struct PagedRows : PageWalk<T> {
  using Chunk = uint4;
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr bool SCALED = false;

  __device__ float k_scale(int64_t) const { return 1.f; }
  __device__ float v_scale(int64_t) const { return 1.f; }
  __device__ static void unpack(const Chunk& raw, float, float* out) {
    unpack16<T>(raw, out);
  }
};

// An int8 arena with one fp32 scale per row ([P, ps, KV]), dequantized in
// registers as to_f32(x) * scale, the plain version's arithmetic.  A lane
// loads 8 bytes (8 values), so lanes own the same elements as in bf16 and
// the group schedule is bf16's; 16-byte loads would halve the lanes per
// row and double each lane's registers for K and V.
struct PagedInt8Rows : PageWalk<int8_t> {
  using Chunk = uint2;
  static constexpr int VEC = 8;
  static constexpr bool SCALED = true;
  const float* k_scales;
  const float* v_scales;

  __device__ float k_scale(int64_t s) const { return __ldg(k_scales + s); }
  __device__ float v_scale(int64_t s) const { return __ldg(v_scales + s); }
  __device__ static void unpack(const Chunk& raw, float scale, float* out) {
    const uint32_t w[2] = {raw.x, raw.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[4 * i + j] = to_f32(static_cast<int8_t>(w[i] >> (8 * j))) * scale;
    }
  }
};

// q's elements [c * VEC, (c + 1) * VEC) of one row, in 16-byte loads.
template <typename TQ, int VEC>
__device__ __forceinline__ void load_q(const TQ* p, bool in, float* out) {
  constexpr int PER = 16 / sizeof(TQ);
  static_assert(VEC % PER == 0, "q chunk");
#pragma unroll
  for (int j = 0; j < VEC / PER; ++j) {
    const uint4 raw = in ? *reinterpret_cast<const uint4*>(p + j * PER)
                         : make_uint4(0, 0, 0, 0);
    unpack16<TQ>(raw, out + j * PER);
  }
}

// ---------------------------------------------------------------------------
// 1. one partial per (b, KV head, span)
// ---------------------------------------------------------------------------

template <typename TQ, typename Rows, int D, int GMAX>
__global__ void __launch_bounds__(kDecodeWarps * 32)
decode_split_kernel(const TQ* __restrict__ q, const Rows rows,
                    const int32_t* __restrict__ lengths,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int H, int KV, int G, int T_len, float scale) {
  constexpr int VEC = Rows::VEC;
  using C = DecodeCfg<VEC, D, GMAX>;
  using Chunk = typename Rows::Chunk;
  constexpr int E = C::E, LANES = C::LANES, R = C::R;
  const int bh = blockIdx.x;
  const int b = bh / KV, kvh = bh % KV;
  const int split = blockIdx.y;
  const int64_t part = static_cast<int64_t>(bh) * gridDim.y + split;
  float* ml = part_ml + part * G * 2;
  const int r_begin = split * C::SPLIT;
  __shared__ typename Rows::Shared rows_sm;
  rows.begin(rows_sm, b, r_begin, min(r_begin + C::SPLIT, T_len));
  const int n = max(0, min(lengths[b], T_len));
  if (r_begin >= n) {                                // empty partial
    if (threadIdx.x < G) {
      ml[2 * threadIdx.x] = kMaskValue;
      ml[2 * threadIdx.x + 1] = 0.f;
    }
    return;
  }
  rows.ready();
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
      load_q<TQ, VEC>(q + (static_cast<int64_t>(b) * H + kvh * G + g) * D + c * VEC,
                      g < G && c < C::CHUNKS, &qr[g][p * VEC]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][p * VEC + i] = 0.f;
    }
  }

#pragma unroll 1
  for (int round = 0; round < C::ROUNDS; ++round) {
    const int base = r_begin + round * C::GROUPS * R;
    if (base >= r_end) break;                        // block-uniform
    bool live[R];
    RowAt<typename Rows::Elem> at[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {                    // every row's place
      const int row = base + r * C::GROUPS + grp;   // (a dead row: the last
      live[r] = row < r_end;                         // live one, skipped)
      at[r] = rows.locate(rows_sm, b, kvh, r_begin, min(row, r_end - 1));
    }
    float ksc[R], vsc[R];
    Chunk kx[R][C::PASSES], vx[R][C::PASSES];
#pragma unroll
    for (int r = 0; r < R; ++r) {                    // then all loads
#pragma unroll
      for (int p = 0; p < C::PASSES; ++p) {
        const int c = li + 32 * p;
        const bool in = c < C::CHUNKS;
        kx[r][p] = in ? load_chunk<Chunk>(at[r].k + c * VEC) : Chunk{};
        vx[r][p] = in ? load_chunk<Chunk>(at[r].v + c * VEC) : Chunk{};
      }
      ksc[r] = Rows::SCALED ? rows.k_scale(at[r].s) : 1.f;
      vsc[r] = Rows::SCALED ? rows.v_scale(at[r].s) : 1.f;
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
          Rows::unpack(kx[r][p], ksc[r], kf);
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
          Rows::unpack(vx[r][p], vsc[r], vf);
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

// ---------------------------------------------------------------------------
// 2. the partials merged
// ---------------------------------------------------------------------------

constexpr int kMergeSlices = 16;   // warps of a merge block at most

// Where the merge reads its parts: per (bh = b * KV + KV head, part s,
// query head g of the KV head's G) an (m, l) pair and a [d] fp32 row.
// SplitParts are one call's split-KV partials: un-normalised accumulators
// [B * KV, n_splits, G, d] and (m, l) [B * KV, n_splits, G, 2].
struct SplitParts {
  const float* acc;
  const float* ml;
  int n;                                              // splits
  __device__ float2 ml_at(int bh, int s, int g, int G) const {
    return reinterpret_cast<const float2*>(ml)[(static_cast<int64_t>(bh) * n + s) * G + g];
  }
  __device__ const float* acc_at(int bh, int s, int g, int G, int d) const {
    return acc + ((static_cast<int64_t>(bh) * n + s) * G + g) * d;
  }
};

// RankParts are R ranks' results of the slice entry, gathered in rank
// order: o [R, B, H, d] fp32 (normalised) and lse [R, B, H] fp32.  A part
// is m = lse, l = 1 and the row o, so the merge's arithmetic gives
// sum_r exp(lse_r - max) o_r / sum_r exp(lse_r - max); a rank whose slice
// held no rows (lse = -inf) has l = 0 and is skipped.
struct RankParts {
  const float* o;
  const float* lse;
  int n, B, H, KV;                                    // n: ranks
  __device__ float2 ml_at(int bh, int s, int g, int G) const {
    const float x = lse[(static_cast<int64_t>(s) * B + bh / KV) * H + (bh % KV) * G + g];
    return make_float2(x, x > -INFINITY ? 1.f : 0.f);
  }
  __device__ const float* acc_at(int bh, int s, int g, int G, int d) const {
    return o + ((static_cast<int64_t>(s) * B + bh / KV) * H + (bh % KV) * G + g) * d;
  }
};

// One block per (b, KV head, query head, 32 head-dim elements): the parts
// merged in a fixed order.  Warp 0 finds the largest m of the live parts
// and the normaliser; then lane e of warp w sums element e of every w-th
// part, and warp 0 adds the warps' sums in warp order.  The number of
// warps, min(16, parts), depends on T (or R) alone.  Empty parts (l = 0)
// add nothing and their rows are never read.  With lse_out, block z = 0
// also writes the row's log-sum-exp (m + log l; -inf for no rows).
template <typename T, typename Parts>
__global__ void __launch_bounds__(kMergeSlices * 32)
decode_merge_kernel(const Parts parts, T* __restrict__ out,
                    float* __restrict__ lse_out, int H, int KV, int d) {
  __shared__ float sm_part[kMergeSlices][32];
  __shared__ float sm_max, sm_l;
  const int bh = blockIdx.x, g = blockIdx.y, G = gridDim.y;
  const int b = bh / KV, kvh = bh % KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slices = blockDim.x >> 5;
  const int e = blockIdx.z * 32 + lane;
  const int n_parts = parts.n;
  if (warp == 0) {
    float mx = kMaskValue;
    for (int s = lane; s < n_parts; s += 32) {
      const float2 x = parts.ml_at(bh, s, g, G);
      if (x.y > 0.f) mx = fmaxf(mx, x.x);
    }
    mx = warp_max(mx);
    float lsum = 0.f;
    for (int s = lane; s < n_parts; s += 32) {
      const float2 x = parts.ml_at(bh, s, g, G);
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
    for (int s = warp; s < n_parts; s += slices) {
      const float2 x = parts.ml_at(bh, s, g, G);
      const float v = parts.acc_at(bh, s, g, G, d)[e];
      a += x.y > 0.f ? v * expf(x.x - mx) : 0.f;
    }
  }
  sm_part[warp][lane] = a;
  __syncthreads();
  const int64_t row = static_cast<int64_t>(b) * H + kvh * G + g;
  if (warp == 0 && e < d) {
    for (int w = 1; w < slices; ++w) a += sm_part[w][lane];
    out[row * d + e] = from_f32<T>(a / fmaxf(sm_l, 1e-30f));
  }
  if (lse_out != nullptr && threadIdx.x == 0 && blockIdx.z == 0)
    lse_out[row] = sm_l > 0.f ? mx + logf(sm_l) : -INFINITY;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// The arguments every caller checks the same way: G <= 8, split ==
// split_rows(d), n_splits == ceil(T_len / split) within the grid's limit.
bool decode_args_ok(int B, int H, int KV, int d, int T_len, int split, int n_splits) {
  return B >= 1 && KV >= 1 && H % KV == 0 && H / KV <= kMaxG && T_len >= 1 &&
         split == split_rows(d) && n_splits == (T_len + split - 1) / split &&
         n_splits <= 65535;
}

template <typename TQ, typename Rows, int D, int GMAX>
cudaError_t launch_split(const TQ* q, const Rows& rows, const int32_t* lens,
                         float* part_acc, float* part_ml, int B, int H, int KV,
                         int T_len, int n_splits, cudaStream_t stream) {
  const dim3 grid(B * KV, n_splits), block(kDecodeWarps * 32);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  decode_split_kernel<TQ, Rows, D, GMAX><<<grid, block, 0, stream>>>(
      q, rows, lens, part_acc, part_ml, H, KV, H / KV, T_len, scale);
  return cudaGetLastError();
}

template <typename TQ, typename Rows, int D>
cudaError_t launch_dim(const TQ* q, const Rows& rows, const int32_t* lens,
                       float* part_acc, float* part_ml, int B, int H, int KV,
                       int T_len, int n_splits, cudaStream_t stream) {
  const int G = H / KV;
  if (G == 1)
    return launch_split<TQ, Rows, D, 1>(q, rows, lens, part_acc, part_ml, B, H, KV,
                                        T_len, n_splits, stream);
  if (G <= 4)
    return launch_split<TQ, Rows, D, 4>(q, rows, lens, part_acc, part_ml, B, H, KV,
                                        T_len, n_splits, stream);
  return launch_split<TQ, Rows, D, 8>(q, rows, lens, part_acc, part_ml, B, H, KV,
                                      T_len, n_splits, stream);
}

// Both launches of one call on ``stream``: the partials over T_len
// allocated rows, then the merge into out [B, H, d] (in TO: q's type, or
// fp32 for the slice entry, which also asks for lse_out [B, H]).  d is
// 64, 80, 128 or 256.  Returns the first failing cudaError_t.
template <typename TQ, typename Rows, typename TO = TQ>
cudaError_t launch_decode(const void* q, const Rows& rows, const void* lens,
                          void* part_acc, void* part_ml, void* out, int B, int H,
                          int KV, int d, int T_len, int n_splits,
                          cudaStream_t stream, float* lse_out = nullptr) {
  const auto* qp = static_cast<const TQ*>(q);
  const auto* lp = static_cast<const int32_t*>(lens);
  auto* pa = static_cast<float*>(part_acc);
  auto* pm = static_cast<float*>(part_ml);
  cudaError_t err = cudaErrorInvalidValue;
  switch (d) {
#define REPRO_DECODE_DIM(D)                                                     \
  case D:                                                                       \
    err = launch_dim<TQ, Rows, D>(qp, rows, lp, pa, pm, B, H, KV, T_len,        \
                                  n_splits, stream);                            \
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
  decode_merge_kernel<TO, SplitParts><<<merge_grid, slices * 32, 0, stream>>>(
      SplitParts{pa, pm, n_splits}, static_cast<TO*>(out), lse_out, H, KV, d);
  return cudaGetLastError();
}

// The merge alone over R ranks' gathered (o, lse) (RankParts), into out
// [B, H, d] of type T, in rank order: one block per (b, query head, 32
// head-dim elements).
template <typename T>
cudaError_t launch_merge_ranks(const float* o, const float* lse, void* out, int R,
                               int B, int H, int d, cudaStream_t stream) {
  const dim3 grid(B, H, (d + 31) / 32);
  const int slices = R < kMergeSlices ? R : kMergeSlices;
  decode_merge_kernel<T, RankParts><<<grid, slices * 32, 0, stream>>>(
      RankParts{o, lse, R, B, H, 1}, static_cast<T*>(out), nullptr, H, 1, d);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
