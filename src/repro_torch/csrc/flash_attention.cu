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
// Two kernels, chosen by dtype (a route, not a fallback: a launch that
// fails raises):
//   * bf16, the serving dtype: a FlashAttention-2-style kernel on the
//     tensor cores (below);
//   * fp32, the port's parity dtype: a CUDA-core kernel in full fp32.  The
//     card-against-CPU checks hold fp32 logits within 1e-4 and this kernel
//     within 2e-5 of its plain version, which bf16 or TF32 products cannot
//     meet; a 3xTF32 path is later work.
//
// What bounds it on the H100: at serving prompt lengths (S, T of a few
// hundred, d = 64..128) the two products take 4 * d FLOPs per causal
// (row, key) pair, about 2 * S * T * d per head at S = T, against
// S * d + 2 * T * d elements per head: operations
// bound it (989 TFLOP/s in bf16) once S reaches a few hundred, bytes at
// short suffixes.  At these sizes a launch is a few microseconds of
// latency (a block walks at most ~6 key tiles), so the design aims at
// keeping the tensor cores fed from shared memory and the copies of the
// next tile in flight, not at the last per cent of the peak.
//
// What the bf16 design does about it: one block of 4 warps per (b, h, 64
// query rows); each warp owns 16 rows.  The block copies its Q tile once
// and the K/V tiles of 64 keys (32 at d = 256, for registers) into a
// double-buffered ring with 16-byte cp.async (bf16 stays bf16; rows padded
// by 16 bytes so the 8 row addresses of an ldmatrix hit distinct banks),
// and issues tile i + 1's copy before it computes on tile i.  S = Q K^T
// runs as m16n8k16 mma.sync products (d / 16 steps of k16, so d = 80 is 5
// steps and needs no padding) with fragments from ldmatrix (Q kept in
// registers at d <= 128).  The online softmax runs on the accumulator
// fragments: a row's max and sum take two __shfl_xor_sync across its quad.
// P is rounded to bf16 in registers and used directly as the A operand of
// O += P V (V fragments by ldmatrix.trans), O stays in fp32 registers and
// is normalised once at the end.  Key tiles wholly above the diagonal are
// never copied, and a warp skips the tiles above its own 16 rows' diagonal.
//
// Invariance (the serving checks rely on it): a row's output depends only
// on its query and the keys it sees, never on B, S, H or the block that
// holds it.  Key tiles start at key 0 with a width fixed per head dim, so
// every row meets its keys in the same tiles in the same order; masked keys
// and skipped tiles add exact zeros (alpha = 1, p = 0); rows past S and
// keys past T are zero-filled in shared memory; no atomics, so a repeated
// call is bit-identical.  A suffix prefill over a cached prefix therefore
// gives bit for bit the rows of the whole-prompt prefill.
//
// The fp32 kernel: one block per (b, h, 16-row query tile) keeps the query
// tile and a 32-key K/V tile in shared memory (fp32); each warp owns 4 query
// rows; for a row, lane j scores key j of the tile, the warp takes max and
// sum with shuffles, and each lane accumulates its own head-dim elements of
// P V.  Its masking and invariance follow the same rules.
//
// Both read q, k, v and write out through the caller's strides (only the
// head dim contiguous), so q and k/v arrive as views of the model's
// [B, S, H, d] activations and [B, T, KV, d] cache: nothing is transposed
// per call.  The bf16 kernel needs 16-byte aligned rows (pointers and
// strides of whole 8-element chunks), which the wrapper checks.

#include "attention_common.cuh"
#include "tile_common.cuh"

namespace {

struct Strides {   // element strides of the (batch, head, sequence) axes
  int64_t b, h, s;
};

// Raises a kernel's dynamic shared memory limit above 48 KB; *done (one
// flag per kernel instantiation) skips the call after the first success.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, bool* done) {
  if (smem <= 48 * 1024 || *done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  *done = err == cudaSuccess;
  return err;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcBQ = 16 * kTcWarps;         // query rows per block
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct TcTile {
  static constexpr int BK = D >= 256 ? 32 : 64;   // keys per tile
  static constexpr int ROW = D + 8;               // smem row, 16 bytes of pad
  static constexpr int CH = D / 8;                // 16-byte chunks per row
  static constexpr bool Q_IN_REGS = D <= 128;
  static constexpr size_t smem() {
    return sizeof(__nv_bfloat16) * ROW * (kTcBQ + 4 * BK);
  }
};

template <int D>
__global__ void __launch_bounds__(kTcWarps * 32)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                int H, int KV, int S, int T_len, Strides qs, Strides ks,
                Strides vs, Strides os, float scale, float softcap, int causal) {
  using Tile = TcTile<D>;
  constexpr int BK = Tile::BK, ROW = Tile::ROW, CH = Tile::CH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [kTcBQ][ROW]
  __nv_bfloat16* k_s = q_s + kTcBQ * ROW;                    // [2][BK][ROW]
  __nv_bfloat16* v_s = k_s + 2 * BK * ROW;                   // [2][BK][ROW]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcBQ;   // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int group = lane >> 2, quad = lane & 3;
  const int offset = T_len - S;               // bottom-right causal alignment

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + kvh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kvh * vs.h;
  for (int c = threadIdx.x; c < kTcBQ * CH; c += blockDim.x) {
    const int r = c / CH, e = (c % CH) * 8;
    const bool in = q0 + r < S;
    cp_async16(q_s + r * ROW + e, in ? qb + (q0 + r) * qs.s + e : qb, in);
  }
  cp_async_commit();

  const int last_row = min(q0 + kTcBQ, S) - 1;
  const int kv_end = causal ? min(T_len, last_row + offset + 1) : T_len;
  const int n_tiles = (kv_end + BK - 1) / BK;
  auto copy_tile = [&](int tile) {
    const int kt = tile * BK;
    __nv_bfloat16* kd = k_s + (tile & 1) * BK * ROW;
    __nv_bfloat16* vd = v_s + (tile & 1) * BK * ROW;
    for (int c = threadIdx.x; c < BK * CH; c += blockDim.x) {
      const int j = c / CH, e = (c % CH) * 8;
      const bool in = kt + j < T_len;
      cp_async16(kd + j * ROW + e, in ? kb + (kt + j) * ks.s + e : kb, in);
      cp_async16(vd + j * ROW + e, in ? vb + (kt + j) * vs.s + e : vb, in);
    }
    cp_async_commit();
  };
  copy_tile(0);

  // this warp's 16 rows: row_a = w_row0 + group, row_b = row_a + 8
  const int w_row0 = q0 + warp * 16;
  const bool w_live = w_row0 < S;
  const int w_last = min(w_row0 + 15, S - 1);
  const int w_kv_end = causal ? min(T_len, w_last + offset + 1) : T_len;
  const int row_a = w_row0 + group, row_b = row_a + 8;

  float o[D / 8][4];
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  uint32_t qf[Tile::Q_IN_REGS ? D / 16 : 1][4];
  const __nv_bfloat16* q_frag = q_s + (warp * 16 + (lane & 15)) * ROW + (lane >> 4) * 8;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      copy_tile(it + 1);                     // in flight while tile it computes
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kt = it * BK;
    if constexpr (Tile::Q_IN_REGS) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qf[kk], q_frag + kk * 16);
      }
    }
    if (w_live && kt < w_kv_end) {
      const __nv_bfloat16* kt_s = k_s + (it & 1) * BK * ROW;
      const __nv_bfloat16* vt_s = v_s + (it & 1) * BK * ROW;
      // S = Q K^T: tile nn of 16 keys gives the B fragments of two n8 tiles
      float s[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      const __nv_bfloat16* k_frag =
          kt_s + ((lane & 7) + ((lane >> 4) << 3)) * ROW + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        if constexpr (Tile::Q_IN_REGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
        } else {
          ldmatrix_x4(a, q_frag + kk * 16);
        }
#pragma unroll
        for (int nn = 0; nn < BK / 16; ++nn) {
          uint32_t bf[4];
          ldmatrix_x4(bf, k_frag + nn * 16 * ROW + kk * 16);
          mma_bf16(s[2 * nn], a, bf[0], bf[1]);
          mma_bf16(s[2 * nn + 1], a, bf[2], bf[3]);
        }
      }
      // scale, softcap, mask; scores in log2 units from here on
      float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kt + j * 8 + quad * 2 + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          float x = s[j][e] * scale;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          const bool valid = col < T_len && (!causal || col <= row + offset);
          s[j][e] = valid ? x * kLog2e : kMaskValue;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = s[j][e] == kMaskValue ? 0.f : exp2f(s[j][e] - m[e >> 1]);
          l[e >> 1] += p;
          s[j][e] = p;
        }
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      // O += P V: P (bf16, registers) is the A operand over 16 keys
      const __nv_bfloat16* v_frag =
          vt_s + ((lane & 7) + ((lane >> 3) & 1) * 8) * ROW + (lane >> 4) * 8;
#pragma unroll
      for (int jj = 0; jj < BK / 16; ++jj) {
        const uint32_t a[4] = {pack_bf16x2(s[2 * jj][0], s[2 * jj][1]),
                               pack_bf16x2(s[2 * jj][2], s[2 * jj][3]),
                               pack_bf16x2(s[2 * jj + 1][0], s[2 * jj + 1][1]),
                               pack_bf16x2(s[2 * jj + 1][2], s[2 * jj + 1][3])};
#pragma unroll
        for (int nn = 0; nn < D / 16; ++nn) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, v_frag + jj * 16 * ROW + nn * 16);
          mma_bf16(o[2 * nn], a, bf[0], bf[1]);
          mma_bf16(o[2 * nn + 1], a, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();                         // buffer it & 1 is refilled next
  }

  if (!w_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv_a = 1.f / fmaxf(l[0], 1e-30f), inv_b = 1.f / fmaxf(l[1], 1e-30f);
  __nv_bfloat16* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + quad * 2;
    if (row_a < S)
      *reinterpret_cast<uint32_t*>(ob + row_a * os.s + col) =
          pack_bf16x2(o[n][0] * inv_a, o[n][1] * inv_a);
    if (row_b < S)
      *reinterpret_cast<uint32_t*>(ob + row_b * os.s + col) =
          pack_bf16x2(o[n][2] * inv_b, o[n][3] * inv_b);
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, int B,
                      int H, int KV, int S, int T_len, Strides qs, Strides ks,
                      Strides vs, Strides os, float softcap, int causal,
                      cudaStream_t stream) {
  const size_t smem = TcTile<D>::smem();
  auto kernel = flash_tc_kernel<D>;
  static bool smem_allowed = false;
  const cudaError_t err = allow_smem(kernel, smem, &smem_allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTcBQ - 1) / kTcBQ, H, B), block(kTcWarps * 32);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), H, KV,
      S, T_len, qs, ks, vs, os, scale, softcap, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;   // query rows per block
constexpr int kBK = 32;                      // keys per tile (one per lane)

// Lane l owns head-dim elements l, l + 32, ... of its rows' accumulators.
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out, int H, int KV,
                  int S, int T_len, Strides qs, Strides ks, Strides vs, Strides os,
                  float scale, float softcap, int causal) {
  using T = float;
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

template <int D>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* out,
                        int B, int H, int KV, int S, int T_len, Strides qs,
                        Strides ks, Strides vs, Strides os, float softcap,
                        int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kBQ * D + kBK * (D + 4) + kBK * D);
  auto kernel = flash_fp32_kernel<D>;
  static bool smem_allowed = false;
  const cudaError_t err = allow_smem(kernel, smem, &smem_allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B), block(kWarps * 32);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, KV, S, T_len, qs,
      ks, vs, os, scale, softcap, causal);
  return cudaGetLastError();
}

// 16-byte alignment of a bf16 operand: its pointer and every stride.
bool aligned16(const void* p, const Strides& st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 8 == 0 &&
         st.h % 8 == 0 && st.s % 8 == 0;
}

}  // namespace

// dtype codes: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores; every
// pointer 16-byte aligned and every stride a multiple of 8 elements, else
// cudaErrorMisalignedAddress).  q, k, v and out share the dtype.  Strides
// are in elements; the head-dim axis must be contiguous.  d is 16, 32, 64,
// 80, 128 or 256.  Returns the launch's cudaError_t (0 on success).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int KV, int S, int T_len, int d, int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
    int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss, float softcap,
    int causal, int dtype, void* stream) {
  if (B < 1 || S < 1 || T_len < 1 || KV < 1 || H % KV != 0 ||
      (causal && T_len < S) || B > 65535 || H > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  if (dtype == 1 && !(aligned16(q, qs) && aligned16(k, ks) && aligned16(v, vs) &&
                      aligned16(out, os)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define REPRO_FLASH_DIM(D)                                                        \
  case D:                                                                         \
    return static_cast<int>(                                                      \
        dtype == 0 ? launch_fp32<D>(q, k, v, out, B, H, KV, S, T_len, qs, ks, vs, \
                                    os, softcap, causal, s)                       \
                   : launch_tc<D>(q, k, v, out, B, H, KV, S, T_len, qs, ks, vs,   \
                                  os, softcap, causal, s));
    REPRO_FLASH_DIM(16)
    REPRO_FLASH_DIM(32)
    REPRO_FLASH_DIM(64)
    REPRO_FLASH_DIM(80)
    REPRO_FLASH_DIM(128)
    REPRO_FLASH_DIM(256)
#undef REPRO_FLASH_DIM
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
