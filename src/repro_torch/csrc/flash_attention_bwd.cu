// Flash attention backward for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention) in training: the gradient of its port,
// csrc/flash_attention.cu.  The JAX package has no backward kernel: its
// training path takes jax.value_and_grad of plain jnp attention.  The
// port's forward runs the hand-written kernel on the card, so its gradient
// is a kernel too.
//
// What it computes, the flash-attention-2 backward: with P recomputed from
// q, k and the forward's row log-sum-exp (P = exp(s - lse), s the scaled,
// optionally tanh-capped scores under the forward's mask: causal aligned
// bottom-right, col <= row + T - S, or none),
//   D  = rowsum(dO * O)
//   dP = dO V^T,  dS = P * (dP - D)  (times 1 - tanh^2 under a softcap)
//   dV = P^T dO,  dK = scale * dS^T Q,  dQ = scale * dS K.
// GQA: a KV head's dK and dV sum over its G query heads.  fp32 in, fp32
// out; the products accumulate in fp32.
//
// What bounds it on the H100: operations.  The three passes recompute the
// scores twice, so they do 7 products of 2 d FLOPs per (row, key) pair
// against the forward's 2, with no tensor cores in fp32 (67 TFLOP/s); the
// bytes (q, k, v, o, dO read once, dq, dk, dv written once) are tiny
// beside that at any prompt of a few hundred tokens.
//
// What this design does about it, simply: three launches, no atomics, so
// the bits are the same run to run (a training run resumed from a
// checkpoint retraces the uninterrupted one bit for bit):
//   1. D per query row, one warp per row;
//   2. dK and dV: one block of 256 threads per (b, KV head, key tile of BK
//      keys).  It keeps its K and V tile in shared memory and walks every
//      query tile of BQ = 32 rows that sees one of its keys, for each of
//      the G query heads of its KV head, so dK and dV are written once.
//      Per query tile the block loads Q and dO into shared memory; in the
//      score pass lane j of each warp takes key j against BQ * BK / 256
//      rows, the rows read as float4 broadcasts, so a dot product costs
//      two shared loads per 8 FMAs beside the lane's own key row; P and dS
//      go to shared memory, and then each thread adds d / (256 / BK)
//      head-dim elements of one key's dV += P^T dO and dK += dS^T Q in
//      registers (float4 loads where d is a multiple of 32);
//   3. dQ: one block per (b, head, query tile of BQ rows), keeping Q, dO,
//      the rows' lse and D in shared memory and walking the key tiles the
//      rows see; in the score pass lane i takes row i against BK / 8 keys
//      read as float4 broadcasts, then each thread accumulates d / 8
//      head-dim elements of one row's dQ in registers.
// A tile read one row per lane is padded by one float (its rows fall in
// distinct banks), a tile read in common by four (rows on 16 bytes).  BK
// is 32 keys (16 at d = 256, for shared memory).  wgmma, TMA and 3xTF32
// come later.
//
// q, k, v, o, dO, dq, dk and dv are read and written through the caller's
// (batch, head, sequence) strides with a contiguous head dim; lse and D
// are contiguous fp32 [B, H, S].

#include <cmath>

#include "attention_common.cuh"

namespace {

struct Strides {   // element strides of the (batch, head, sequence) axes
  int64_t b, h, s;
};

constexpr int kThreads = 256;
constexpr int kBQ = 32;                      // query rows per tile

template <int D>
struct BwdTile {
  static constexpr int BK = D >= 256 ? 16 : 32;     // keys per tile
  // a tile whose rows a warp reads one per lane is padded by one float
  // (the 32 rows fall in distinct banks); a tile whose rows the warp reads
  // in common (a broadcast) by four, so each row starts on 16 bytes and
  // is read as float4
  static constexpr int LANE_ROW = D + 1;
  static constexpr int BCAST_ROW = D + 4;
  static constexpr int PROW = BK + 1;               // padded P / dS row
  static constexpr int TPK = kThreads / BK;         // threads per key (dK, dV)
  static constexpr int DPK = D / TPK;               // head-dim elements each
  static constexpr int TPR = kThreads / kBQ;        // threads per row (dQ)
  static constexpr int DPR = D / TPR;
  // float4 accumulation where each thread's elements come in groups of 4
  static constexpr bool VEC = D % 32 == 0;
  static_assert(D % TPK == 0 && D % TPR == 0 && D % 4 == 0, "head dim split");
  static constexpr size_t smem() {
    return sizeof(float) * ((2 * BK + 2 * kBQ) * BCAST_ROW + 2 * kBQ * PROW + 2 * kBQ);
  }
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, bool* done) {
  if (smem <= 48 * 1024 || *done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  *done = err == cudaSuccess;
  return err;
}

// rows [r0, r0 + n) of one (b, head) slice into a shared tile of rows ROW
// floats apart; rows past `limit` are zero-filled
template <int D, int ROW>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int64_t s_stride,
                                          int r0, int n, int limit) {
  for (int idx = threadIdx.x; idx < n * D; idx += kThreads) {
    const int r = idx / D, e = idx % D;
    dst[r * ROW + e] = r0 + r < limit ? src[(r0 + r) * s_stride + e] : 0.f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(const float4 x, float a0, float a1, float a2,
                                      float a3, float acc) {
  return fmaf(x.w, a3, fmaf(x.z, a2, fmaf(x.y, a1, fmaf(x.x, a0, acc))));
}

// sa[r] = a . A[r] and sb[r] = b . B[r] over D elements: a and b are this
// lane's own rows (scalar loads), A[r] and B[r] rows the warp shares
// (16-byte aligned, float4 loads), so each 4 elements cost 8 scalar and
// 2N vector loads for 8N FMAs
template <int D, int N>
__device__ __forceinline__ void dot_pairs(const float* a, const float* b,
                                          const float* const (&A)[N],
                                          const float* const (&B)[N], float (&sa)[N],
                                          float (&sb)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) sa[r] = sb[r] = 0.f;
#pragma unroll 4
  for (int e = 0; e < D; e += 4) {
    const float a0 = a[e], a1 = a[e + 1], a2 = a[e + 2], a3 = a[e + 3];
    const float b0 = b[e], b1 = b[e + 1], b2 = b[e + 2], b3 = b[e + 3];
#pragma unroll
    for (int r = 0; r < N; ++r) {
      sa[r] = dot4(ld4(A[r] + e), a0, a1, a2, a3, sa[r]);
      sb[r] = dot4(ld4(B[r] + e), b0, b1, b2, b3, sb[r]);
    }
  }
}

// P and dS of one (row, key) entry from its raw score q.k and dP = dO.v:
// scaled, optionally tanh-capped, masked; dS carries the softcap
// derivative and the scale.  Outside the mask both are 0.
__device__ __forceinline__ void entry(float qk, float dp, float lse, float dd,
                                      bool valid, float scale, float softcap,
                                      float& p, float& ds) {
  p = ds = 0.f;
  if (!valid) return;
  float s = qk * scale, dtanh = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(s / softcap);
    s = t * softcap;
    dtanh = 1.f - t * t;
  }
  p = expf(s - lse);
  ds = p * (dp - dd) * dtanh * scale;
}

// 1. D = rowsum(dO * O), one warp per (b, h, row)
__global__ void __launch_bounds__(kThreads)
flash_bwd_dot_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                     float* __restrict__ dd, int H, int S, int d, Strides os,
                     Strides dos, int64_t rows) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int s = static_cast<int>(r % S);
  const int64_t bh = r / S;
  const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
  const float* orow = o + b * os.b + h * os.h + s * os.s;
  const float* drow = dout + b * dos.b + h * dos.h + s * dos.s;
  float acc = 0.f;
  for (int e = lane; e < d; e += 32) acc = fmaf(orow[e], drow[e], acc);
  acc = warp_sum(acc);
  if (lane == 0) dd[r] = acc;
}

// 2. dK and dV per (key tile, KV head, b).  Lane j of a warp owns key j of
// the tile in the score pass (K and V rows one per lane), the warp's rows
// of Q and dO read in common.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dd,
                      float* __restrict__ dk, float* __restrict__ dv, int H, int KV,
                      int S, int T_len, Strides qs, Strides ks, Strides vs,
                      Strides dos, Strides dks, float scale, float softcap,
                      int causal) {
  using Tile = BwdTile<D>;
  constexpr int BK = Tile::BK, LROW = Tile::LANE_ROW, BROW = Tile::BCAST_ROW;
  constexpr int PROW = Tile::PROW, TPK = Tile::TPK, DPK = Tile::DPK;
  constexpr int RPT = kBQ * BK / kThreads;  // score entries per thread
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                         // [kBQ][BROW]
  float* do_s = q_s + kBQ * BROW;            // [kBQ][BROW]
  float* k_s = do_s + kBQ * BROW;            // [BK][LROW]
  float* v_s = k_s + BK * LROW;              // [BK][LROW]
  float* p_s = v_s + BK * LROW;              // [kBQ][PROW]
  float* ds_s = p_s + kBQ * PROW;            // [kBQ][PROW]
  float* lse_s = ds_s + kBQ * PROW;          // [kBQ]
  float* dd_s = lse_s + kBQ;                 // [kBQ]

  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int offset = T_len - S;
  load_rows<D, LROW>(k_s, k + b * ks.b + kvh * ks.h, ks.s, k0, BK, T_len);
  load_rows<D, LROW>(v_s, v + b * vs.b + kvh * vs.h, vs.s, k0, BK, T_len);

  const int j = threadIdx.x % BK;            // score pass: this lane's key
  const int i0 = threadIdx.x / BK;           // ... and rows i0 + r * 256 / BK
  const int jj = threadIdx.x / TPK, sub = threadIdx.x % TPK;   // accumulation
  float dk_acc[DPK], dv_acc[DPK];
#pragma unroll
  for (int m = 0; m < DPK; ++m) dk_acc[m] = dv_acc[m] = 0.f;

  // the first query row that sees key k0, rounded down to a tile
  const int q_first = causal ? max(0, k0 - offset) / kBQ * kBQ : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* qb = q + b * qs.b + h * qs.h;
    const float* dob = dout + b * dos.b + h * dos.h;
    const int64_t lrow = (static_cast<int64_t>(b) * H + h) * S;
    for (int q0 = q_first; q0 < S; q0 += kBQ) {
      __syncthreads();                       // previous tile fully consumed
      load_rows<D, BROW>(q_s, qb, qs.s, q0, kBQ, S);
      load_rows<D, BROW>(do_s, dob, dos.s, q0, kBQ, S);
      for (int i = threadIdx.x; i < kBQ; i += kThreads) {
        lse_s[i] = q0 + i < S ? lse[lrow + q0 + i] : 0.f;
        dd_s[i] = q0 + i < S ? dd[lrow + q0 + i] : 0.f;
      }
      __syncthreads();
      {
        const float* qr[RPT];
        const float* dr[RPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int i = i0 + r * (kThreads / BK);
          qr[r] = q_s + i * BROW;
          dr[r] = do_s + i * BROW;
        }
        float qk[RPT], dp[RPT];
        dot_pairs<D, RPT>(k_s + j * LROW, v_s + j * LROW, qr, dr, qk, dp);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int i = i0 + r * (kThreads / BK);
          const int row = q0 + i, col = k0 + j;
          const bool valid = row < S && col < T_len && (!causal || col <= row + offset);
          entry(qk[r], dp[r], lse_s[i], dd_s[i], valid, scale, softcap,
                p_s[i * PROW + j], ds_s[i * PROW + j]);
        }
      }
      __syncthreads();
      for (int i = 0; i < kBQ; ++i) {
        const float p = p_s[i * PROW + jj], ds = ds_s[i * PROW + jj];
        if constexpr (Tile::VEC) {
#pragma unroll
          for (int m = 0; m < DPK / 4; ++m) {
            const int e = 4 * (sub + TPK * m);
            const float4 d4 = ld4(do_s + i * BROW + e), q4 = ld4(q_s + i * BROW + e);
            dv_acc[4 * m] = fmaf(p, d4.x, dv_acc[4 * m]);
            dv_acc[4 * m + 1] = fmaf(p, d4.y, dv_acc[4 * m + 1]);
            dv_acc[4 * m + 2] = fmaf(p, d4.z, dv_acc[4 * m + 2]);
            dv_acc[4 * m + 3] = fmaf(p, d4.w, dv_acc[4 * m + 3]);
            dk_acc[4 * m] = fmaf(ds, q4.x, dk_acc[4 * m]);
            dk_acc[4 * m + 1] = fmaf(ds, q4.y, dk_acc[4 * m + 1]);
            dk_acc[4 * m + 2] = fmaf(ds, q4.z, dk_acc[4 * m + 2]);
            dk_acc[4 * m + 3] = fmaf(ds, q4.w, dk_acc[4 * m + 3]);
          }
        } else {
#pragma unroll
          for (int m = 0; m < DPK; ++m) {
            const int e = sub + TPK * m;
            dv_acc[m] = fmaf(p, do_s[i * BROW + e], dv_acc[m]);
            dk_acc[m] = fmaf(ds, q_s[i * BROW + e], dk_acc[m]);
          }
        }
      }
    }
  }
  const int key = k0 + jj;
  if (key >= T_len) return;
  float* dkr = dk + b * dks.b + kvh * dks.h + key * dks.s;
  float* dvr = dv + b * dks.b + kvh * dks.h + key * dks.s;
#pragma unroll
  for (int m = 0; m < DPK; ++m) {
    const int e = Tile::VEC ? 4 * (sub + TPK * (m / 4)) + m % 4 : sub + TPK * m;
    dkr[e] = dk_acc[m];
    dvr[e] = dv_acc[m];
  }
}

// 3. dQ per (query tile, head, b).  Lane i of a warp owns row i of the tile
// in the score pass (Q and dO rows one per lane), the warp's keys of K and
// V read in common.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dd,
                    float* __restrict__ dq, int H, int KV, int S, int T_len,
                    Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs,
                    float scale, float softcap, int causal) {
  using Tile = BwdTile<D>;
  constexpr int BK = Tile::BK, LROW = Tile::LANE_ROW, BROW = Tile::BCAST_ROW;
  constexpr int PROW = Tile::PROW, TPR = Tile::TPR, DPR = Tile::DPR;
  constexpr int KPT = BK * kBQ / kThreads;   // score entries (keys) per thread
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                         // [BK][BROW]
  float* v_s = k_s + BK * BROW;              // [BK][BROW]
  float* q_s = v_s + BK * BROW;              // [kBQ][LROW]
  float* do_s = q_s + kBQ * LROW;            // [kBQ][LROW]
  float* ds_s = do_s + kBQ * LROW;           // [kBQ][PROW]
  float* lse_s = ds_s + kBQ * PROW;          // [kBQ]
  float* dd_s = lse_s + kBQ;                 // [kBQ]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int offset = T_len - S;
  load_rows<D, LROW>(q_s, q + b * qs.b + h * qs.h, qs.s, q0, kBQ, S);
  load_rows<D, LROW>(do_s, dout + b * dos.b + h * dos.h, dos.s, q0, kBQ, S);
  const int64_t lrow = (static_cast<int64_t>(b) * H + h) * S;
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    lse_s[i] = q0 + i < S ? lse[lrow + q0 + i] : 0.f;
    dd_s[i] = q0 + i < S ? dd[lrow + q0 + i] : 0.f;
  }

  const int i_lane = threadIdx.x % kBQ;      // score pass: this lane's row
  const int j0 = threadIdx.x / kBQ;          // ... and keys j0 + r * 8
  const int i_own = threadIdx.x / TPR, sub = threadIdx.x % TPR;   // accumulation
  float dq_acc[DPR];
#pragma unroll
  for (int m = 0; m < DPR; ++m) dq_acc[m] = 0.f;

  const int last_row = min(q0 + kBQ, S) - 1;
  const int kv_end = causal ? min(T_len, last_row + offset + 1) : T_len;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();                         // previous tile fully consumed
    load_rows<D, BROW>(k_s, kb, ks.s, k0, BK, T_len);
    load_rows<D, BROW>(v_s, vb, vs.s, k0, BK, T_len);
    __syncthreads();
    {
      const float* kr[KPT];
      const float* vr[KPT];
#pragma unroll
      for (int r = 0; r < KPT; ++r) {
        kr[r] = k_s + (j0 + r * (kThreads / kBQ)) * BROW;
        vr[r] = v_s + (j0 + r * (kThreads / kBQ)) * BROW;
      }
      float qk[KPT], dp[KPT];
      dot_pairs<D, KPT>(q_s + i_lane * LROW, do_s + i_lane * LROW, kr, vr, qk, dp);
      const int row = q0 + i_lane;
#pragma unroll
      for (int r = 0; r < KPT; ++r) {
        const int jr = j0 + r * (kThreads / kBQ), col = k0 + jr;
        const bool valid = row < S && col < T_len && (!causal || col <= row + offset);
        float p;
        entry(qk[r], dp[r], lse_s[i_lane], dd_s[i_lane], valid, scale, softcap, p,
              ds_s[i_lane * PROW + jr]);
      }
    }
    __syncthreads();
    for (int jr = 0; jr < BK; ++jr) {
      const float ds = ds_s[i_own * PROW + jr];
      if constexpr (Tile::VEC) {
#pragma unroll
        for (int m = 0; m < DPR / 4; ++m) {
          const float4 k4 = ld4(k_s + jr * BROW + 4 * (sub + TPR * m));
          dq_acc[4 * m] = fmaf(ds, k4.x, dq_acc[4 * m]);
          dq_acc[4 * m + 1] = fmaf(ds, k4.y, dq_acc[4 * m + 1]);
          dq_acc[4 * m + 2] = fmaf(ds, k4.z, dq_acc[4 * m + 2]);
          dq_acc[4 * m + 3] = fmaf(ds, k4.w, dq_acc[4 * m + 3]);
        }
      } else {
#pragma unroll
        for (int m = 0; m < DPR; ++m)
          dq_acc[m] = fmaf(ds, k_s[jr * BROW + sub + TPR * m], dq_acc[m]);
      }
    }
  }
  const int row = q0 + i_own;
  if (row >= S) return;
  float* dqr = dq + b * dqs.b + h * dqs.h + row * dqs.s;
#pragma unroll
  for (int m = 0; m < DPR; ++m) {
    const int e = Tile::VEC ? 4 * (sub + TPR * (m / 4)) + m % 4 : sub + TPR * m;
    dqr[e] = dq_acc[m];
  }
}

struct BwdArgs {
  const float *q, *k, *v, *o, *lse, *dout;
  float *dd, *dq, *dk, *dv;
  int B, H, KV, S, T;
  Strides qs, ks, vs, os, dos, dqs, dks;
  float softcap;
  int causal;
};

template <int D>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const int64_t rows = static_cast<int64_t>(a.B) * a.H * a.S;
  const unsigned dot_blocks =
      static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
  flash_bwd_dot_kernel<<<dot_blocks, kThreads, 0, stream>>>(
      a.o, a.dout, a.dd, a.H, a.S, D, a.os, a.dos, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem = BwdTile<D>::smem();
  auto dkdv = flash_bwd_dkdv_kernel<D>;
  static bool dkdv_allowed = false;
  err = allow_smem(dkdv, smem, &dkdv_allowed);
  if (err != cudaSuccess) return err;
  constexpr int BK = BwdTile<D>::BK;
  dkdv<<<dim3((a.T + BK - 1) / BK, a.KV, a.B), kThreads, smem, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.dd, a.dk, a.dv, a.H, a.KV, a.S, a.T, a.qs,
      a.ks, a.vs, a.dos, a.dks, scale, a.softcap, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_kernel<D>;
  static bool dq_allowed = false;
  err = allow_smem(dqk, smem, &dq_allowed);
  if (err != cudaSuccess) return err;
  dqk<<<dim3((a.S + kBQ - 1) / kBQ, a.H, a.B), kThreads, smem, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.dd, a.dq, a.H, a.KV, a.S, a.T, a.qs, a.ks,
      a.vs, a.dos, a.dqs, scale, a.softcap, a.causal);
  return cudaGetLastError();
}

}  // namespace

// fp32 only.  q [B, H, S, d], k, v [B, KV, T, d], o and dout [B, H, S, d]
// through their (batch, head, sequence) element strides (head dim
// contiguous); lse and dd (scratch for D) fp32 [B, H, S] contiguous; dq
// written through dq's strides, dk and dv through one shared set of
// strides.  d is 16, 32, 64, 80, 128 or 256.  Three launches; returns the
// first failing launch's cudaError_t (0 on success).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dout, void* dd, void* dq, void* dk, void* dv, int B, int H, int KV,
    int S, int T_len, int d, int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
    int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t o_sb, int64_t o_sh, int64_t o_ss, int64_t do_sb, int64_t do_sh,
    int64_t do_ss, int64_t dq_sb, int64_t dq_sh, int64_t dq_ss, int64_t dk_sb,
    int64_t dk_sh, int64_t dk_ss, float softcap, int causal, void* stream) {
  if (B < 1 || S < 1 || T_len < 1 || KV < 1 || H % KV != 0 ||
      (causal && T_len < S) || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(o),
                  static_cast<const float*>(lse), static_cast<const float*>(dout),
                  static_cast<float*>(dd), static_cast<float*>(dq),
                  static_cast<float*>(dk), static_cast<float*>(dv), B, H, KV, S,
                  T_len, Strides{q_sb, q_sh, q_ss}, Strides{k_sb, k_sh, k_ss},
                  Strides{v_sb, v_sh, v_ss}, Strides{o_sb, o_sh, o_ss},
                  Strides{do_sb, do_sh, do_ss}, Strides{dq_sb, dq_sh, dq_ss},
                  Strides{dk_sb, dk_sh, dk_ss}, softcap, causal};
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return static_cast<int>(launch_bwd<16>(a, s));
    case 32: return static_cast<int>(launch_bwd<32>(a, s));
    case 64: return static_cast<int>(launch_bwd<64>(a, s));
    case 80: return static_cast<int>(launch_bwd<80>(a, s));
    case 128: return static_cast<int>(launch_bwd<128>(a, s));
    case 256: return static_cast<int>(launch_bwd<256>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
