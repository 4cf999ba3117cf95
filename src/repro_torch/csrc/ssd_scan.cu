// Chunked scalar-decay SSD scan (Mamba2 prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan, body
// _kernel), and computes what the JAX mixer's chunked branch computes
// (src/repro/models/ssm.py, _ssd_chunked), the initial state included.
//
// What it computes: for every (batch b, head h) the linear recurrence
// h_t = exp(ld_t) h_{t-1} + x_t B_t^T, y_t = h_t C_t, in chunks of Q rows.
// With A the cumulative log decay inside a chunk,
//   y_i   = sum_{j <= i} (C_i . B_j) exp(A_i - A_j) x_j  +  exp(A_i) h_prev C_i
//   h_new = exp(A_tot) h_prev + sum_j exp(A_tot - A_j) x_j B_j^T
// xb [B, S, H, dh] fp32 (dt-scaled inputs, the mixer's layout), B and C
// [B, S, ds] fp32 or bf16 read through their (batch, row) strides (column
// slices of the conv output), log decays [B, S, H] fp32, an optional h0
// [B, H, dh, ds] fp32 (null: zeros).  Writes y [B, S, H, dh] and the final
// state [B, H, dh, ds], both fp32.  S is any length >= 1: the last chunk
// may be short, and its rows past S are neither read nor written.
//
// What bounds it on the H100: operations.  Per chunk of n rows, C_i . B_j
// over the n (n + 1) / 2 causal pairs is the same for every head; per head
// come the masked scores times x and the two state products, about
// n^2 dh + 4 n dh ds FLOPs against n (dh + ds) + dh ds fp32 values: ~1.0
// GFLOP for zamba2-2.7b at B = 1, S = 512 (Q = 128, H = 80, dh = ds = 64),
// 15 us at 67 TFLOP/s fp32, against 6.7 us for its 22.6 MB.
//
// What this design does about it: the TPU grid's sequential chunk axis,
// with the state in VMEM scratch across grid steps, becomes a loop inside
// one block.  Two launches on the caller's stream:
//   1. cb_kernel, one block per (32-row tile, chunk, batch): C B^T of the
//      chunk's causal pairs into an fp32 scratch [B][K][128][128], once for
//      all heads (each thread a 4 x 8 tile from float4 loads of C^T and B^T
//      staged in shared memory);
//   2. ssd_kernel, one block per (b, h, 32-row slice of dh), which keeps
//      its slice of the state in shared memory for the whole sequence (the
//      rows of h are independent along dh: zamba2 at B = 1 gets 2 x 80 =
//      160 blocks, two to an SM, one wave).  Per chunk it stages C and B
//      transposed ([ds][Q], fp32), its x slice and the cumulative log decays
//      (one warp scans them); every thread issues its batch of global loads
//      unconditionally (clamped rows) before storing any, so they are in
//      flight together.  It walks the chunk in tiles of 32 score rows: a
//      thread turns a 4 x 8 tile of C B^T into (C . B) exp(A_i - A_j), then
//      accumulates eight y values of one row over j <= i and over the
//      state; last, each thread updates sixteen state entries.
// About 110 KB of shared memory at ds = 64, set through
// cudaFuncSetAttribute.  All sums are fp32 in a fixed order with no
// atomics, so the same input gives the same bits (the layer-streamed
// prefill is compared with torch.equal).  The products run on the CUDA
// cores, so the kernel sits far above its bound; tensor cores (3xTF32
// for fp32 accuracy) are later work.

#include "attention_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kQMax = 128;          // rows of one chunk at most
constexpr int kQP = kQMax + 4;      // padded row of the transposed B / C tiles
constexpr int kDS = 32;             // state rows (along dh) per block
constexpr int kDPer = kDS / 4;      // y values (along dh) per thread
constexpr int kSThreads = kThreads / kDS;   // threads per state row
constexpr int kRT = 32;             // score rows per tile
constexpr int kBatch = 16;          // B / C loads in flight per thread

struct RowStrides {   // element strides of B or C over the (batch, row) axes
  int64_t b, s;
};

// Shared-memory layout in floats; every offset is a multiple of 4 floats,
// so the float4 accesses below are aligned.
template <int DSTATE>
struct Smem {
  static constexpr int ct = 0;                    // C^T [DSTATE][kQP]
  static constexpr int bt = ct + DSTATE * kQP;    // B^T [DSTATE][kQP]
  static constexpr int w = bt + DSTATE * kQP;     // scores [kRT][kQP]
  static constexpr int x = w + kRT * kQP;         // x slice [kQMax][kDS]
  static constexpr int h = x + kQMax * kDS;       // state^T [DSTATE][kDS]
  static constexpr int a = h + DSTATE * kDS;      // A_i
  static constexpr int ea = a + kQMax;            // exp(A_i)
  static constexpr int er = ea + kQMax;           // exp(A_tot - A_j)
  static constexpr int total = er + kQMax;
};

// C B^T of one chunk, the part that is the same for every head: block
// (row tile, chunk, batch) computes rows r0 .. r0 + 31 of the chunk's
// scores C_i . B_j for j <= i into cb[b][k][i][j] (row stride kQMax); each
// thread forms a 4 x 8 tile from float4 loads of C^T and B^T staged in
// shared memory.  Rows past the chunk's length are computed from zeros.
template <int DSTATE>
struct CbSmem {
  static constexpr int cp = kRT + 4;              // padded row of C^T
  static constexpr int ct = 0;                    // C^T [DSTATE][cp]
  static constexpr int bt = ct + DSTATE * cp;     // B^T [DSTATE][kQP]
  static constexpr int total = bt + DSTATE * kQP;
};

template <typename T, int DSTATE>
__global__ void __launch_bounds__(kThreads)
cb_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
          float* __restrict__ cb, int S, int Q, int K, RowStrides bs,
          RowStrides cs) {
  using L = CbSmem<DSTATE>;
  extern __shared__ __align__(16) float smem[];
  float* ct = smem + L::ct;
  float* bt = smem + L::bt;
  const int r0 = blockIdx.x * kRT;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int c0 = k * Q;
  const int n = min(Q, S - c0);
  if (r0 >= n) return;                 // uniform over the block
  const int ncols = min(r0 + kRT, n);  // columns j <= i < ncols are needed
  const T* Bb = Bm + b * bs.b;
  const T* Cb = Cm + b * cs.b;

  // unconditional loads at clamped rows, a batch in flight per thread
  for (int base = 0; base < kRT * DSTATE; base += kThreads * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int idx = min(base + t + q * kThreads, kRT * DSTATE - 1);
      const int i = idx / DSTATE, s = idx % DSTATE;
      v[q] = to_f32(Cb[static_cast<int64_t>(c0 + min(r0 + i, n - 1)) * cs.s + s]);
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int idx = base + t + q * kThreads;
      const int i = idx / DSTATE, s = idx % DSTATE;
      if (idx < kRT * DSTATE) ct[s * L::cp + i] = r0 + i < n ? v[q] : 0.f;
    }
  }
  for (int base = 0; base < ncols * DSTATE; base += kThreads * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int idx = min(base + t + q * kThreads, ncols * DSTATE - 1);
      const int j = idx / DSTATE, s = idx % DSTATE;
      v[q] = to_f32(Bb[static_cast<int64_t>(c0 + j) * bs.s + s]);
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int idx = base + t + q * kThreads;
      const int j = idx / DSTATE, s = idx % DSTATE;
      if (idx < ncols * DSTATE) bt[s * kQP + j] = v[q];
    }
  }
  __syncthreads();

  const int ti = t / 16, tj = t % 16;  // 8 x 16 tiles of 4 x 8
  const int i0 = 4 * ti, j0 = 8 * tj;
  if (j0 > r0 + i0 + 3 || j0 >= ncols) return;   // wholly above the diagonal
  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
#pragma unroll 4
  for (int s = 0; s < DSTATE; ++s) {
    const float4 c = *reinterpret_cast<const float4*>(ct + s * L::cp + i0);
    const float4 b0 = *reinterpret_cast<const float4*>(bt + s * kQP + j0);
    const float4 b1 = *reinterpret_cast<const float4*>(bt + s * kQP + j0 + 4);
    const float cr[4] = {c.x, c.y, c.z, c.w};
    const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] += cr[r] * br[q];
  }
  float* dst = cb + ((static_cast<int64_t>(b) * K + k) * kQMax + r0 + i0) * kQMax + j0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float4* row = reinterpret_cast<float4*>(dst + r * kQMax);
    row[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    row[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
}

template <typename T, int DSTATE>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ xb, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ ld,
           const float* __restrict__ h0, const float* __restrict__ cb,
           float* __restrict__ y, float* __restrict__ h_out, int S, int H,
           int dh, int Q, int K, RowStrides bs, RowStrides cs) {
  using L = Smem<DSTATE>;
  extern __shared__ __align__(16) float smem[];
  float* ct = smem + L::ct;
  float* bt = smem + L::bt;
  float* w = smem + L::w;
  float* xs = smem + L::x;
  float* hT = smem + L::h;
  float* A = smem + L::a;
  float* eA = smem + L::ea;
  float* eR = smem + L::er;

  const int d0 = blockIdx.x * kDS;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int64_t xrow = static_cast<int64_t>(H) * dh;       // x / y row stride
  const int64_t state0 = (static_cast<int64_t>(b) * H + hh) * dh + d0;

  for (int idx = t; idx < kDS * DSTATE; idx += kThreads) {
    const int d = idx / DSTATE, s = idx % DSTATE;
    hT[s * kDS + d] = h0 ? h0[(state0 + d) * DSTATE + s] : 0.f;
  }

  const float* xbase = xb + static_cast<int64_t>(b) * S * xrow + hh * dh + d0;
  float* ybase = y + static_cast<int64_t>(b) * S * xrow + hh * dh + d0;
  const float* ldb = ld + static_cast<int64_t>(b) * S * H + hh;
  const T* Bb = Bm + b * bs.b;
  const T* Cb = Cm + b * cs.b;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int n = min(Q, S - c0);
    const float* cbk = cb + (static_cast<int64_t>(b) * K + c0 / Q) * kQMax * kQMax;
    __syncthreads();                   // the previous chunk is consumed
    // Staging: each thread issues a batch of unconditional global loads
    // (rows past n read the last row again and stage zeros) before it
    // stores any of them, so the whole batch is in flight at once.
    for (int k0 = 0; k0 < kQMax * DSTATE / kThreads; k0 += kBatch) {
      float cv[kBatch], bv[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int idx = t + (k0 + k) * kThreads;
        const int i = idx / DSTATE, s = idx % DSTATE;
        const int64_t row = c0 + min(i, n - 1);
        const float c = to_f32(Cb[row * cs.s + s]);
        const float bb = to_f32(Bb[row * bs.s + s]);
        cv[k] = i < n ? c : 0.f;
        bv[k] = i < n ? bb : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int idx = t + (k0 + k) * kThreads;
        const int i = idx / DSTATE, s = idx % DSTATE;
        ct[s * kQP + i] = cv[k];
        bt[s * kQP + i] = bv[k];
      }
    }
    {
      constexpr int kPer = kQMax * (kDS / 4) / kThreads;
      float4 v[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int idx = t + k * kThreads;
        const int i = idx / (kDS / 4), q = idx % (kDS / 4);
        const float4 r = *reinterpret_cast<const float4*>(
            xbase + (c0 + min(i, n - 1)) * xrow + 4 * q);
        v[k] = i < n ? r : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) reinterpret_cast<float4*>(xs)[t + k * kThreads] = v[k];
    }
    if (t < 32) {
      // inclusive scan of the chunk's log decays: each lane sums four
      // consecutive rows, then the lanes scan; rows past n add zero
      float v[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * t + k;
        const float l = ldb[static_cast<int64_t>(c0 + min(i, n - 1)) * H];
        v[k] = i < n ? l : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        run += v[k];
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, o);
        if (t >= o) incl += up;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (t == 0) excl = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) A[4 * t + k] = excl + v[k];
      __syncwarp();
      const float atot = A[n - 1];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * t + k;
        eA[i] = expf(A[i]);
        eR[i] = expf(atot - A[i]);
      }
    }
    __syncthreads();
    const float etot = expf(A[n - 1]);

    for (int r0 = 0; r0 < n; r0 += kRT) {
      {  // scores: w[i - r0][j] = (C_i . B_j) exp(A_i - A_j), j <= i
        const int ti = t / 16, tj = t % 16;     // 8 x 16 tiles of 4 x 8
        const int i0 = r0 + 4 * ti, j0 = 8 * tj;
        if (j0 <= i0 + 3) {                     // not wholly above the diagonal
          float acc[4][8];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float4* src =
                reinterpret_cast<const float4*>(cbk + (i0 + r) * kQMax + j0);
            const float4 a = src[0], c = src[1];
            acc[r][0] = a.x; acc[r][1] = a.y; acc[r][2] = a.z; acc[r][3] = a.w;
            acc[r][4] = c.x; acc[r][5] = c.y; acc[r][6] = c.z; acc[r][7] = c.w;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + r;
            float o[8];
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              const int j = j0 + q;
              o[q] = j <= i ? acc[r][q] * expf(A[i] - A[j]) : 0.f;
            }
            float4* dst = reinterpret_cast<float4*>(w + (4 * ti + r) * kQP + j0);
            dst[0] = make_float4(o[0], o[1], o[2], o[3]);
            dst[1] = make_float4(o[4], o[5], o[6], o[7]);
          }
        }
      }
      __syncthreads();
      {  // y for rows r0 .. r0 + 31: kDPer consecutive d per thread
        const int i = r0 + t / 4;
        const int dq = kDPer * (t % 4);
        if (i < n) {
          const float* wr = w + (t / 4) * kQP;
          float acc[kDPer], inter[kDPer];
#pragma unroll
          for (int v = 0; v < kDPer; ++v) acc[v] = inter[v] = 0.f;
#pragma unroll 4
          for (int j = 0; j <= i; ++j) {
            const float wij = wr[j];
#pragma unroll
            for (int v = 0; v < kDPer; v += 4) {
              const float4 xv = *reinterpret_cast<const float4*>(xs + j * kDS + dq + v);
              acc[v] += wij * xv.x;
              acc[v + 1] += wij * xv.y;
              acc[v + 2] += wij * xv.z;
              acc[v + 3] += wij * xv.w;
            }
          }
#pragma unroll 8
          for (int s = 0; s < DSTATE; ++s) {
            const float c = ct[s * kQP + i];
#pragma unroll
            for (int v = 0; v < kDPer; v += 4) {
              const float4 hv = *reinterpret_cast<const float4*>(hT + s * kDS + dq + v);
              inter[v] += c * hv.x;
              inter[v + 1] += c * hv.y;
              inter[v + 2] += c * hv.z;
              inter[v + 3] += c * hv.w;
            }
          }
          const float e = eA[i];
          float4* dst = reinterpret_cast<float4*>(ybase + (c0 + i) * xrow + dq);
#pragma unroll
          for (int v = 0; v < kDPer; v += 4)
            dst[v / 4] = make_float4(acc[v] + e * inter[v], acc[v + 1] + e * inter[v + 1],
                                     acc[v + 2] + e * inter[v + 2],
                                     acc[v + 3] + e * inter[v + 3]);
        }
      }
      __syncthreads();                 // w is rewritten by the next tile
    }

    {  // state: h[d][s] = exp(A_tot) h[d][s] + sum_j x_j[d] exp(A_tot - A_j) B_j[s]
      constexpr int NS = DSTATE / kSThreads;
      const int d = t / kSThreads, s_lo = t % kSThreads;   // s = s_lo + kSThreads k
      float acc[NS];
#pragma unroll
      for (int k = 0; k < NS; ++k)
        acc[k] = etot * hT[(s_lo + kSThreads * k) * kDS + d];
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const float xv = xs[j * kDS + d] * eR[j];
#pragma unroll
        for (int k = 0; k < NS; ++k)
          acc[k] += xv * bt[(s_lo + kSThreads * k) * kQP + j];
      }
#pragma unroll
      for (int k = 0; k < NS; ++k) hT[(s_lo + kSThreads * k) * kDS + d] = acc[k];
    }
  }

  __syncthreads();
  for (int idx = t; idx < kDS * DSTATE; idx += kThreads) {
    const int d = idx / DSTATE, s = idx % DSTATE;
    h_out[(state0 + d) * DSTATE + s] = hT[s * kDS + d];
  }
}

template <typename T, int DSTATE>
cudaError_t launch_state(const void* xb, const void* Bm, const void* Cm,
                         const void* ld, const void* h0, void* cb, void* y,
                         void* h_out, int B, int S, int H, int dh, int Q,
                         RowStrides bs, RowStrides cs, cudaStream_t stream) {
  static_assert(kThreads == kDS * kSThreads && kThreads == 4 * kRT &&
                    kDPer % 4 == 0, "thread maps");
  static_assert(DSTATE % kSThreads == 0 &&
                    (kQMax * DSTATE / kThreads) % kBatch == 0, "state width");
  const int smem_cb = static_cast<int>(sizeof(float) * CbSmem<DSTATE>::total);
  const int smem = static_cast<int>(sizeof(float) * Smem<DSTATE>::total);
  auto cb_k = cb_kernel<T, DSTATE>;
  auto scan_k = ssd_kernel<T, DSTATE>;
  static bool configured = false;      // one attribute call per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        cb_k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_cb);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          scan_k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int K = (S + Q - 1) / Q;
  cb_k<<<dim3(kQMax / kRT, K, B), kThreads, smem_cb, stream>>>(
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<float*>(cb), S, Q, K, bs, cs);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_k<<<dim3(dh / kDS, H, B), kThreads, smem, stream>>>(
      static_cast<const float*>(xb), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(ld),
      static_cast<const float*>(h0), static_cast<const float*>(cb),
      static_cast<float*>(y), static_cast<float*>(h_out), S, H, dh, Q, K, bs,
      cs);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* xb, const void* Bm, const void* Cm,
                         const void* ld, const void* h0, void* cb, void* y,
                         void* h_out, int B, int S, int H, int dh, int ds, int Q,
                         RowStrides bs, RowStrides cs, cudaStream_t stream) {
  switch (ds) {
#define REPRO_SSD_STATE(DS)                                                      \
  case DS:                                                                       \
    return launch_state<T, DS>(xb, Bm, Cm, ld, h0, cb, y, h_out, B, S, H, dh, \
                               Q, bs, cs, stream);
    REPRO_SSD_STATE(16)
    REPRO_SSD_STATE(32)
    REPRO_SSD_STATE(64)
    REPRO_SSD_STATE(128)
#undef REPRO_SSD_STATE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes (of B and C): 0 = float32, 1 = bfloat16.  xb, ld, h0 (may be
// null), y and h_out are contiguous fp32; cb is fp32 scratch of
// B * ceil(S / Q) * 128 * 128 floats; B and C strides are in elements over
// their (batch, row) axes, the state axis contiguous.  ds is 16, 32, 64 or
// 128; dh a multiple of 32; 1 <= Q <= 128.  Two launches on the stream
// (C B^T per chunk, then the scan).
// Returns the launches' cudaError_t (0 on success).
extern "C" int repro_ssd_scan(const void* xb, const void* Bm, const void* Cm,
                              const void* ld, const void* h0, void* cb, void* y,
                              void* h_out, int B, int S, int H, int dh, int ds,
                              int Q, int64_t b_sb, int64_t b_ss, int64_t c_sb,
                              int64_t c_ss, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || dh < kDS || dh % kDS != 0 || Q < 1 ||
      Q > kQMax || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const RowStrides bs{b_sb, b_ss}, cs{c_sb, c_ss};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = launch_typed<float>(xb, Bm, Cm, ld, h0, cb, y, h_out, B, S, H, dh, ds,
                              Q, bs, cs, s);
  else if (dtype == 1)
    err = launch_typed<__nv_bfloat16>(xb, Bm, Cm, ld, h0, cb, y, h_out, B, S, H,
                                      dh, ds, Q, bs, cs, s);
  return static_cast<int>(err);
}
