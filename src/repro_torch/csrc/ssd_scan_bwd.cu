// Backward of the chunked scalar-decay SSD scan (Mamba2 training) for
// Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan) in
// training: the gradient of its port, csrc/ssd_scan.cu.  The JAX package
// has no backward kernel (its models take jax.grad of the plain
// _ssd_chunked, src/repro/models/ssm.py); the port's forward runs the
// hand-written kernel on the card, so its gradient is a kernel too.
//
// What it computes: for every (batch b, head h) the gradients of
// h_t = exp(ld_t) h_{t-1} + x_t B_t^T, y_t = h_t C_t (h_{-1} = h0 or 0)
// given dy [B, S, H, dh] and an optional dh_final [B, H, dh, ds]:
// dxb [B, S, H, dh], dB and dC [B, S, ds] (B and C are shared by every
// head: sums over heads), dld [B, S, H] and dh0 [B, H, dh, ds].  It walks
// chunks of its own, kChunk = 16 rows (the forward's chunk does not
// matter to the gradient).  Per chunk of n rows, with A the chunk's
// cumulative log decays, S_k the state entering chunk k and G_k the
// gradient at the state leaving it (both recomputed here by a scan over
// the chunks), e_j = exp(A_tot - A_j) and
//   W_ij = (C_i . B_j) exp(A_i - A_j),  V_ij = (dy_i . x_j) exp(A_i - A_j),
//   j <= i:
//   dx_j = sum_i W_ij dy_i + e_j G_k B_j,
//   dB_j = sum_h [sum_i V_ij C_i + e_j G_k^T x_j],
//   dC_i = sum_h [sum_j V_ij B_j + exp(A_i) S_k^T dy_i],
//   G_{k-1} = exp(A_tot) G_k + sum_i exp(A_i) dy_i C_i^T,  dh0 = G_{-1},
//   dld_t = exp(ld_t) <gh_t, h_{t-1}> (gh_t the gradient at h_t)
//         = sum_{i >= t > j} W_ij (dy_i . x_j) + sum_{i >= t} exp(A_i) dy_i . S_k C_i
//           + sum_{j < t} e_j x_j . G_k B_j + exp(A_tot) <G_k, S_k>.
// The last form keeps the log decays' gradient as accurate as the
// sequential backward: it sums only terms that cross row t, where
// writing dld as a reverse cumulative sum of dy_t . y_t - x_t . dx_t
// (the same value) would subtract large sums and lose ~30 times more
// (measured in fp32 on zamba2-2.7b's inputs against fp64: 4e-6 to 1e-5
// of the largest at 128-row chunks, 3e-7 to 6e-7 at 16).
// S is any length >= 1 (the last chunk may be short); B and C are read
// through their (batch, row) strides (column slices of the conv output).
//
// What bounds it on the H100: bytes.  It must read xb and dy [B, S, H,
// dh], B, C and the log decays, and write dxb, dB, dC and dld: about 64
// MB at zamba2-2.7b's training shapes (B = 8, S = 128, H = 80, dh = ds =
// 64), 19 us over 3.35 TB/s; its products, ~3.7 GFLOP there, take 8 us
// at the TF32 tensor-core rate.  The chunk scan adds [B, S / 16, H, dh,
// ds] states and state gradients (84 MB each there, written and read
// once), which a design that kept them on chip would not move.
//
// What this design does about it, simply (a first version; speed is later
// work): four launches.
//   1. chunk_prep_kernel, one block per (chunk, head, batch): the chunk's
//      cumulative log decays A (each thread sums its own row's prefix in
//      row order), its state increment sum_j e_j x_j B_j^T and its
//      state-gradient increment sum_i exp(A_i) dy_i C_i^T [dh x ds], into
//      scratch;
//   2. pass_kernel, one thread per (batch, head, state entry): the states
//      forward over the chunks from h0 (or 0), storing S_k in slot k, and
//      the state gradients backward from dh_final (or 0), storing G_k in
//      slot k and dh0 at the end;
//   3. chunk_grad_kernel, one block per (chunk, head, batch), everything in
//      shared memory (x, dy, B, C rows, S_k and G_k, W and V): dx and dld
//      written, and the head's dB and dC into a scratch [B, S, H, ds];
//   4. reduce_heads_kernel: dB and dC summed over heads in head order.
// Every product is a block-wide fp32 GEMM on the CUDA cores (block_gemm:
// a 16 x 16 grid of threads, each a strided tile of rows and columns,
// fmaf over the inner index in order).  No atomics: every sum runs in an
// order fixed by the shapes, so the same inputs give the same bits on
// every run (a resumed training run equals the uninterrupted one).

#include "attention_common.cuh"

namespace {

constexpr int kThreads = 256;       // 16 x 16 for block_gemm
constexpr int kPassThreads = 128;
constexpr int kChunk = 16;          // rows per chunk of the backward
constexpr int kMaxWidth = 128;      // dh and ds at most
constexpr int kMaxSmem = 232448;    // the H100's opt-in shared memory per block

struct RowStrides {   // element strides of B or C over the (batch, row) axes
  int64_t b, s;
};

// out(r, c) = sum over k = 0 .. Kn - 1 of a(r, k) * b(c, k) (fmaf in k
// order) for r < R <= 16 RT and c < Cn <= 16 CT, handed to epi(r, c, v).
// Thread (ty, tx) of a 16 x 16 grid takes rows ty + 16 u and columns
// tx + 16 v.
template <int RT, int CT, typename FA, typename FB, typename FE>
__device__ __forceinline__ void block_gemm_t(int R, int Cn, int Kn, FA a, FB b, FE epi) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[RT][CT];
#pragma unroll
  for (int u = 0; u < RT; ++u)
#pragma unroll
    for (int v = 0; v < CT; ++v) acc[u][v] = 0.f;
  for (int k = 0; k < Kn; ++k) {
    float av[RT], bv[CT];
#pragma unroll
    for (int u = 0; u < RT; ++u) {
      const int r = ty + 16 * u;
      av[u] = r < R ? a(r, k) : 0.f;
    }
#pragma unroll
    for (int v = 0; v < CT; ++v) {
      const int c = tx + 16 * v;
      bv[v] = c < Cn ? b(c, k) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < RT; ++u)
#pragma unroll
      for (int v = 0; v < CT; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
  }
#pragma unroll
  for (int u = 0; u < RT; ++u)
#pragma unroll
    for (int v = 0; v < CT; ++v) {
      const int r = ty + 16 * u, c = tx + 16 * v;
      if (r < R && c < Cn) epi(r, c, acc[u][v]);
    }
}

// block_gemm_t over the chunk's rows (R <= 16) and Cn <= 128 columns.
template <typename FA, typename FB, typename FE>
__device__ __forceinline__ void gemm_rows(int R, int Cn, int Kn, FA a, FB b, FE epi) {
  if (Cn <= 16)
    block_gemm_t<1, 1>(R, Cn, Kn, a, b, epi);
  else if (Cn <= 64)
    block_gemm_t<1, 4>(R, Cn, Kn, a, b, epi);
  else
    block_gemm_t<1, 8>(R, Cn, Kn, a, b, epi);
}

// block_gemm_t over a [dh x ds] state (each <= 128).
template <typename FA, typename FB, typename FE>
__device__ __forceinline__ void gemm_state(int R, int Cn, int Kn, FA a, FB b, FE epi) {
  if (R <= 64 && Cn <= 64)
    block_gemm_t<4, 4>(R, Cn, Kn, a, b, epi);
  else
    block_gemm_t<8, 8>(R, Cn, Kn, a, b, epi);
}

// rows [0, n) of a [*, width] fp32 tile into shared memory (row stride ld)
__device__ __forceinline__ void stage(float* dst, int ld, const float* src, int64_t stride,
                                      int n, int width) {
  for (int idx = threadIdx.x; idx < n * width; idx += kThreads) {
    const int r = idx / width, c = idx % width;
    dst[r * ld + c] = src[r * stride + c];
  }
}

// Shared-memory rows are padded by one float, so the fragment reads of
// block_gemm (16 threads on 16 rows at one column) hit 16 banks.
struct Layout {
  int ldh, lds;
  __host__ __device__ Layout(int dh, int ds) : ldh(dh + 1), lds(ds + 1) {}
};

// The chunk's cumulative log decays: A_t = ld_0 + ... + ld_t in row order,
// each of the first n threads its own row.
__device__ __forceinline__ void chunk_decays(float* A, const float* __restrict__ ld,
                                             int64_t ld_row, int n) {
  if (threadIdx.x < n) {
    float run = 0.f;
    for (int i = 0; i <= static_cast<int>(threadIdx.x); ++i) run += ld[i * ld_row];
    A[threadIdx.x] = run;
  }
}

// ---------------------------------------------------------------------------
// 1. each chunk's decays and its state and state-gradient increments
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
chunk_prep_kernel(const float* __restrict__ xb, const float* __restrict__ Bm,
                  const float* __restrict__ Cm, const float* __restrict__ ld,
                  const float* __restrict__ dy, float* __restrict__ acum,
                  float* __restrict__ fstates, float* __restrict__ gstates, int S, int H,
                  int dh, int ds, int K, RowStrides bs, RowStrides cs) {
  extern __shared__ __align__(16) float sm[];
  const Layout L(dh, ds);
  float* xs = sm;                          // [kChunk][ldh]: e_j x_j
  float* dys = xs + kChunk * L.ldh;        // [kChunk][ldh]: exp(A_i) dy_i
  float* bsm = dys + kChunk * L.ldh;       // [kChunk][lds]
  float* csm = bsm + kChunk * L.lds;       // [kChunk][lds]
  float* A = csm + kChunk * L.lds;         // [kChunk]
  const int k = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int c0 = k * kChunk, n = min(kChunk, S - c0);
  const int64_t xrow = static_cast<int64_t>(H) * dh;
  const int64_t xoff = (static_cast<int64_t>(b) * S + c0) * xrow + hh * dh;
  chunk_decays(A, ld + (static_cast<int64_t>(b) * S + c0) * H + hh, H, n);
  stage(bsm, L.lds, Bm + b * bs.b + c0 * bs.s, bs.s, n, ds);
  stage(csm, L.lds, Cm + b * cs.b + c0 * cs.s, cs.s, n, ds);
  __syncthreads();
  if (threadIdx.x < n)
    acum[((static_cast<int64_t>(b) * H + hh) * K + k) * kChunk + threadIdx.x] = A[threadIdx.x];
  for (int idx = threadIdx.x; idx < n * dh; idx += kThreads) {
    const int i = idx / dh, d = idx % dh;
    xs[i * L.ldh + d] = xb[xoff + i * xrow + d] * expf(A[n - 1] - A[i]);
    dys[i * L.ldh + d] = dy[xoff + i * xrow + d] * expf(A[i]);
  }
  __syncthreads();
  const int64_t soff = ((static_cast<int64_t>(b) * K + k) * H + hh) * dh * ds;
  gemm_state(
      dh, ds, n, [&](int d, int j) { return xs[j * L.ldh + d]; },
      [&](int s, int j) { return bsm[j * L.lds + s]; },
      [&](int d, int s, float v) { fstates[soff + d * ds + s] = v; });
  gemm_state(
      dh, ds, n, [&](int d, int i) { return dys[i * L.ldh + d]; },
      [&](int s, int i) { return csm[i * L.lds + s]; },
      [&](int d, int s, float v) { gstates[soff + d * ds + s] = v; });
}

// ---------------------------------------------------------------------------
// 2. the scans over chunks, elementwise
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kPassThreads)
pass_kernel(float* __restrict__ fstates, float* __restrict__ gstates,
            const float* __restrict__ acum, const float* __restrict__ h0,
            const float* __restrict__ dh_final, float* __restrict__ dh0, int S, int H,
            int dhds, int K) {
  const int q = blockIdx.x * kPassThreads + threadIdx.x;
  if (q >= dhds) return;
  const int hh = blockIdx.y, b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * H + hh;
  auto slot = [&](float* base, int k) {
    return base + ((static_cast<int64_t>(b) * K + k) * H + hh) * dhds + q;
  };
  auto decay = [&](int k) {
    return expf(acum[(bh * K + k) * kChunk + min(kChunk, S - k * kChunk) - 1]);
  };
  float h = h0 ? h0[bh * dhds + q] : 0.f;
  for (int k = 0; k < K; ++k) {            // S_k: the state entering chunk k
    float* p = slot(fstates, k);
    const float inc = *p;
    *p = h;
    h = decay(k) * h + inc;
  }
  float g = dh_final ? dh_final[bh * dhds + q] : 0.f;
  for (int k = K - 1; k >= 0; --k) {       // G_k: the gradient at the state leaving it
    float* p = slot(gstates, k);
    const float inc = *p;
    *p = g;
    g = decay(k) * g + inc;
  }
  if (dh0) dh0[bh * dhds + q] = g;
}

// ---------------------------------------------------------------------------
// 3. the chunks' gradients
// ---------------------------------------------------------------------------

__host__ __device__ inline int grad_smem_floats(int dh, int ds) {
  const Layout L(dh, ds);
  return 3 * kChunk * L.ldh           // X, DY, Z (G B_j)
         + 3 * kChunk * L.lds         // B, C, U (S^T dy_i)
         + 2 * dh * L.lds             // G_k, S_k
         + 2 * kChunk * (kChunk + 1)  // W (then W o DX), V
         + 5 * kChunk                 // A, E, EA, inter, fut
         + kThreads;                  // <G, S> partials
}

__global__ void __launch_bounds__(kThreads)
chunk_grad_kernel(const float* __restrict__ xb, const float* __restrict__ Bm,
                  const float* __restrict__ Cm, const float* __restrict__ dy,
                  const float* __restrict__ acum, const float* __restrict__ fstates,
                  const float* __restrict__ gstates, float* __restrict__ dxb,
                  float* __restrict__ dld, float* __restrict__ dBp, float* __restrict__ dCp,
                  int S, int H, int dh, int ds, int K, RowStrides bs, RowStrides cs) {
  extern __shared__ __align__(16) float sm[];
  const Layout L(dh, ds);
  constexpr int lm = kChunk + 1;
  float* X = sm;                           // [kChunk][ldh]
  float* DY = X + kChunk * L.ldh;          // [kChunk][ldh]
  float* Z = DY + kChunk * L.ldh;          // [kChunk][ldh]: G B_j
  float* Bs = Z + kChunk * L.ldh;          // [kChunk][lds]
  float* Cs = Bs + kChunk * L.lds;         // [kChunk][lds]
  float* U = Cs + kChunk * L.lds;          // [kChunk][lds]: S^T dy_i
  float* Gs = U + kChunk * L.lds;          // [dh][lds]
  float* Ss = Gs + dh * L.lds;             // [dh][lds]
  float* W = Ss + dh * L.lds;              // [kChunk][lm]
  float* V = W + kChunk * lm;              // [kChunk][lm]
  float* A = V + kChunk * lm;              // [kChunk]
  float* E = A + kChunk;                   // exp(A_tot - A_j)
  float* EA = E + kChunk;                  // exp(A_i)
  float* inter = EA + kChunk;              // exp(A_i) dy_i . S C_i
  float* fut = inter + kChunk;             // e_j x_j . G B_j
  float* part = fut + kChunk;              // [kThreads]

  const int k = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x;
  const int c0 = k * kChunk, n = min(kChunk, S - c0);
  const int64_t xrow = static_cast<int64_t>(H) * dh;
  const int64_t xoff = (static_cast<int64_t>(b) * S + c0) * xrow + hh * dh;
  const int64_t soff = ((static_cast<int64_t>(b) * K + k) * H + hh) * dh * ds;
  const float* Ag = acum + ((static_cast<int64_t>(b) * H + hh) * K + k) * kChunk;
  if (t < n) {
    A[t] = Ag[t];
    E[t] = expf(Ag[n - 1] - Ag[t]);
    EA[t] = expf(Ag[t]);
  }
  stage(X, L.ldh, xb + xoff, xrow, n, dh);
  stage(DY, L.ldh, dy + xoff, xrow, n, dh);
  stage(Bs, L.lds, Bm + b * bs.b + c0 * bs.s, bs.s, n, ds);
  stage(Cs, L.lds, Cm + b * cs.b + c0 * cs.s, cs.s, n, ds);
  stage(Gs, L.lds, gstates + soff, ds, dh, ds);
  stage(Ss, L.lds, fstates + soff, ds, dh, ds);
  __syncthreads();

  // exp(A_tot) <G, S>: each thread its strided entries, then the partials
  // in thread order
  float acc = 0.f;
  for (int e = t; e < dh * ds; e += kThreads)
    acc = fmaf(Gs[(e / ds) * L.lds + e % ds], Ss[(e / ds) * L.lds + e % ds], acc);
  part[t] = acc;
  // W_ij = (C_i . B_j) exp(A_i - A_j), j <= i;  Z_j = G B_j;  U_i = S^T dy_i
  gemm_rows(
      n, n, ds, [&](int i, int s) { return Cs[i * L.lds + s]; },
      [&](int j, int s) { return Bs[j * L.lds + s]; },
      [&](int i, int j, float v) { W[i * lm + j] = j <= i ? v * expf(A[i] - A[j]) : 0.f; });
  gemm_rows(
      n, dh, ds, [&](int j, int s) { return Bs[j * L.lds + s]; },
      [&](int d, int s) { return Gs[d * L.lds + s]; },
      [&](int j, int d, float v) { Z[j * L.ldh + d] = v; });
  gemm_rows(
      n, ds, dh, [&](int i, int d) { return DY[i * L.ldh + d]; },
      [&](int s, int d) { return Ss[d * L.lds + s]; },
      [&](int i, int s, float v) { U[i * L.lds + s] = v; });
  __syncthreads();
  // dx_j = sum_i W_ij dy_i + e_j Z_j
  float* dxo = dxb + xoff;
  gemm_rows(
      n, dh, n, [&](int j, int i) { return W[i * lm + j]; },
      [&](int d, int i) { return DY[i * L.ldh + d]; },
      [&](int j, int d, float v) { dxo[j * xrow + d] = v + E[j] * Z[j * L.ldh + d]; });
  if (t < n) {                              // the state terms of dld
    float a = 0.f, c = 0.f;
    for (int d = 0; d < dh; ++d) a = fmaf(X[t * L.ldh + d], Z[t * L.ldh + d], a);
    for (int s2 = 0; s2 < ds; ++s2) c = fmaf(Cs[t * L.lds + s2], U[t * L.lds + s2], c);
    fut[t] = E[t] * a;
    inter[t] = EA[t] * c;
  }
  __syncthreads();
  // V_ij = (dy_i . x_j) exp(A_i - A_j), and W_ij becomes W_ij (dy_i . x_j)
  gemm_rows(
      n, n, dh, [&](int i, int d) { return DY[i * L.ldh + d]; },
      [&](int j, int d) { return X[j * L.ldh + d]; },
      [&](int i, int j, float v) {
        V[i * lm + j] = j <= i ? v * expf(A[i] - A[j]) : 0.f;
        W[i * lm + j] *= v;
      });
  __syncthreads();
  // this head's dB_j = sum_i V_ij C_i + e_j G^T x_j and
  // dC_i = sum_j V_ij B_j + exp(A_i) U_i
  const int64_t poff = ((static_cast<int64_t>(b) * S + c0) * H + hh) * ds;
  const int64_t prow = static_cast<int64_t>(H) * ds;
  gemm_rows(
      n, ds, n + dh,
      [&](int j, int q) { return q < n ? V[q * lm + j] : X[j * L.ldh + q - n] * E[j]; },
      [&](int s, int q) { return q < n ? Cs[q * L.lds + s] : Gs[(q - n) * L.lds + s]; },
      [&](int j, int s, float v) { dBp[poff + j * prow + s] = v; });
  gemm_rows(
      n, ds, n, [&](int i, int j) { return V[i * lm + j]; },
      [&](int s, int j) { return Bs[j * L.lds + s]; },
      [&](int i, int s, float v) { dCp[poff + i * prow + s] = v + EA[i] * U[i * L.lds + s]; });
  // dld_t = sum_{i >= t > j} W_ij (dy_i . x_j) + sum_{i >= t} inter_i
  //         + sum_{j < t} fut_j + exp(A_tot) <G, S>
  if (t < n) {
    float gs = 0.f;
    for (int r = 0; r < kThreads; ++r) gs += part[r];
    float v = expf(A[n - 1]) * gs;
    for (int i = t; i < n; ++i) {
      float row = 0.f;
      for (int j = 0; j < t; ++j) row += W[i * lm + j];
      v += row + inter[i];
    }
    for (int j = 0; j < t; ++j) v += fut[j];
    dld[(static_cast<int64_t>(b) * S + c0 + t) * H + hh] = v;
  }
}

// ---------------------------------------------------------------------------
// 4. dB and dC: the heads' partials summed in head order
// ---------------------------------------------------------------------------

__global__ void reduce_heads_kernel(const float* __restrict__ dBp,
                                    const float* __restrict__ dCp, float* __restrict__ dB,
                                    float* __restrict__ dC, int H, int ds) {
  const int64_t row = blockIdx.x;                  // b * S + t
  const int which = threadIdx.x / ds, s = threadIdx.x % ds;
  const float* p = (which == 0 ? dBp : dCp) + row * H * ds + s;
  float acc = 0.f;
  for (int h = 0; h < H; ++h) acc += p[h * ds];
  (which == 0 ? dB : dC)[row * ds + s] = acc;
}

}  // namespace

// fp32 only.  xb, dy, dxb [B, S, H, dh] contiguous; B and C [B, S, ds]
// through their (batch, row) strides in elements, the state axis
// contiguous; ld, dld [B, S, H]; h0 and dh_final (may be null) and dh0
// (null when there is no h0) [B, H, dh, ds]; dB, dC [B, S, ds]; scratch
// of B * H * K * 16 + 2 * B * K * H * dh * ds + 2 * B * S * H * ds floats
// (K = ceil(S / 16): the chunks' decays, states and state gradients, the
// heads' dB and dC).  dh and ds at most 128.  Four launches on the
// stream.  Returns the first failing launch's cudaError_t (0 on success).
extern "C" int repro_ssd_scan_bwd(const void* xb, const void* Bm, const void* Cm,
                                  const void* ld, const void* h0, const void* dy,
                                  const void* dh_final, void* scratch, void* dxb, void* dB,
                                  void* dC, void* dld, void* dh0, int B, int S, int H,
                                  int dh, int ds, int64_t b_sb, int64_t b_ss, int64_t c_sb,
                                  int64_t c_ss, void* stream) {
  if (B < 1 || S < 1 || H < 1 || dh < 1 || dh > kMaxWidth || ds < 1 || ds > kMaxWidth ||
      B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int smem_prep = 4 * (2 * kChunk * (dh + 1) + 2 * kChunk * (ds + 1) + kChunk);
  const int smem_grad = 4 * grad_smem_floats(dh, ds);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        chunk_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(chunk_grad_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int K = (S + kChunk - 1) / kChunk;
  const int64_t nstates = static_cast<int64_t>(B) * K * H * dh * ds;
  auto* acum = static_cast<float*>(scratch);
  float* fstates = acum + static_cast<int64_t>(B) * H * K * kChunk;
  float* gstates = fstates + nstates;
  float* dBp = gstates + nstates;
  float* dCp = dBp + static_cast<int64_t>(B) * S * H * ds;
  const RowStrides bs{b_sb, b_ss}, cs{c_sb, c_ss};
  const auto* x = static_cast<const float*>(xb);
  const auto* g = static_cast<const float*>(dy);
  const auto* bm = static_cast<const float*>(Bm);
  const auto* cm = static_cast<const float*>(Cm);

  const dim3 chunks(K, H, B);
  chunk_prep_kernel<<<chunks, kThreads, smem_prep, st>>>(
      x, bm, cm, static_cast<const float*>(ld), g, acum, fstates, gstates, S, H, dh, ds,
      K, bs, cs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dhds = dh * ds;
  pass_kernel<<<dim3((dhds + kPassThreads - 1) / kPassThreads, H, B), kPassThreads, 0,
                st>>>(fstates, gstates, acum, static_cast<const float*>(h0),
                      static_cast<const float*>(dh_final), static_cast<float*>(dh0), S, H,
                      dhds, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_grad_kernel<<<chunks, kThreads, smem_grad, st>>>(
      x, bm, cm, g, acum, fstates, gstates, static_cast<float*>(dxb),
      static_cast<float*>(dld), dBp, dCp, S, H, dh, ds, K, bs, cs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_heads_kernel<<<static_cast<unsigned>(static_cast<int64_t>(B) * S), 2 * ds, 0,
                        st>>>(dBp, dCp, static_cast<float*>(dB), static_cast<float*>(dC),
                              H, ds);
  return static_cast<int>(cudaGetLastError());
}
