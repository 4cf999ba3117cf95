// Row RMSNorm backward for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py (rmsnorm) in
// training: the gradient of its port, csrc/rmsnorm.cu.  The JAX package
// has no backward kernel (its models take jax.value_and_grad of plain jnp
// norms); the port's forward runs the hand-written kernel on the card, so
// its gradient is a kernel too.
//
// What it computes: for every row of the normalised input x [rows, d]
// (the residual form's sum s = x + r), with the forward's rstd =
// rsqrt(mean(x^2) + eps), x^ = x * rstd and g = scale * dy,
//   dx = rstd * (g - x^ * mean(x^ * g))  (+ d_sum, the gradient arriving at
//        the residual form's second output; dx is then the gradient of
//        both x and r),
//   dscale = sum over rows of dy * x^.
// fp32 in and out.
//
// What bounds it on the H100: bytes.  About 8 operations per element
// against x, dy (and d_sum) read and dx written, 12 to 16 bytes per
// element; the least time is those bytes over 3.35 TB/s.
//
// What this design does about it, simply:
//   1. dx: one warp per row for d <= 1024, one block of 8 warps per row
//      above; each thread walks its columns twice (the row sum, then dx),
//      reading x through the forward's row stride (q_norm and k_norm rows
//      of a head view, MLA's latent rows inside a wider row) and dy, d_sum
//      and dx contiguous.  The row sum is a shuffle butterfly (and the
//      warps' partials added in warp order), so a row's bits do not depend
//      on the row count;
//   2. dscale, without atomics: one thread per column sums dy * x * rstd
//      over a fixed chunk of 64 rows into a partial row [chunks, d] (the
//      chunks on grid x, so any row count up to 2^31 - 1 launches);
//   3. a second pass adds the chunks' partials per column in chunk order,
//      compensated (Kahan), so its error does not grow with the row count.
// So dscale's bits are the same run to run, as a resumed training run
// needs.
//
// The split-row form (repro_rmsnorm_bwd_split_dot, then
// repro_rmsnorm_bwd_split) is the gradient of csrc/rmsnorm.cu's split-row
// form, for a row that tensor parallelism cuts over ranks (Mamba2's gated
// norm, the mLSTM's and the sLSTM's norms).  The row sum mean(x^ * g)
// spans the whole row, so it is split around the caller's sum over the
// ranks: the first launch writes each row's fp32 dot of (scale * dy) and x
// over the rank's slice [rows] (one warp or block per row, the same
// reduction as step 1), the caller adds the ranks' dots (one all_reduce of
// 4 bytes per row), and the second launch forms the slice's
// dx = rstd * (g - x * rstd^2 * dot / d_global) from the forward's rstd
// (the rsqrt of the reduced sums, which the forward's second launch
// wrote) and then the slice's dscale by steps 2 and 3.  Bound: bytes, as
// above, x and dy read twice (once per launch).

#include "attention_common.cuh"

namespace {

constexpr int kWarpRows = 4;       // rows (warps) per block in warp mode
constexpr int kBlockWarps = 8;     // warps per block in block mode
constexpr int kWarpModeMaxD = 1024;
constexpr int kChunkRows = 64;     // rows per dscale partial (kernels/rmsnorm.py)
constexpr int kColThreads = 256;   // columns per block of the dscale passes

template <bool BLOCK_ROW>
__device__ __forceinline__ float row_sum(float v) {
  v = warp_sum(v);
  if constexpr (BLOCK_ROW) {
    __shared__ float part[kBlockWarps];
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) part[warp] = v;
    __syncthreads();
    v = 0.f;
#pragma unroll
    for (int w = 0; w < kBlockWarps; ++w) v += part[w];
  }
  return v;
}

// SPLIT 0: the whole row (mean from this row's sum); 1: the split-row
// form's first launch (each row's dot of scale * dy and x into dots, and
// nothing else); 2: its second launch (the mean from the ranks' dots over
// d_global).
template <bool BLOCK_ROW, int SPLIT>
__global__ void __launch_bounds__(BLOCK_ROW ? kBlockWarps * 32 : kWarpRows * 32)
rmsnorm_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ dy, const float* __restrict__ d_sum,
                      const float* __restrict__ rstd, float* __restrict__ dx,
                      float* __restrict__ dots, int64_t rows, int d, int d_global,
                      int64_t x_stride) {
  constexpr int kRowThreads = BLOCK_ROW ? kBlockWarps * 32 : 32;
  const int64_t row = BLOCK_ROW ? static_cast<int64_t>(blockIdx.x)
                                : static_cast<int64_t>(blockIdx.x) * kWarpRows +
                                      (threadIdx.x >> 5);
  if (row >= rows) return;          // uniform over the warp (and the block)
  const int tid = BLOCK_ROW ? threadIdx.x : (threadIdx.x & 31);
  const float* xr = x + row * x_stride;
  const float* dyr = dy + row * static_cast<int64_t>(d);
  if constexpr (SPLIT == 1) {
    float acc = 0.f;
    for (int c = tid; c < d; c += kRowThreads) acc = fmaf(xr[c], scale[c] * dyr[c], acc);
    acc = row_sum<BLOCK_ROW>(acc);
    if (tid == 0) dots[row] = acc;
    return;
  }
  const float rs = rstd[row];
  float mean;
  if constexpr (SPLIT == 2) {
    mean = rs * dots[row] / static_cast<float>(d_global);
  } else {
    float acc = 0.f;
    for (int c = tid; c < d; c += kRowThreads)
      acc = fmaf(xr[c] * rs, scale[c] * dyr[c], acc);
    mean = row_sum<BLOCK_ROW>(acc) / static_cast<float>(d);
  }
  float* dxr = dx + row * static_cast<int64_t>(d);
  const float* dsr = d_sum == nullptr ? nullptr : d_sum + row * static_cast<int64_t>(d);
  for (int c = tid; c < d; c += kRowThreads) {
    float v = rs * (scale[c] * dyr[c] - xr[c] * rs * mean);
    if (dsr != nullptr) v += dsr[c];
    dxr[c] = v;
  }
}

__global__ void __launch_bounds__(kColThreads)
rmsnorm_bwd_partial_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                           const float* __restrict__ rstd, float* __restrict__ partial,
                           int64_t rows, int d, int64_t x_stride) {
  // chunks on grid x (up to 2^31 - 1 of them), column blocks on grid y
  const int col = blockIdx.y * kColThreads + threadIdx.x;
  if (col >= d) return;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kChunkRows;
  const int64_t r1 = r0 + kChunkRows < rows ? r0 + kChunkRows : rows;
  float acc = 0.f;
  for (int64_t r = r0; r < r1; ++r)
    acc = fmaf(dy[r * d + col], x[r * x_stride + col] * rstd[r], acc);
  partial[static_cast<int64_t>(blockIdx.x) * d + col] = acc;
}

__global__ void __launch_bounds__(kColThreads)
rmsnorm_bwd_dscale_kernel(const float* __restrict__ partial, float* __restrict__ dscale,
                          int chunks, int d) {
  const int col = blockIdx.x * kColThreads + threadIdx.x;
  if (col >= d) return;
  // compensated (Kahan) sum, so millions of rows lose no more than a few
  // of them would; no multiply, so nothing contracts into an FMA
  float acc = 0.f, lost = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const float y = partial[static_cast<int64_t>(c) * d + col] - lost;
    const float t = acc + y;
    lost = (t - acc) - y;
    acc = t;
  }
  dscale[col] = acc;
}

// Step 1 (SPLIT 0 or 2: dx; 1: the dots) over every row.
template <int SPLIT>
cudaError_t launch_rows(const float* x, const float* scale, const float* dy,
                        const float* d_sum, const float* rstd, float* dx, float* dots,
                        int64_t rows, int d, int d_global, int64_t x_stride,
                        cudaStream_t st) {
  if (d <= kWarpModeMaxD) {
    const unsigned blocks = static_cast<unsigned>((rows + kWarpRows - 1) / kWarpRows);
    rmsnorm_bwd_dx_kernel<false, SPLIT><<<blocks, kWarpRows * 32, 0, st>>>(
        x, scale, dy, d_sum, rstd, dx, dots, rows, d, d_global, x_stride);
  } else {
    rmsnorm_bwd_dx_kernel<true, SPLIT>
        <<<static_cast<unsigned>(rows), kBlockWarps * 32, 0, st>>>(
            x, scale, dy, d_sum, rstd, dx, dots, rows, d, d_global, x_stride);
  }
  return cudaGetLastError();
}

// Steps 2 and 3: dscale from dy, x and rstd in a fixed order.
cudaError_t launch_dscale(const float* x, const float* dy, const float* rstd,
                          float* dscale, float* partial, int64_t rows, int d,
                          int64_t x_stride, cudaStream_t st) {
  const int chunks = static_cast<int>((rows + kChunkRows - 1) / kChunkRows);
  const unsigned col_blocks = static_cast<unsigned>((d + kColThreads - 1) / kColThreads);
  rmsnorm_bwd_partial_kernel<<<dim3(chunks, col_blocks), kColThreads, 0, st>>>(
      x, dy, rstd, partial, rows, d, x_stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_dscale_kernel<<<col_blocks, kColThreads, 0, st>>>(partial, dscale, chunks, d);
  return cudaGetLastError();
}

bool bad_shape(int64_t rows, int d, int64_t x_stride) {
  return rows < 1 || rows > 0x7fffffffLL || d < 1 || d > 65535 * kColThreads ||
         x_stride < d;
}

}  // namespace

// fp32 only.  x [rows, d] through its row stride (last axis contiguous);
// scale [d]; dy, d_sum (may be null) and dx [rows, d] contiguous; rstd
// [rows]; dscale [d]; partial scratch of ceil(rows / 64) x d floats.
// Returns the first failing launch's cudaError_t (0 on success).
extern "C" int repro_rmsnorm_bwd(const void* x, const void* scale, const void* dy,
                                 const void* d_sum, const void* rstd, void* dx,
                                 void* dscale, void* partial, int64_t rows, int d,
                                 int64_t x_stride, void* stream) {
  if (bad_shape(rows, d, x_stride) || dscale == nullptr || partial == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* dyp = static_cast<const float*>(dy);
  const auto* rp = static_cast<const float*>(rstd);
  cudaError_t err = launch_rows<0>(xp, static_cast<const float*>(scale), dyp,
                                   static_cast<const float*>(d_sum), rp,
                                   static_cast<float*>(dx), nullptr, rows, d, d, x_stride, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_dscale(xp, dyp, rp, static_cast<float*>(dscale),
                                        static_cast<float*>(partial), rows, d, x_stride,
                                        st));
}

// The split-row form, first launch: dots[row] = the fp32 dot of scale * dy
// and x over row `row` of the rank's slice x [rows, d] (scale [d] its
// slice of the scale; dy [rows, d] contiguous).
extern "C" int repro_rmsnorm_bwd_split_dot(const void* x, const void* scale,
                                           const void* dy, void* dots, int64_t rows,
                                           int d, int64_t x_stride, void* stream) {
  if (bad_shape(rows, d, x_stride) || dots == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_rows<1>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(dy), nullptr, nullptr, nullptr, static_cast<float*>(dots),
      rows, d, d, x_stride, static_cast<cudaStream_t>(stream)));
}

// The split-row form, second launch: the slice's dx [rows, d] and dscale
// [d] from dots (the ranks' total per row) and rstd (the forward's, from
// the reduced sums), over rows of d_global; partial as repro_rmsnorm_bwd.
extern "C" int repro_rmsnorm_bwd_split(const void* x, const void* scale, const void* dy,
                                       const void* dots, const void* rstd, void* dx,
                                       void* dscale, void* partial, int64_t rows, int d,
                                       int d_global, int64_t x_stride, void* stream) {
  if (bad_shape(rows, d, x_stride) || d_global < d || dscale == nullptr ||
      partial == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* dyp = static_cast<const float*>(dy);
  const auto* rp = static_cast<const float*>(rstd);
  cudaError_t err = launch_rows<2>(xp, static_cast<const float*>(scale), dyp, nullptr, rp,
                                   static_cast<float*>(dx),
                                   const_cast<float*>(static_cast<const float*>(dots)),
                                   rows, d, d_global, x_stride, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_dscale(xp, dyp, rp, static_cast<float*>(dscale),
                                        static_cast<float*>(partial), rows, d, x_stride,
                                        st));
}
