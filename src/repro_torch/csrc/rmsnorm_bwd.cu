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

template <bool BLOCK_ROW>
__global__ void __launch_bounds__(BLOCK_ROW ? kBlockWarps * 32 : kWarpRows * 32)
rmsnorm_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ dy, const float* __restrict__ d_sum,
                      const float* __restrict__ rstd, float* __restrict__ dx,
                      int64_t rows, int d, int64_t x_stride) {
  constexpr int kRowThreads = BLOCK_ROW ? kBlockWarps * 32 : 32;
  const int64_t row = BLOCK_ROW ? static_cast<int64_t>(blockIdx.x)
                                : static_cast<int64_t>(blockIdx.x) * kWarpRows +
                                      (threadIdx.x >> 5);
  if (row >= rows) return;          // uniform over the warp (and the block)
  const int tid = BLOCK_ROW ? threadIdx.x : (threadIdx.x & 31);
  const float* xr = x + row * x_stride;
  const float* dyr = dy + row * static_cast<int64_t>(d);
  const float rs = rstd[row];
  float acc = 0.f;
  for (int c = tid; c < d; c += kRowThreads)
    acc = fmaf(xr[c] * rs, scale[c] * dyr[c], acc);
  const float mean = row_sum<BLOCK_ROW>(acc) / static_cast<float>(d);
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

}  // namespace

// fp32 only.  x [rows, d] through its row stride (last axis contiguous);
// scale [d]; dy, d_sum (may be null) and dx [rows, d] contiguous; rstd
// [rows]; dscale [d]; partial scratch of ceil(rows / 64) x d floats.
// Returns the first failing launch's cudaError_t (0 on success).
extern "C" int repro_rmsnorm_bwd(const void* x, const void* scale, const void* dy,
                                 const void* d_sum, const void* rstd, void* dx,
                                 void* dscale, void* partial, int64_t rows, int d,
                                 int64_t x_stride, void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || d < 1 || d > 65535 * kColThreads ||
      x_stride < d || dscale == nullptr || partial == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* sp = static_cast<const float*>(scale);
  const auto* dyp = static_cast<const float*>(dy);
  const auto* dsp = static_cast<const float*>(d_sum);
  const auto* rp = static_cast<const float*>(rstd);
  auto* dxp = static_cast<float*>(dx);
  if (d <= kWarpModeMaxD) {
    const unsigned blocks = static_cast<unsigned>((rows + kWarpRows - 1) / kWarpRows);
    rmsnorm_bwd_dx_kernel<false><<<blocks, kWarpRows * 32, 0, st>>>(
        xp, sp, dyp, dsp, rp, dxp, rows, d, x_stride);
  } else {
    rmsnorm_bwd_dx_kernel<true><<<static_cast<unsigned>(rows), kBlockWarps * 32, 0, st>>>(
        xp, sp, dyp, dsp, rp, dxp, rows, d, x_stride);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = static_cast<int>((rows + kChunkRows - 1) / kChunkRows);
  const unsigned col_blocks = static_cast<unsigned>((d + kColThreads - 1) / kColThreads);
  rmsnorm_bwd_partial_kernel<<<dim3(chunks, col_blocks), kColThreads, 0, st>>>(
      xp, dyp, rp, static_cast<float*>(partial), rows, d, x_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_bwd_dscale_kernel<<<col_blocks, kColThreads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dscale), chunks, d);
  return static_cast<int>(cudaGetLastError());
}
