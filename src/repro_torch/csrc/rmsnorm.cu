// Row RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py (rmsnorm, body
// _kernel).
//
// What it computes: for every row of x [rows, d] (fp32 or bf16), the fp32
// mean of squares, then y = x * rsqrt(mean + eps) * scale, with scale [d]
// (fp32 or bf16) promoted to fp32, written in x's dtype.  The model's
// pre-attention, pre-MLP, final and qk norms all call it.
//
// What bounds it on the H100: bytes.  It does ~4 operations per element
// against 4 (bf16) or 8 (fp32) bytes moved, so the least time is x read
// once, y written once and scale read once over 3.35 TB/s: 19.6 KB, or
// about 6 ns, for smollm-135m's decode rows (8 x 576 bf16).  At serving
// shapes the kernel therefore sits at launch latency; what it saves is
// the eight other launches and intermediate tensors of the unfused
// sequence (cast, square, mean, add, rsqrt, two multiplies, cast back).
//
// What this design does about it: one warp per row for d <= 1024 (smollm's
// 576, head norms of 64-128), one block of 8 warps per row above that
// (2048-8192).  Each thread reads 16 bytes at a time (8 bf16 or 4 fp32
// values) where d and the row stride are multiples of that and the rows
// are aligned, and one element at a time otherwise.  Pass 1 accumulates
// the sum of squares in fp32; lanes reduce by a shuffle butterfly and, in
// block mode, warps through shared memory in warp order.  Pass 2 re-reads
// the row (from L1: 1-16 KB) and writes the scaled values.  No row padding:
// the grid covers the rows and the last block masks the ragged end.
//
// Deterministic: every thread visits its elements in a fixed order, the
// butterfly gives all lanes the same sum, the warps' partials are added in
// a fixed order, and there are no atomics, so the same input gives the
// same bits on every run (the streamed prefill is compared to the
// monolithic one with torch.equal).
//
// Rows are read through one row stride (the leading axes of a view such
// as x[:, -1:] collapse to it); the last axis is contiguous; y is written
// contiguous.

#include "attention_common.cuh"

namespace {

constexpr int kWarpRows = 4;      // rows (warps) per block in warp mode
constexpr int kBlockWarps = 8;    // warps per block in block mode
constexpr int kWarpModeMaxD = 1024;

template <typename TX, typename TS, bool VEC, bool BLOCK_ROW>
__global__ void __launch_bounds__(BLOCK_ROW ? kBlockWarps * 32 : kWarpRows * 32)
rmsnorm_kernel(const TX* __restrict__ x, const TS* __restrict__ scale,
               TX* __restrict__ y, int64_t rows, int d, int64_t row_stride,
               float eps) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = BLOCK_ROW ? static_cast<int64_t>(blockIdx.x)
                                : static_cast<int64_t>(blockIdx.x) * kWarpRows + warp;
  if (row >= rows) return;        // uniform over the warp (and the block)
  const int tid = BLOCK_ROW ? threadIdx.x : lane;
  const int nthreads = BLOCK_ROW ? kBlockWarps * 32 : 32;
  const TX* xr = x + row * row_stride;
  TX* yr = y + row * static_cast<int64_t>(d);
  constexpr int V = 16 / sizeof(TX);   // elements per 16-byte access

  float ss = 0.f;
  if (VEC) {
    for (int c = tid; c < d / V; c += nthreads) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + c * V);
      const TX* px = reinterpret_cast<const TX*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float v = to_f32(px[i]);
        ss += v * v;
      }
    }
  } else {
    for (int e = tid; e < d; e += nthreads) {
      const float v = to_f32(xr[e]);
      ss += v * v;
    }
  }
  ss = warp_sum(ss);
  if (BLOCK_ROW) {
    __shared__ float part[kBlockWarps];
    if (lane == 0) part[warp] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < kBlockWarps; ++w) ss += part[w];
  }
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  if (VEC) {
    for (int c = tid; c < d / V; c += nthreads) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + c * V);
      const TX* px = reinterpret_cast<const TX*>(&raw);
      uint4 packed;
      TX* py = reinterpret_cast<TX*>(&packed);
#pragma unroll
      for (int i = 0; i < V; ++i)
        py[i] = from_f32<TX>(to_f32(px[i]) * r * to_f32(scale[c * V + i]));
      *reinterpret_cast<uint4*>(yr + c * V) = packed;
    }
  } else {
    for (int e = tid; e < d; e += nthreads)
      yr[e] = from_f32<TX>(to_f32(xr[e]) * r * to_f32(scale[e]));
  }
}

template <typename TX, typename TS>
cudaError_t launch_typed(const void* x, const void* scale, void* y, int64_t rows,
                         int d, int64_t row_stride, float eps, bool vec,
                         cudaStream_t stream) {
  const auto* xp = static_cast<const TX*>(x);
  const auto* sp = static_cast<const TS*>(scale);
  auto* yp = static_cast<TX*>(y);
  if (d <= kWarpModeMaxD) {
    const dim3 grid(static_cast<unsigned>((rows + kWarpRows - 1) / kWarpRows));
    const dim3 block(kWarpRows * 32);
    if (vec)
      rmsnorm_kernel<TX, TS, true, false><<<grid, block, 0, stream>>>(
          xp, sp, yp, rows, d, row_stride, eps);
    else
      rmsnorm_kernel<TX, TS, false, false><<<grid, block, 0, stream>>>(
          xp, sp, yp, rows, d, row_stride, eps);
  } else {
    const dim3 grid(static_cast<unsigned>(rows)), block(kBlockWarps * 32);
    if (vec)
      rmsnorm_kernel<TX, TS, true, true><<<grid, block, 0, stream>>>(
          xp, sp, yp, rows, d, row_stride, eps);
    else
      rmsnorm_kernel<TX, TS, false, true><<<grid, block, 0, stream>>>(
          xp, sp, yp, rows, d, row_stride, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, for x (and y) and for scale
// independently.  row_stride is in elements; vec != 0 asks for 16-byte
// accesses, which the caller grants only when x, y and row_stride are
// aligned to them and d is a multiple of 16 / sizeof(x).  Returns the
// launch's cudaError_t (0 on success).
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* y,
                             int64_t rows, int d, int64_t row_stride, float eps,
                             int x_dtype, int scale_dtype, int vec, void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || d < 1 || row_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  if (v && d % (x_dtype == 0 ? 4 : 8) != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == 0 && scale_dtype == 0)
    return static_cast<int>(launch_typed<float, float>(x, scale, y, rows, d, row_stride,
                                                       eps, v, s));
  if (x_dtype == 0 && scale_dtype == 1)
    return static_cast<int>(launch_typed<float, __nv_bfloat16>(x, scale, y, rows, d,
                                                               row_stride, eps, v, s));
  if (x_dtype == 1 && scale_dtype == 0)
    return static_cast<int>(launch_typed<__nv_bfloat16, float>(x, scale, y, rows, d,
                                                               row_stride, eps, v, s));
  if (x_dtype == 1 && scale_dtype == 1)
    return static_cast<int>(launch_typed<__nv_bfloat16, __nv_bfloat16>(
        x, scale, y, rows, d, row_stride, eps, v, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
