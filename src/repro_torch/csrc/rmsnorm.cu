// Row RMSNorm for Hopper (sm_90a), optionally with the residual add fused in.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py (rmsnorm, body
// _kernel).
//
// What it computes: for every row of x [rows, d] (fp32 or bf16), the fp32
// mean of squares, then y = x * rsqrt(mean + eps) * scale, with scale [d]
// (fp32 or bf16) promoted to fp32, written in x's dtype.  The model's
// pre-attention, pre-MLP, final and qk norms all call it.  The fused form
// takes a residual r of x's shape and dtype: it writes s = x + r (each
// element to_f32(x) + to_f32(r) rounded to x's dtype, what PyTorch's x + r
// gives on the card) and normalises the rounded s, so y and s equal the
// unfused kernel on x + r bit for bit.  The model's pre-MLP norm uses it
// for the attention residual, the fusion XLA makes of
// src/repro/models/transformer.py:249-250.
//
// What bounds it on the H100: bytes.  It does ~4 operations per element
// against 4 (bf16) or 8 (fp32) bytes moved, so the least time is x read
// once, y written once and scale read once over 3.35 TB/s: 19.6 KB, or
// about 6 ns, for smollm-135m's decode rows (8 x 576 bf16).  At serving
// shapes the kernel therefore sits at launch latency, and what it can
// save is rounds of dependent memory traffic inside it, and launches
// around it (the fused add).
//
// What this design does about it: one warp per row for d <= 1024 (smollm's
// 576, head norms of 64-128), one block of 8 warps per row above that, up
// to 8192.  A row is cut into 16-byte chunks (8 bf16 or 4 fp32 values);
// lane t of the row's threads owns chunks t, t + n, t + 2n, ... (n the
// threads per row), CPL of them, CPL a template constant.  Each lane issues
// every load it needs first, unconditionally at clamped chunk indices (its
// x chunks, its residual chunks and the matching 16 bytes of the scale),
// and holds them in registers: one round of loads, x never read twice.
// Then the sum of squares in fp32, chunk by chunk and element by element
// (fmaf), a shuffle butterfly over the warp and, in block mode, the warps'
// partials through shared memory in warp order; then y from registers.
// Rows whose start, stride or width are not 16-byte multiples (and rows
// wider than 8192) take the scalar kernel: the same chunk-to-lane map and
// the same order of sums, element by element, reading x in two passes.
// So a row's bits depend on d alone, never on the row count, the
// alignment or the run.  No atomics.
//
// Rows of x (and of r) are read through one row stride each (the leading
// axes of a view such as x[:, -1:] collapse to it); the last axis is
// contiguous; y and s are written contiguous.
//
// Training: when the caller passes an rstd buffer (fp32, one per row), the
// row's rsqrt(mean + eps) lands there too, for csrc/rmsnorm_bwd.cu.
// Serving passes none, and nothing else changes.

#include "attention_common.cuh"

namespace {

constexpr int kWarpRows = 4;       // rows (warps) per block in warp mode
constexpr int kBlockWarps = 8;     // warps per block in block mode
constexpr int kWarpModeMaxD = 1024;
constexpr int kBlockModeMaxD = 8192;

// N values of type T, loaded as raw words (16 or 8 bytes per access) and
// widened to fp32 on use.
template <typename T, int N>
struct Raw {
  static constexpr int kWords = N * static_cast<int>(sizeof(T)) / 4;
  uint32_t w[kWords];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kWords % 4 == 0) {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
        w[4 * i] = v.x; w[4 * i + 1] = v.y; w[4 * i + 2] = v.z; w[4 * i + 3] = v.w;
      }
    } else {
      static_assert(kWords == 2, "8- or 16-byte multiples");
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x; w[1] = v.y;
    }
  }

  __device__ __forceinline__ float get(int i) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[i]);
    } else {
      return __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u) : (w[i >> 1] << 16));
    }
  }
};

// V values rounded to T and stored as one 16-byte access.
template <typename T, int V>
__device__ __forceinline__ void store16(T* p, const float (&v)[V]) {
  uint4 packed;
  T* e = reinterpret_cast<T*>(&packed);
#pragma unroll
  for (int i = 0; i < V; ++i) e[i] = from_f32<T>(v[i]);
  *reinterpret_cast<uint4*>(p) = packed;
}

// Sum of one thread's partial over the row's threads; every thread of the
// row gets the same bits (a butterfly adds the same pair on both sides;
// the warps' partials are added in warp order).
template <bool BLOCK_ROW>
__device__ __forceinline__ float row_sum(float ss) {
  ss = warp_sum(ss);
  if constexpr (BLOCK_ROW) {
    __shared__ float part[kBlockWarps];
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) part[warp] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < kBlockWarps; ++w) ss += part[w];
  }
  return ss;
}

template <typename TX>
__device__ __forceinline__ float add_rounded(float x, float r) {
  return to_f32(from_f32<TX>(x + r));  // what x + r gives in x's dtype
}

template <typename TX, typename TS, int CPL, bool BLOCK_ROW, bool RES>
__global__ void __launch_bounds__(BLOCK_ROW ? kBlockWarps * 32 : kWarpRows * 32)
rmsnorm_vec_kernel(const TX* __restrict__ x, const TX* __restrict__ res,
                   const TS* __restrict__ scale, TX* __restrict__ y,
                   TX* __restrict__ s_out, float* __restrict__ rstd_out,
                   int64_t rows, int d, int64_t x_stride, int64_t r_stride,
                   float eps) {
  constexpr int V = 16 / sizeof(TX);                 // values per chunk
  constexpr int kRowThreads = BLOCK_ROW ? kBlockWarps * 32 : 32;
  const int64_t row = BLOCK_ROW ? static_cast<int64_t>(blockIdx.x)
                                : static_cast<int64_t>(blockIdx.x) * kWarpRows +
                                      (threadIdx.x >> 5);
  if (row >= rows) return;          // uniform over the warp (and the block)
  const int tid = BLOCK_ROW ? threadIdx.x : (threadIdx.x & 31);
  const int nchunks = d / V;
  const TX* xr = x + row * x_stride;
  const TX* rr = RES ? res + row * r_stride : nullptr;

  // one round of loads: all chunks of x (and r) and of the scale
  Raw<TX, V> xv[CPL];
  Raw<TX, V> rv[RES ? CPL : 1];
  Raw<TS, V> sv[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = min(tid + i * kRowThreads, nchunks - 1);
    xv[i].load(xr + c * V);
    if constexpr (RES) rv[i].load(rr + c * V);
    sv[i].load(scale + c * V);
  }

  float v[CPL][V];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const bool live = tid + i * kRowThreads < nchunks;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float a = xv[i].get(e);
      if constexpr (RES) a = add_rounded<TX>(a, rv[i].get(e));
      v[i][e] = a;
      if (live) ss = fmaf(a, a, ss);
    }
  }
  ss = row_sum<BLOCK_ROW>(ss);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  if (rstd_out != nullptr && tid == 0) rstd_out[row] = r;

  TX* yr = y + row * static_cast<int64_t>(d);
  TX* sr = RES ? s_out + row * static_cast<int64_t>(d) : nullptr;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = tid + i * kRowThreads;
    if (c >= nchunks) continue;
    float o[V];
#pragma unroll
    for (int e = 0; e < V; ++e) o[e] = v[i][e] * r * sv[i].get(e);
    store16<TX, V>(yr + c * V, o);
    if constexpr (RES) store16<TX, V>(sr + c * V, v[i]);
  }
}

// Any row: element loads, the same chunk-to-thread map and order of sums
// as rmsnorm_vec_kernel, x (and r) read again in the second pass.
template <typename TX, typename TS, bool BLOCK_ROW, bool RES>
__global__ void __launch_bounds__(BLOCK_ROW ? kBlockWarps * 32 : kWarpRows * 32)
rmsnorm_scalar_kernel(const TX* __restrict__ x, const TX* __restrict__ res,
                      const TS* __restrict__ scale, TX* __restrict__ y,
                      TX* __restrict__ s_out, float* __restrict__ rstd_out,
                      int64_t rows, int d, int64_t x_stride, int64_t r_stride,
                      float eps) {
  constexpr int V = 16 / sizeof(TX);
  constexpr int kRowThreads = BLOCK_ROW ? kBlockWarps * 32 : 32;
  const int64_t row = BLOCK_ROW ? static_cast<int64_t>(blockIdx.x)
                                : static_cast<int64_t>(blockIdx.x) * kWarpRows +
                                      (threadIdx.x >> 5);
  if (row >= rows) return;
  const int tid = BLOCK_ROW ? threadIdx.x : (threadIdx.x & 31);
  const TX* xr = x + row * x_stride;
  const TX* rr = RES ? res + row * r_stride : nullptr;
  auto value = [&](int e) {
    float a = to_f32(xr[e]);
    if constexpr (RES) a = add_rounded<TX>(a, to_f32(rr[e]));
    return a;
  };

  float ss = 0.f;
  for (int c0 = tid * V; c0 < d; c0 += kRowThreads * V)
    for (int e = c0; e < min(c0 + V, d); ++e) {
      const float a = value(e);
      ss = fmaf(a, a, ss);
    }
  ss = row_sum<BLOCK_ROW>(ss);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  if (rstd_out != nullptr && tid == 0) rstd_out[row] = r;

  TX* yr = y + row * static_cast<int64_t>(d);
  for (int c0 = tid * V; c0 < d; c0 += kRowThreads * V)
    for (int e = c0; e < min(c0 + V, d); ++e) {
      const float a = value(e);
      yr[e] = from_f32<TX>(a * r * to_f32(scale[e]));
      if constexpr (RES) s_out[row * static_cast<int64_t>(d) + e] = from_f32<TX>(a);
    }
}

struct Args {
  const void *x, *res, *scale;
  void *y, *s;
  float* rstd;
  int64_t rows;
  int d;
  int64_t x_stride, r_stride;
  float eps;
};

template <typename TX, typename TS, bool BLOCK_ROW, bool RES>
cudaError_t launch_mode(const Args& a, bool vec, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(TX);
  constexpr int kRowThreads = BLOCK_ROW ? kBlockWarps * 32 : 32;
  const dim3 block(BLOCK_ROW ? kBlockWarps * 32 : kWarpRows * 32);
  const dim3 grid(static_cast<unsigned>(BLOCK_ROW ? a.rows
                                                  : (a.rows + kWarpRows - 1) / kWarpRows));
  const auto* xp = static_cast<const TX*>(a.x);
  const auto* rp = static_cast<const TX*>(a.res);
  const auto* sp = static_cast<const TS*>(a.scale);
  auto* yp = static_cast<TX*>(a.y);
  auto* op = static_cast<TX*>(a.s);
  const int per_lane = (a.d / V + kRowThreads - 1) / kRowThreads;   // chunks
#define REPRO_RMSNORM_VEC(CPL)                                                    \
  rmsnorm_vec_kernel<TX, TS, CPL, BLOCK_ROW, RES><<<grid, block, 0, stream>>>(     \
      xp, rp, sp, yp, op, a.rstd, a.rows, a.d, a.x_stride, a.r_stride, a.eps)
  if (vec && per_lane <= 8) {
    if (per_lane <= 1) REPRO_RMSNORM_VEC(1);
    else if (per_lane <= 2) REPRO_RMSNORM_VEC(2);
    else if (per_lane <= 3) REPRO_RMSNORM_VEC(3);
    else if (per_lane <= 4) REPRO_RMSNORM_VEC(4);
    else REPRO_RMSNORM_VEC(8);
  } else {
    rmsnorm_scalar_kernel<TX, TS, BLOCK_ROW, RES><<<grid, block, 0, stream>>>(
        xp, rp, sp, yp, op, a.rstd, a.rows, a.d, a.x_stride, a.r_stride, a.eps);
  }
#undef REPRO_RMSNORM_VEC
  return cudaGetLastError();
}

template <typename TX, typename TS>
cudaError_t launch_typed(const Args& a, bool vec, cudaStream_t stream) {
  const bool res = a.res != nullptr;
  if (a.d <= kWarpModeMaxD)
    return res ? launch_mode<TX, TS, false, true>(a, vec, stream)
               : launch_mode<TX, TS, false, false>(a, vec, stream);
  const bool v = vec && a.d <= kBlockModeMaxD;
  return res ? launch_mode<TX, TS, true, true>(a, v, stream)
             : launch_mode<TX, TS, true, false>(a, v, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, for x (and res, y, s) and for
// scale independently.  res may be null (no residual; s is then unused);
// otherwise s receives x + res.  Strides are in elements; vec != 0 asks for
// 16-byte accesses, which the caller grants only when x, res, y, s, the
// scale and both row strides are aligned to them and d is a multiple of
// 16 / sizeof(x).  rstd may be null; otherwise it receives each row's
// rsqrt(mean + eps), fp32 [rows].  Returns the launch's cudaError_t (0 on
// success).
extern "C" int repro_rmsnorm(const void* x, const void* res, const void* scale,
                             void* y, void* s, int64_t rows, int d,
                             int64_t x_stride, int64_t r_stride, float eps,
                             int x_dtype, int scale_dtype, int vec, void* rstd,
                             void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || d < 1 || x_stride < 0 || r_stride < 0 ||
      (res != nullptr && s == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool v = vec != 0;
  if (v && d % (x_dtype == 0 ? 4 : 8) != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, res, scale, y, s, static_cast<float*>(rstd), rows, d, x_stride,
               r_stride, eps};
  auto st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && scale_dtype == 0)
    return static_cast<int>(launch_typed<float, float>(a, v, st));
  if (x_dtype == 0 && scale_dtype == 1)
    return static_cast<int>(launch_typed<float, __nv_bfloat16>(a, v, st));
  if (x_dtype == 1 && scale_dtype == 0)
    return static_cast<int>(launch_typed<__nv_bfloat16, float>(a, v, st));
  if (x_dtype == 1 && scale_dtype == 1)
    return static_cast<int>(launch_typed<__nv_bfloat16, __nv_bfloat16>(a, v, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
