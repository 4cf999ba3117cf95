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
// What bounds it on the H100: bytes, on the tensor cores.  Per chunk of n
// rows, C_i . B_j over the n (n + 1) / 2 causal pairs is the same for every
// head; per head come the masked scores times x and the two state
// products, about n^2 dh + 4 n dh ds FLOPs against n (dh + ds) + dh ds
// fp32 values: ~1.0 GFLOP for zamba2-2.7b at B = 1, S = 512 (Q = 128,
// H = 80, dh = ds = 64), 2.0 us at 495 TFLOP/s TF32, under 6.7 us for its
// 22.6 MB.
//
// What this design does about it: the three phases of the plain chunked
// version (kernels/ref.py, ssd_chunked_ref), three launches on the
// caller's stream, so every chunk of every head runs in parallel and only
// a short elementwise pass is sequential:
//   1. chunk_state_kernel, one block of 8 warps per (chunk, head, batch):
//      the chunk's cumulative log decays A (each thread sums its own
//      row's prefix in row order, so every A_t is the serial sum), written
//      to a scratch for phases 2 and 3, and the chunk's state increment
//      dH = X^T (B * exp(A_tot - A_j)) [dh x ds] on the tensor cores
//      (slabs of 64 state rows, a warp 16 rows by ds / 2 columns), written
//      to the state scratch;
//   2. state_pass_kernel, one thread per (batch, head, 4 state entries):
//      h_k = exp(A_tot_k) h_{k-1} + dH_k for k = 0 .. K-1 from h0 or zeros,
//      storing in slot k the state that enters chunk k, and the final h;
//   3. chunk_out_kernel, one block of 8 warps per (64-row tile, chunk,
//      head, batch) (B = 1, S = 128 gives 160 blocks).  A warp owns 16 rows
//      (its row group) and half the columns of y.  Its accumulator starts
//      at C h_prev^T (h_prev staged in shared memory), row i scaled by
//      exp(A_i); then the block walks the columns j in steps of 32: the two
//      warps of a row group compute the step's score tiles C B^T, mask them
//      (j <= i) and decay them by exp(A_i - A_j) (exp2 of log2(e)-scaled
//      decays), and store them split (TF32 hi and lo) in shared memory;
//      after a barrier every warp adds W X for its rows and columns into
//      the same accumulator; y is written once (streaming stores, so the
//      inputs stay in L2).  C B^T is recomputed per head, so nothing goes
//      through a global scratch but the states.
// Every product runs on mma.sync.m16n8k8 with TF32 inputs and fp32
// accumulators, with 3xTF32 splits (a = a_hi + a_lo; a b ~ a_lo b_hi +
// a_hi b_lo + a_hi b_hi, in that order) to keep fp32 accuracy; an operand
// read from bf16 (B and C on zamba2's serving path) is exact in TF32, its
// low part zero, and its passes are dropped (C B^T then takes one pass,
// and its C fragments stay in registers).  B, C, X and h_prev are staged
// with cp.async (16-byte copies, zero-filled past the chunk's end) where
// their rows are 16-byte aligned.
//
// Deterministic and batch-invariant: no atomics, every sum in a fixed
// order that depends on the shapes (Q, dh, ds) alone, and no block reads
// another sequence's rows, so the same input gives the same bits on every
// run and a sequence gets the same bits alone or in a batch (the
// layer-streamed prefill is compared with torch.equal).

#include <type_traits>

#include "attention_common.cuh"
#include "tile_common.cuh"

namespace {

constexpr int kStateThreads = 256;  // phase 1: 8 warps
constexpr int kOutThreads = 256;    // phase 3: 8 warps
constexpr int kPassThreads = 128;   // phase 2
constexpr int kQMax = 128;          // rows of one chunk at most
constexpr int kStateSlab = 64;      // dh rows of the state per pass of phase 1
constexpr int kRowTile = 64;        // chunk rows per phase-3 block (16 a warp pair)
constexpr int kJStep = 32;          // score columns per step of phase 3
constexpr float kLog2e = 1.4426950408889634f;

struct RowStrides {   // element strides of B or C over the (batch, row) axes
  int64_t b, s;
};

// ---------------------------------------------------------------------------
// TF32 tensor-core helpers
// ---------------------------------------------------------------------------

// x rounded to TF32 (10 mantissa bits, to nearest, ties away), in a b32.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The 3xTF32 split of one operand value: hi = tf32(x), lo = tf32(x - hi).
// EXACT operands (bf16 values) are TF32 already: lo is zero and unused.
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (EXACT) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
  }
}

// d += a * b over one m16n8k8 tile, TF32 inputs, fp32 accumulators.
// Fragments (lane = 4 * group + tig): A (16 x 8, row-major) a0 (group, tig),
// a1 (group + 8, tig), a2 (group, tig + 4), a3 (group + 8, tig + 4); B (8 x 8,
// col-major) b0 (row tig, col group), b1 (row tig + 4, col group); C, D
// (16 x 8) c0, c1 (group, 2 tig, + 1), c2, c3 (group + 8, same cols).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b with the 3xTF32 passes that the operands' exactness leaves:
// a_lo b_hi, a_hi b_lo, a_hi b_hi, in that order.
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  if constexpr (!A_EXACT) mma_tf32(d, al, bh0, bh1);
  if constexpr (!B_EXACT) mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// The A fragment of rows (row0 + group, + 8) and columns (col0 + tig, + 4)
// of a row-major shared tile, split.
template <bool EXACT, typename T>
__device__ __forceinline__ void load_a(const T* tile, int ld, int row0, int col0,
                                       int group, int tig, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const T* p = tile + (row0 + group) * ld + col0 + tig;
  split<EXACT>(to_f32(p[0]), hi[0], lo[0]);
  split<EXACT>(to_f32(p[8 * ld]), hi[1], lo[1]);
  split<EXACT>(to_f32(p[4]), hi[2], lo[2]);
  split<EXACT>(to_f32(p[8 * ld + 4]), hi[3], lo[3]);
}

// Programmatic dependent launch (Hopper): a kernel launched with
// programmatic stream serialization may start while the kernel before it
// runs; grid_wait() returns once that kernel has finished and its writes
// are visible (a no-op in a kernel launched the ordinary way), and
// allow_dependents() lets the next kernel start early.
__device__ __forceinline__ void grid_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void allow_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// staging
// ---------------------------------------------------------------------------

// Rows [0, nrows) of a [*, width] tile of T into shared memory (row stride
// ld elements): row r < nvalid from src + r * stride, zeros past it.  With
// async, 16-byte cp.async copies (src rows 16-byte aligned); otherwise
// element loads.
template <int NTHREADS, typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src, int64_t stride,
                                           int nrows, int nvalid, int width,
                                           bool async) {
  constexpr int kPer = 16 / sizeof(T);
  if (async) {
    const int pieces = width / kPer;
    for (int idx = threadIdx.x; idx < nrows * pieces; idx += NTHREADS) {
      const int r = idx / pieces, p = idx % pieces;
      const int rs = min(r, nvalid - 1);
      cp_async16(dst + r * ld + p * kPer, src + rs * stride + p * kPer, r < nvalid);
    }
  } else {
    for (int idx = threadIdx.x; idx < nrows * width; idx += NTHREADS) {
      const int r = idx / width, c = idx % width;
      dst[r * ld + c] = r < nvalid ? src[r * stride + c] : T(0.f);
    }
  }
}

// Shared-memory row strides (elements) chosen so that each fragment load
// below hits 32 distinct banks: a tile read as (row = group, col = tig)
// needs a stride of 4 mod 32 words (bf16: 8 elements of padding, for the
// 16-byte rows cp.async writes); one read as (row = tig, col = group)
// needs 8 mod 32 words.
template <typename T, int WIDTH>
struct Pad {
  static constexpr int by_group = WIDTH + (sizeof(T) == 2 ? 8 : 4);
  static constexpr int by_tig = WIDTH + 8;
};

// ---------------------------------------------------------------------------
// phase 1: the chunk's cumulative log decays and state increment
// ---------------------------------------------------------------------------

template <typename T, int DSTATE>
struct StateSmem {
  static constexpr int xld = Pad<float, kStateSlab>::by_tig;   // X [kQMax][xld]
  static constexpr int bld = Pad<T, DSTATE>::by_tig;           // B [kQMax][bld]
  static constexpr int x_bytes = kQMax * xld * 4;
  static constexpr int b_bytes = kQMax * bld * static_cast<int>(sizeof(T));
  static constexpr int bytes = x_bytes + b_bytes + 3 * kQMax * 4;
};

// Block (chunk k, head, batch); per slab of 64 state rows, warp w takes
// rows 16 (w & 3) .. + 15 and state columns (w >> 2) ds / 2 ..
template <typename T, int DSTATE>
__global__ void __launch_bounds__(kStateThreads)
chunk_state_kernel(const float* __restrict__ xb, const T* __restrict__ Bm,
                   const float* __restrict__ ld, float* __restrict__ states,
                   float* __restrict__ acum, int S, int H, int dh, int Q, int K,
                   RowStrides bs, bool b_async) {
  using L = StateSmem<T, DSTATE>;
  constexpr bool kExactB = std::is_same<T, __nv_bfloat16>::value;
  constexpr int NTH = DSTATE / 16;                // n8 tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);
  T* bsm = reinterpret_cast<T*>(smem_raw + L::x_bytes);
  float* lds = reinterpret_cast<float*>(smem_raw + L::x_bytes + L::b_bytes);
  float* A = lds + kQMax;
  float* e = A + kQMax;

  const int k = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int group = lane >> 2, tig = lane & 3;
  const int c0 = k * Q;
  const int n = min(Q, S - c0);
  const int npad = (n + 7) & ~7;                  // k-steps of 8 rows
  const int64_t xrow = static_cast<int64_t>(H) * dh;
  const float* xbase = xb + (static_cast<int64_t>(b) * S + c0) * xrow + hh * dh;
  allow_dependents();              // the state pass may launch and wait

  // loads first: B rows, the first X slab, this thread's log decay
  stage_rows<kStateThreads>(bsm, L::bld, Bm + b * bs.b + c0 * bs.s, bs.s, npad, n,
                            DSTATE, b_async);
  stage_rows<kStateThreads>(xs, L::xld, xbase, xrow, npad, n, min(kStateSlab, dh), true);
  cp_async_commit();
  if (t < kQMax) lds[t] = t < n ? ld[(static_cast<int64_t>(b) * S + c0 + t) * H + hh] : 0.f;
  __syncthreads();
  if (t < kQMax) {
    // A_t = ld_0 + ld_1 + ... + ld_t in row order, each thread its own row
    // (rows past t and past n add exact zeros)
    float run = 0.f;
#pragma unroll 8
    for (int i = 0; i < kQMax; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(lds + i);
      run += i <= t ? v.x : 0.f;
      run += i + 1 <= t ? v.y : 0.f;
      run += i + 2 <= t ? v.z : 0.f;
      run += i + 3 <= t ? v.w : 0.f;
    }
    A[t] = run;
  }
  __syncthreads();
  if (t < kQMax) {
    e[t] = t < n ? expf(A[n - 1] - A[t]) : 0.f;
    if (t < n) acum[((static_cast<int64_t>(b) * H + hh) * K + k) * Q + t] = A[t];
  }

  const int m0 = 16 * (warp & 3);                 // state rows of the slab
  const int s_base = (warp >> 2) * (DSTATE / 2);  // state columns
  float* dst = states + ((static_cast<int64_t>(b) * K + k) * H + hh) * dh * DSTATE;
  for (int d0 = 0; d0 < dh; d0 += kStateSlab) {
    if (d0 > 0) {
      __syncthreads();             // the previous slab is consumed
      stage_rows<kStateThreads>(xs, L::xld, xbase + d0, xrow, npad, n,
                                min(kStateSlab, dh - d0), true);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    if (d0 + m0 >= dh) continue;
    float acc[NTH][4];
#pragma unroll
    for (int nt = 0; nt < NTH; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;
    for (int j0 = 0; j0 < npad; j0 += 8) {
      // A operand: (X * exp(A_tot - A_j))^T, rows d, columns j
      const float e0 = e[j0 + tig], e1 = e[j0 + tig + 4];
      const float* x0 = xs + (j0 + tig) * L::xld + m0 + group;
      const float* x1 = x0 + 4 * L::xld;
      uint32_t ah[4], al[4];
      split<false>(x0[0] * e0, ah[0], al[0]);
      split<false>(x0[8] * e0, ah[1], al[1]);
      split<false>(x1[0] * e1, ah[2], al[2]);
      split<false>(x1[8] * e1, ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < NTH; ++nt) {
        const T* bp = bsm + (j0 + tig) * L::bld + s_base + nt * 8 + group;
        uint32_t bh0, bl0, bh1, bl1;
        split<kExactB>(to_f32(bp[0]), bh0, bl0);
        split<kExactB>(to_f32(bp[4 * L::bld]), bh1, bl1);
        mma3<false, kExactB>(acc[nt], ah, al, bh0, bh1, bl0, bl1);
      }
    }
    float* o = dst + static_cast<int64_t>(d0 + m0 + group) * DSTATE + s_base + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < NTH; ++nt) {
      *reinterpret_cast<float2*>(o + nt * 8) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(o + 8 * DSTATE + nt * 8) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// phase 2: the sequential pass over chunks, elementwise
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kPassThreads)
state_pass_kernel(float* __restrict__ states, const float* __restrict__ acum,
                  const float* __restrict__ h0, float* __restrict__ h_out, int S,
                  int H, int dhds, int Q, int K) {
  const int q4 = blockIdx.x * kPassThreads + threadIdx.x;   // 4 entries each
  if (4 * q4 >= dhds) return;
  const int hh = blockIdx.y, b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * H + hh;
  float4 h = h0 ? reinterpret_cast<const float4*>(h0 + bh * dhds)[q4]
                : make_float4(0.f, 0.f, 0.f, 0.f);
  allow_dependents();              // the chunk outputs may launch and stage
  grid_wait();                     // the chunk states are written
  constexpr int kAhead = 4;        // chunk increments loaded per round
  for (int k0 = 0; k0 < K; k0 += kAhead) {
    float4 inc[kAhead];
    float decay[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int k = min(k0 + u, K - 1);
      const int n = min(Q, S - k * Q);
      inc[u] = reinterpret_cast<const float4*>(
          states + ((static_cast<int64_t>(b) * K + k) * H + hh) * dhds)[q4];
      decay[u] = acum[(bh * K + k) * Q + n - 1];
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int k = k0 + u;
      if (k >= K) break;
      reinterpret_cast<float4*>(
          states + ((static_cast<int64_t>(b) * K + k) * H + hh) * dhds)[q4] = h;
      const float g = expf(decay[u]);
      h = make_float4(g * h.x + inc[u].x, g * h.y + inc[u].y, g * h.z + inc[u].z,
                      g * h.w + inc[u].w);
    }
  }
  reinterpret_cast<float4*>(h_out + bh * dhds)[q4] = h;
}

// ---------------------------------------------------------------------------
// phase 3: the chunk's outputs
// ---------------------------------------------------------------------------

template <typename T, int DSTATE, int SLAB>
struct OutSmem {
  static constexpr int cld = Pad<T, DSTATE>::by_group;       // C [kRowTile][cld]
  static constexpr int bld = Pad<T, DSTATE>::by_group;       // B [kQMax][bld]
  static constexpr int xld = Pad<float, SLAB>::by_tig;       // X [kQMax][xld]
  static constexpr int hld = Pad<float, DSTATE>::by_group;   // h_prev [SLAB][hld]
  static constexpr int wld = kJStep + 4;                     // W hi, lo [kRowTile][wld]
  static constexpr int c_bytes = kRowTile * cld * static_cast<int>(sizeof(T));
  static constexpr int b_bytes = kQMax * bld * static_cast<int>(sizeof(T));
  static constexpr int x_bytes = kQMax * xld * 4;
  static constexpr int w_bytes = 2 * kRowTile * wld * 4;
  static constexpr int h_bytes = SLAB * hld * 4;
  // h_prev is consumed before the first score tile: W reuses its space
  static constexpr int u_bytes = w_bytes > h_bytes ? w_bytes : h_bytes;
  static constexpr int bytes = c_bytes + b_bytes + x_bytes + u_bytes + kQMax * 4;
};

// Block (64-row tile of chunk k, head, batch); warp w owns rows
// 16 (w & 3) .. + 15 of the tile (its row group) and, of each slab of dh,
// the y columns (w >> 2) SLAB / 2 ..; for the score tiles the two warps of
// a row group split the 32 columns of a step.
template <typename T, int DSTATE, int SLAB>
__global__ void __launch_bounds__(kOutThreads, 2)
chunk_out_kernel(const float* __restrict__ xb, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, const float* __restrict__ states,
                 const float* __restrict__ acum, float* __restrict__ y, int S, int H,
                 int dh, int Q, int K, RowStrides bs, RowStrides cs, bool bc_async,
                 bool has_h0) {
  using L = OutSmem<T, DSTATE, SLAB>;
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;
  constexpr int NT = SLAB / 16;    // n8 tiles of y per warp
  constexpr int kSteps = DSTATE / 8;
  // bf16 C fragments are held in registers for the whole block
  constexpr bool kHoldC = kExact && DSTATE <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* csm = reinterpret_cast<T*>(smem_raw);
  T* bsm = reinterpret_cast<T*>(smem_raw + L::c_bytes);
  float* xs = reinterpret_cast<float*>(smem_raw + L::c_bytes + L::b_bytes);
  float* usm = reinterpret_cast<float*>(smem_raw + L::c_bytes + L::b_bytes + L::x_bytes);
  float* A2 = reinterpret_cast<float*>(smem_raw + L::c_bytes + L::b_bytes + L::x_bytes +
                                       L::u_bytes);
  float* w_hi = usm;
  float* w_lo = usm + kRowTile * L::wld;

  const int tiles = (Q + kRowTile - 1) / kRowTile;
  const int r0 = (blockIdx.x % tiles) * kRowTile;
  const int k = blockIdx.x / tiles, hh = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int group = lane >> 2, tig = lane & 3;
  const int c0 = k * Q;
  const int n = min(Q, S - c0);
  if (r0 >= n) return;                       // uniform over the block
  const int rows = r0 + kRowTile;            // B, X and A rows the tile reads
  const int64_t xrow = static_cast<int64_t>(H) * dh;
  const float* xbase = xb + (static_cast<int64_t>(b) * S + c0) * xrow + hh * dh;
  const bool has_prev = k > 0 || has_h0;
  const float* hbase = states + ((static_cast<int64_t>(b) * K + k) * H + hh) *
                                    static_cast<int64_t>(dh) * DSTATE;

  // Three groups of copies: C and the tile's first 64 rows of B and X
  // (inputs: issued before this block waits for the launches before it,
  // which it may have started beside); h_prev (written by them); then
  // (tile 1) rows 64 .. 127 of B and X, in flight while the first score
  // steps run.
  const T* bbase = Bm + b * bs.b + c0 * bs.s;
  stage_rows<kOutThreads>(csm, L::cld, Cm + b * cs.b + (c0 + r0) * cs.s, cs.s, kRowTile,
                          n - r0, DSTATE, bc_async);
  stage_rows<kOutThreads>(bsm, L::bld, bbase, bs.s, kRowTile, n, DSTATE, bc_async);
  stage_rows<kOutThreads>(xs, L::xld, xbase, xrow, kRowTile, n, SLAB, true);
  cp_async_commit();
  grid_wait();
  if (has_prev)
    stage_rows<kOutThreads>(usm, L::hld, hbase, DSTATE, SLAB, SLAB, DSTATE, true);
  cp_async_commit();
  if (rows > kRowTile) {
    stage_rows<kOutThreads>(bsm + kRowTile * L::bld, L::bld, bbase + kRowTile * bs.s, bs.s,
                            rows - kRowTile, n - kRowTile, DSTATE, bc_async);
    stage_rows<kOutThreads>(xs + kRowTile * L::xld, L::xld, xbase + kRowTile * xrow, xrow,
                            rows - kRowTile, n - kRowTile, SLAB, true);
  }
  cp_async_commit();
  // log2-scaled cumulative decays: exp(A_i - A_j) = exp2(A2_i - A2_j)
  if (t < rows)
    A2[t] = kLog2e * acum[((static_cast<int64_t>(b) * H + hh) * K + k) * Q + min(t, n - 1)];
  cp_async_wait<1>();              // all but rows 64 .. 127 of B and X
  __syncthreads();

  const int m0 = 16 * (warp & 3);            // the warp's rows of the tile
  const int half = warp >> 2;
  const int cb = half * (SLAB / 2);          // the warp's columns of the slab
  const int i0 = r0 + m0 + group;            // chunk rows of c0 / c1 and c2 / c3
  const int i1 = i0 + 8;
  const int i_last = r0 + m0 + 15;           // the warp's last row
  const bool live = r0 + m0 < n;
  const float a_i0 = A2[i0], a_i1 = A2[i1];

  uint32_t cfr[kHoldC ? kSteps : 1][4];      // C fragments of the row group
  if constexpr (kHoldC) {
    uint32_t unused[4];
#pragma unroll
    for (int q = 0; q < kSteps; ++q)
      load_a<true>(csm, L::cld, m0, 8 * q, group, tig, cfr[q], unused);
  }
  auto c_frag = [&](int q, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    if constexpr (kHoldC) {
#pragma unroll
      for (int u = 0; u < 4; ++u) hi[u] = cfr[q][u];
    } else {
      load_a<kExact>(csm, L::cld, m0, 8 * q, group, tig, hi, lo);
    }
  };

  for (int d0 = 0; d0 < dh; d0 += SLAB) {
    if (d0 > 0) {
      __syncthreads();                       // the previous slab is consumed
      stage_rows<kOutThreads>(xs, L::xld, xbase + d0, xrow, rows, n, SLAB, true);
      if (has_prev)
        stage_rows<kOutThreads>(usm, L::hld, hbase + static_cast<int64_t>(d0) * DSTATE,
                                DSTATE, SLAB, SLAB, DSTATE, true);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;

    if (has_prev) {                          // exp(A_i) * C_i . h_prev
      if (live) {
#pragma unroll
        for (int q = 0; q < kSteps; ++q) {
          uint32_t ah[4], al[4];
          c_frag(q, ah, al);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const float* hp = usm + (cb + nt * 8 + group) * L::hld + 8 * q + tig;
            uint32_t bh0, bl0, bh1, bl1;
            split<false>(hp[0], bh0, bl0);
            split<false>(hp[4], bh1, bl1);
            mma3<kExact, false>(acc[nt], ah, al, bh0, bh1, bl0, bl1);
          }
        }
        const float ea0 = exp2f(a_i0), ea1 = exp2f(a_i1);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          acc[nt][0] *= ea0;
          acc[nt][1] *= ea0;
          acc[nt][2] *= ea1;
          acc[nt][3] *= ea1;
        }
      }
      __syncthreads();                       // h_prev is read: W may reuse it
    }

    for (int j0 = 0; j0 < rows; j0 += kJStep) {
      if (j0 == kRowTile && d0 == 0) {       // rows 64 .. 127 of B and X
        cp_async_wait<0>();
        __syncthreads();
      }
      // this warp's half of the step's score tiles for its row group:
      // W_ij = (C_i . B_j) exp(A_i - A_j) for j <= i, split for the mma
      const int jt0 = 2 * half;
      const bool on0 = live && j0 + jt0 * 8 <= i_last;    // not wholly above
      const bool on1 = live && j0 + jt0 * 8 + 8 <= i_last;  // the diagonal
      if (on0) {
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int q = 0; q < kSteps; ++q) {
          uint32_t ah[4], al[4];
          c_frag(q, ah, al);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (u == 1 && !on1) continue;
            const T* bp = bsm + (j0 + (jt0 + u) * 8 + group) * L::bld + 8 * q + tig;
            uint32_t bh0, bl0, bh1, bl1;
            split<kExact>(to_f32(bp[0]), bh0, bl0);
            split<kExact>(to_f32(bp[4]), bh1, bl1);
            mma3<kExact, kExact>(sc[u], ah, al, bh0, bh1, bl0, bl1);
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (u == 1 && !on1) continue;
          const int jt = jt0 + u;
          const int j = j0 + jt * 8 + 2 * tig;
          const float a_j0 = A2[j], a_j1 = A2[j + 1];
          const float w4[4] = {j <= i0 ? sc[u][0] * exp2f(a_i0 - a_j0) : 0.f,
                               j + 1 <= i0 ? sc[u][1] * exp2f(a_i0 - a_j1) : 0.f,
                               j <= i1 ? sc[u][2] * exp2f(a_i1 - a_j0) : 0.f,
                               j + 1 <= i1 ? sc[u][3] * exp2f(a_i1 - a_j1) : 0.f};
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) split<false>(w4[q], hi[q], lo[q]);
          const int off = (m0 + group) * L::wld + jt * 8 + 2 * tig;
          *reinterpret_cast<uint2*>(w_hi + off) = make_uint2(hi[0], hi[1]);
          *reinterpret_cast<uint2*>(w_lo + off) = make_uint2(lo[0], lo[1]);
          *reinterpret_cast<uint2*>(w_hi + off + 8 * L::wld) = make_uint2(hi[2], hi[3]);
          *reinterpret_cast<uint2*>(w_lo + off + 8 * L::wld) = make_uint2(lo[2], lo[3]);
        }
      }
      __syncthreads();
      // y += W X over the step's 32 columns
#pragma unroll
      for (int jt = 0; jt < kJStep / 8; ++jt) {
        if (!live || j0 + jt * 8 > i_last) continue;
        const float* wh = w_hi + (m0 + group) * L::wld + jt * 8 + tig;
        const float* wl = w_lo + (m0 + group) * L::wld + jt * 8 + tig;
        const uint32_t ah[4] = {__float_as_uint(wh[0]), __float_as_uint(wh[8 * L::wld]),
                                __float_as_uint(wh[4]), __float_as_uint(wh[8 * L::wld + 4])};
        const uint32_t al[4] = {__float_as_uint(wl[0]), __float_as_uint(wl[8 * L::wld]),
                                __float_as_uint(wl[4]), __float_as_uint(wl[8 * L::wld + 4])};
        const float* xp = xs + (j0 + jt * 8 + tig) * L::xld + cb + group;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t bh0, bl0, bh1, bl1;
          split<false>(xp[nt * 8], bh0, bl0);
          split<false>(xp[4 * L::xld + nt * 8], bh1, bl1);
          mma3<false, false>(acc[nt], ah, al, bh0, bh1, bl0, bl1);
        }
      }
      __syncthreads();                       // W is rewritten by the next step
    }

    if (live) {
      float* y0 = y + ((static_cast<int64_t>(b) * S + c0 + i0) * H + hh) * dh + d0 + cb +
                  2 * tig;
      float* y1 = y0 + 8 * xrow;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {    // streaming stores: X stays in L2
        if (i0 < n)
          __stcs(reinterpret_cast<float2*>(y0 + nt * 8), make_float2(acc[nt][0], acc[nt][1]));
        if (i1 < n)
          __stcs(reinterpret_cast<float2*>(y1 + nt * 8), make_float2(acc[nt][2], acc[nt][3]));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Launch kernel on the stream with programmatic stream serialization: it
// may start while the kernel before it runs, and waits for it in
// grid_wait().
template <typename... Params, typename... Args>
cudaError_t launch_after(void (*kernel)(Params...), dim3 grid, int threads, int smem,
                         cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int DSTATE>
cudaError_t launch_state(const float* xb, const T* Bm, const T* Cm, const float* ld,
                         const float* h0, float* scratch, float* y, float* h_out,
                         int B, int S, int H, int dh, int Q, RowStrides bs,
                         RowStrides cs, bool bc_async, cudaStream_t stream) {
  const int K = (S + Q - 1) / Q;
  float* states = scratch;                                   // [B][K][H][dh][ds]
  float* acum = scratch + static_cast<int64_t>(B) * K * H * dh * DSTATE;  // [B][H][K][Q]
  auto k1 = chunk_state_kernel<T, DSTATE>;
  auto k3a = chunk_out_kernel<T, DSTATE, 64>;
  auto k3b = chunk_out_kernel<T, DSTATE, 32>;
  constexpr int smem1 = StateSmem<T, DSTATE>::bytes;
  constexpr int smem3a = OutSmem<T, DSTATE, 64>::bytes;
  constexpr int smem3b = OutSmem<T, DSTATE, 32>::bytes;
  static bool configured = false;            // one attribute call per instantiation
  if (!configured) {
    cudaError_t err = allow_smem(k1, smem1);
    if (err == cudaSuccess) err = allow_smem(k3a, smem3a);
    if (err == cudaSuccess) err = allow_smem(k3b, smem3b);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  k1<<<dim3(K, H, B), kStateThreads, smem1, stream>>>(
      xb, Bm, ld, states, acum, S, H, dh, Q, K, bs, bc_async);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int dhds = dh * DSTATE;
  err = launch_after(state_pass_kernel,
                     dim3((dhds / 4 + kPassThreads - 1) / kPassThreads, H, B),
                     kPassThreads, 0, stream, states, acum, h0, h_out, S, H, dhds, Q, K);
  if (err != cudaSuccess) return err;
  const dim3 grid3(((Q + kRowTile - 1) / kRowTile) * K, H, B);
  return launch_after(dh % 64 == 0 ? k3a : k3b, grid3, kOutThreads,
                      dh % 64 == 0 ? smem3a : smem3b, stream, xb, Bm, Cm,
                      static_cast<const float*>(states), static_cast<const float*>(acum),
                      y, S, H, dh, Q, K, bs, cs, bc_async, h0 != nullptr);
}

template <typename T>
bool rows_aligned(const void* p, RowStrides st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (st.b * sizeof(T)) % 16 == 0 &&
         (st.s * sizeof(T)) % 16 == 0;
}

template <typename T>
cudaError_t launch_typed(const void* xb, const void* Bm, const void* Cm,
                         const void* ld, const void* h0, void* scratch, void* y,
                         void* h_out, int B, int S, int H, int dh, int ds, int Q,
                         RowStrides bs, RowStrides cs, cudaStream_t stream) {
  const bool bc_async = rows_aligned<T>(Bm, bs) && rows_aligned<T>(Cm, cs);
  switch (ds) {
#define REPRO_SSD_STATE(DS)                                                         \
  case DS:                                                                          \
    return launch_state<T, DS>(                                                     \
        static_cast<const float*>(xb), static_cast<const T*>(Bm),                   \
        static_cast<const T*>(Cm), static_cast<const float*>(ld),                   \
        static_cast<const float*>(h0), static_cast<float*>(scratch),                \
        static_cast<float*>(y), static_cast<float*>(h_out), B, S, H, dh, Q, bs, cs, \
        bc_async, stream);
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
// null), y and h_out are contiguous fp32, xb 16-byte aligned; scratch is
// fp32 of B * K * H * dh * ds + B * H * K * Q floats (K = ceil(S / Q):
// the per-chunk states, then the cumulative log decays); B and C strides
// are in elements over their (batch, row) axes, the state axis contiguous.
// ds is 16, 32, 64 or 128; dh a multiple of 32; 1 <= Q <= 128.  Three
// launches on the stream (chunk states, the state pass, chunk outputs).
// Returns the launches' cudaError_t (0 on success).
extern "C" int repro_ssd_scan(const void* xb, const void* Bm, const void* Cm,
                              const void* ld, const void* h0, void* scratch, void* y,
                              void* h_out, int B, int S, int H, int dh, int ds,
                              int Q, int64_t b_sb, int64_t b_ss, int64_t c_sb,
                              int64_t c_ss, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || dh < 32 || dh % 32 != 0 || Q < 1 || Q > kQMax ||
      B > 65535 || H > 65535 || reinterpret_cast<uintptr_t>(xb) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const RowStrides bs{b_sb, b_ss}, cs{c_sb, c_ss};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = launch_typed<float>(xb, Bm, Cm, ld, h0, scratch, y, h_out, B, S, H, dh, ds,
                              Q, bs, cs, s);
  else if (dtype == 1)
    err = launch_typed<__nv_bfloat16>(xb, Bm, Cm, ld, h0, scratch, y, h_out, B, S, H,
                                      dh, ds, Q, bs, cs, s);
  return static_cast<int>(err);
}
