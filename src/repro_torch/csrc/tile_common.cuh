// Tensor-core and asynchronous-copy helpers for the bf16 attention tiles.
//
// Inline PTX for sm_80+ instructions that Hopper keeps: 16-byte cp.async
// copies from global into shared memory (zero-filling rows past a ragged
// edge), ldmatrix loads of 8x8 bf16 tiles into mma fragments (.trans for
// an operand stored row-major in the other orientation), and the warp-wide
// m16n8k16 product with bf16 inputs and fp32 accumulators.
//
// Fragment layout of mma.m16n8k16 (lane = 4 * group + quad):
//   A (16 x 16, row-major), four b32 registers of two bf16 each:
//     a0 (row group, cols 2 quad, +1), a1 (row group + 8, same cols),
//     a2 (row group, cols 8 + 2 quad, +1), a3 (row group + 8, same cols);
//   B (16 x 8, col-major), two registers: b0 (rows 2 quad, +1; col group),
//     b1 (rows 8 + 2 quad, +1; col group);
//   C, D (16 x 8, fp32): c0, c1 (row group, cols 2 quad, +1),
//     c2, c3 (row group + 8, same cols).
// So the C fragments of two neighbouring n8 tiles, rounded to bf16 and
// packed in pairs, are exactly the A fragment of the next product over
// those 16 columns: P never leaves registers.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; !full writes 16 zero bytes
// (src is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const int n = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 bf16 tiles; lanes 8i .. 8i + 7 give the row addresses of tile i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

// d += a * b over one m16n8k16 tile: bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace
