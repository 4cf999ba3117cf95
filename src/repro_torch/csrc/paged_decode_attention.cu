// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_decode_attention.py
// (paged_decode_attention, bodies _kernel / _dequant_kernel / _accumulate).
//
// What it computes: one query token per sequence attends over a block-paged
// KV arena.  page_table[b, t] names the physical page of logical block t of
// sequence b; positions >= lengths[b] are masked, and a sequence of length
// 0 gives zeros.  The G = H / KV query heads of one KV head share one pass
// over its rows.  Softmax is online, in fp32, normalised at the end.  The
// int8 variant dequantizes each row with its fp32 scale in registers
// (row * scale), so fp K/V never exists in memory.
//
// What bounds it on the H100: bytes.  Each K/V row (and its scale) is read
// once and used for G <= 8 dot products, far below the ~295 operations per
// byte where the tensor cores would become the limit, so the least time is
// the K/V bytes the lengths select over 3.35 TB/s: under a microsecond at
// serving sizes.  What the kernel can win is latency: many blocks in
// flight, each issuing all its loads at once.
//
// What this design does about it: the split-KV body of decode_split.cuh,
// the one decode_attention.cu runs over a dense cache, with a paged row
// source.  The grid is (B * KV, n_splits), n_splits = ceil(NB * ps /
// split_rows(d)) over the allocated length, so even one sequence spreads
// over many SMs; a block loads the page ids of its span into shared memory
// once, then its lane groups read whole rows in 16-byte chunks (8 bytes of
// int8) straight from the arena's storage layout [P, ps, KV, d] (scales
// [P, ps, KV]), with no gather and no transpose; a second launch merges the
// partials in a fixed order.  Spans are in logical rows, so any page size
// works (at ps = 8 a span of 64 rows is 8 pages), and a sequence gets the
// bits that decode_attention gives over the same rows in a dense cache.
// Rows of free slots point at the null page 0, which is read like any
// other page.

#include "decode_split.cuh"

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (arena only, with
// k_scales / v_scales [P, ps, KV] fp32).  The arena is [P, ps, KV, d]
// contiguous, q [B, H, d] and out contiguous, page_table [B, NB] int32;
// q, the arena and out start on 16 bytes (else cudaErrorMisalignedAddress).
// d is 64, 80, 128 or 256; H / KV <= 8.  split must be split_rows(d) and
// n_splits = ceil(NB * ps / split); part_acc holds B * KV * n_splits *
// (H / KV) * d floats and part_ml twice B * KV * n_splits * (H / KV).  Two
// launches on the stream; returns the first failing cudaError_t (0 on
// success).
extern "C" int repro_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* page_table,
    const void* lengths, void* part_acc, void* part_ml, void* out, int B, int H,
    int KV, int d, int ps, int NB, int split, int n_splits, int q_dtype,
    int kv_dtype, void* stream) {
  if (ps < 1 || NB < 1 || NB > (1 << 30) / ps ||
      !decode_args_ok(B, H, KV, d, NB * ps, split, n_splits))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k_pages) || !aligned16(v_pages) || !aligned16(out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* pt = static_cast<const int32_t*>(page_table);
  const int T = NB * ps;
  cudaError_t err = cudaErrorInvalidValue;
  if (kv_dtype == 2 && k_scales != nullptr && v_scales != nullptr) {
    const PagedInt8Rows rows{{pt, NB, ps, KV, d, static_cast<const int8_t*>(k_pages),
                              static_cast<const int8_t*>(v_pages)},
                             static_cast<const float*>(k_scales),
                             static_cast<const float*>(v_scales)};
    if (q_dtype == 0)
      err = launch_decode<float>(q, rows, lengths, part_acc, part_ml, out, B, H, KV,
                                 d, T, n_splits, s);
    else if (q_dtype == 1)
      err = launch_decode<__nv_bfloat16>(q, rows, lengths, part_acc, part_ml, out, B,
                                         H, KV, d, T, n_splits, s);
  } else if (q_dtype == 0 && kv_dtype == 0) {
    const PagedRows<float> rows{{pt, NB, ps, KV, d, static_cast<const float*>(k_pages),
                                 static_cast<const float*>(v_pages)}};
    err = launch_decode<float>(q, rows, lengths, part_acc, part_ml, out, B, H, KV, d,
                               T, n_splits, s);
  } else if (q_dtype == 1 && kv_dtype == 1) {
    const PagedRows<__nv_bfloat16> rows{
        {pt, NB, ps, KV, d, static_cast<const __nv_bfloat16*>(k_pages),
         static_cast<const __nv_bfloat16*>(v_pages)}};
    err = launch_decode<__nv_bfloat16>(q, rows, lengths, part_acc, part_ml, out, B, H,
                                       KV, d, T, n_splits, s);
  }
  return static_cast<int>(err);
}
