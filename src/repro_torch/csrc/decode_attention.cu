// Decode attention over a dense KV cache for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention, body _kernel).
//
// What it computes: one query token per sequence, q [B, H, d], attends over
// the first lengths[b] rows of its sequence's dense cache; rows at or past
// the length are masked, and a sequence of length 0 gives zeros.
//
// What bounds it on the H100: bytes.  Each K/V row is read once and used
// for G dot products (G = 3 for smollm-135m, 4 for llama3-8b, 8 for
// gemma-2b): about G * 2 operations per byte, far below the ~295 per byte
// at which the tensor cores would matter, so no tensor cores here (an
// m16n8k16 tile would also be at least half empty with G <= 8 rows).  The
// least time is the K/V bytes the lengths select over 3.35 TB/s; at serving
// sizes that is under a microsecond, so what the kernel can win is latency:
// many blocks in flight, each issuing all its loads at once.
//
// What this design does about it: the split-KV body of decode_split.cuh
// (spans of split_rows(d) rows across blocks, 16-byte loads by lane
// groups, a fixed-order merge in a second launch), with the DenseRows row
// source: k and v arrive as strided views of the model's [B, T, KV, d]
// layer cache (only the head dim must be contiguous, rows 16-byte
// aligned), so the cache is read in its storage layout and nothing is
// transposed per step.  paged_decode_attention.cu runs the same body over
// its page arena, so the two give the same bits over the same rows.
//
// Two more entries serve a cache whose sequence axis is split over the
// model ranks (flash-decoding across ranks; the reference's dry run places
// every decode cache so):
//   * repro_decode_attention_slice: the same two launches over one rank's
//     rows [B, KV, T_r, d] (lengths counted within the slice, 0 where the
//     slice holds none of a sequence's rows), writing the merged output in
//     fp32 and each (b, query head)'s log-sum-exp, fp32 (-inf for no
//     rows).  Bound: as the one-rank kernel, the slice's selected K/V bytes
//     over the memory rate.
//   * repro_decode_merge_ranks: the second launch alone over R ranks'
//     gathered (o, lse) [R, B, H, d] and [R, B, H], in rank order, skipping
//     a rank with no rows, into [B, H, d] in the cache's dtype.  Bound:
//     R (d + 1) fp32 reads and one write per (b, head): bytes.

#include "decode_split.cuh"

namespace {

template <typename T, typename TO = T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const void* lens, void* part_acc, void* part_ml, void* out,
                         int B, int H, int KV, int d, int T_len, int n_splits,
                         CacheStrides ks, CacheStrides vs, cudaStream_t stream,
                         float* lse = nullptr) {
  const DenseRows<T> rows{static_cast<const T*>(k), static_cast<const T*>(v), ks, vs};
  return launch_decode<T, DenseRows<T>, TO>(q, rows, lens, part_acc, part_ml, out, B,
                                            H, KV, d, T_len, n_splits, stream, lse);
}

bool dense_args_ok(const void* q, const void* k, const void* v, const void* out,
                   int dtype, int64_t k_sb, int64_t k_st, int64_t k_sh, int64_t v_sb,
                   int64_t v_st, int64_t v_sh) {
  const int64_t vec = dtype == 0 ? 4 : 8;
  return aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out) &&
         !(k_sb % vec || k_st % vec || k_sh % vec || v_sb % vec || v_st % vec ||
           v_sh % vec);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  k and v strides are in elements
// over the (batch, row, KV head) axes of the caller's cache view; the head
// dim is contiguous, and q, k, v and every stride start rows on 16 bytes
// (else cudaErrorMisalignedAddress).  d is 64, 80, 128 or 256; H / KV <= 8.
// split must be split_rows(d) and n_splits = ceil(T / split); part_acc holds
// B * KV * n_splits * (H / KV) * d floats and part_ml twice
// B * KV * n_splits * (H / KV).  Two launches on the stream; returns the
// first failing cudaError_t (0 on success).
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* part_acc, void* part_ml, void* out, int B, int H, int KV, int d,
    int T_len, int split, int n_splits, int64_t k_sb, int64_t k_st, int64_t k_sh,
    int64_t v_sb, int64_t v_st, int64_t v_sh, int dtype, void* stream) {
  if (!decode_args_ok(B, H, KV, d, T_len, split, n_splits) ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!dense_args_ok(q, k, v, out, dtype, k_sb, k_st, k_sh, v_sb, v_st, v_sh))
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto s = static_cast<cudaStream_t>(stream);
  const CacheStrides ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  if (dtype == 0)
    return static_cast<int>(launch_typed<float>(q, k, v, lengths, part_acc, part_ml,
                                                out, B, H, KV, d, T_len, n_splits,
                                                ks, vs, s));
  return static_cast<int>(launch_typed<__nv_bfloat16>(q, k, v, lengths, part_acc,
                                                       part_ml, out, B, H, KV, d,
                                                       T_len, n_splits, ks, vs, s));
}

// The slice entry: as repro_decode_attention over one rank's T_len rows,
// but out is [B, H, d] fp32 whatever q's dtype, and lse [B, H] fp32
// receives each row's log-sum-exp.
extern "C" int repro_decode_attention_slice(
    const void* q, const void* k, const void* v, const void* lengths,
    void* part_acc, void* part_ml, void* out, void* lse, int B, int H, int KV, int d,
    int T_len, int split, int n_splits, int64_t k_sb, int64_t k_st, int64_t k_sh,
    int64_t v_sb, int64_t v_st, int64_t v_sh, int dtype, void* stream) {
  if (!decode_args_ok(B, H, KV, d, T_len, split, n_splits) ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!dense_args_ok(q, k, v, out, dtype, k_sb, k_st, k_sh, v_sb, v_st, v_sh))
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto s = static_cast<cudaStream_t>(stream);
  const CacheStrides ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  auto* lp = static_cast<float*>(lse);
  if (dtype == 0)
    return static_cast<int>(launch_typed<float, float>(
        q, k, v, lengths, part_acc, part_ml, out, B, H, KV, d, T_len, n_splits, ks,
        vs, s, lp));
  return static_cast<int>(launch_typed<__nv_bfloat16, float>(
      q, k, v, lengths, part_acc, part_ml, out, B, H, KV, d, T_len, n_splits, ks, vs,
      s, lp));
}

// The rank merge: o [R, B, H, d] and lse [R, B, H] fp32, contiguous, into
// out [B, H, d] (dtype 0 = float32, 1 = bfloat16).  One launch.
extern "C" int repro_decode_merge_ranks(const void* o, const void* lse, void* out,
                                        int R, int B, int H, int d, int dtype,
                                        void* stream) {
  if (R < 1 || B < 1 || H < 1 || H > 65535 || d < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* op = static_cast<const float*>(o);
  const auto* lp = static_cast<const float*>(lse);
  if (dtype == 0)
    return static_cast<int>(launch_merge_ranks<float>(op, lp, out, R, B, H, d, s));
  return static_cast<int>(launch_merge_ranks<__nv_bfloat16>(op, lp, out, R, B, H, d, s));
}
