"""Plain PyTorch versions of the attention, normalisation and SSD kernels,
and of the flash-attention and rmsnorm backward kernels.

Each function states what its CUDA kernel computes, with no tiling: the
kernel wrappers call these for tensors on the CPU, and ``chip_smoke.py``
holds every kernel against them on the card.  Layouts follow
``repro.kernels.ref`` so the tests compare like with like.
"""

from __future__ import annotations

import math

import torch

# finite mask value (jnp.finfo(float32).min): exp(m_prev - m_new) stays
# NaN-free even when a whole row of scores is masked
NEG_INF = torch.finfo(torch.float32).min


def flash_attention_ref(q, k, v, causal: bool = True, softcap: float = 0.0):
    """q: [B, H, S, d]; k, v: [B, KV, T, d] (GQA: H multiple of KV), T >= S
    when causal.  The causal mask is aligned bottom-right
    (``col <= row + T - S``), so the last query row sees every key.
    Returns [B, H, S, d] in ``q.dtype``."""
    return flash_attention_fwd_ref(q, k, v, causal, softcap)[0]


def _flash_scores(q, k, causal: bool, softcap: float):
    """Masked fp32 scores [B, KV, G, S, T] and, with a softcap, the tanh
    of the capped scores (for the backward), else None."""
    B, H, S, d = q.shape
    KV, T = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, S, d).float()
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) / math.sqrt(d)
    t = None
    if softcap > 0:
        t = torch.tanh(scores / softcap)
        scores = t * softcap
    if causal:
        mask = (torch.arange(T, device=q.device)[None, :]
                <= torch.arange(S, device=q.device)[:, None] + (T - S))
        scores = scores.masked_fill(~mask, NEG_INF)
    return scores, t


def flash_attention_fwd_ref(q, k, v, causal: bool = True, softcap: float = 0.0):
    """:func:`flash_attention_ref` and each query row's log-sum-exp of its
    (scaled, capped, masked) scores, fp32 [B, H, S]: what the training
    forward saves for the backward."""
    B, H, S, d = q.shape
    scores, _ = _flash_scores(q, k, causal, softcap)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, v.float())
    lse = torch.logsumexp(scores, dim=-1).reshape(B, H, S)
    return out.reshape(B, H, S, d).to(q.dtype), lse


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True,
                            softcap: float = 0.0):
    """The gradients of :func:`flash_attention_ref` in the flash-attention-2
    form, step by step (no autograd): the probabilities recomputed from q,
    k and the saved row log-sum-exp ``lse`` [B, H, S], D = rowsum(dO * O),
    dP = dO V^T, dS = P * (dP - D) (times ``1 - tanh^2`` under a softcap),
    then dQ = dS K, dK = dS^T Q and dV = P^T dO, all over the scale
    1/sqrt(d).  GQA: dK and dV sum over each KV head's query heads.  The
    same mask rules as the forward.  Returns (dq, dk, dv) in the inputs'
    dtypes."""
    B, H, S, d = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    scores, t = _flash_scores(q, k, causal, softcap)
    lse_g = lse.reshape(B, KV, G, S).float()
    p = torch.exp(scores - lse_g[..., None])
    if causal:
        mask = (torch.arange(T, device=q.device)[None, :]
                <= torch.arange(S, device=q.device)[:, None] + (T - S))
        p = p.masked_fill(~mask, 0.0)
    dog = do.reshape(B, KV, G, S, d).float()
    og = o.reshape(B, KV, G, S, d).float()
    qg = q.reshape(B, KV, G, S, d).float()
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dog)
    dp = torch.einsum("bkgsd,bktd->bkgst", dog, v.float())
    D = (dog * og).sum(dim=-1)
    ds = p * (dp - D[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    ds = ds / math.sqrt(d)
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, k.float()).reshape(B, H, S, d)
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qg)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention_ref(q, k, v, length):
    """One-token attention against a KV cache.

    q: [B, H, d]; k, v: [B, KV, T, d]; length: int or [B] — number of
    valid cache positions.  Returns [B, H, d]."""
    B, H, d = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, d).float()
    scores = torch.einsum("bkgd,bktd->bkgt", qg, k.float()) / math.sqrt(d)
    length = torch.as_tensor(length, device=q.device).reshape(-1, 1)
    valid = torch.arange(T, device=q.device)[None, :] < length
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", probs, v.float())
    return out.reshape(B, H, d).to(q.dtype)


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, lengths,
                               k_scales=None, v_scales=None):
    """One-token attention against a block-paged KV arena.

    q: [B, H, d]; k_pages, v_pages: [P, ps, KV, d] — one shared arena in
    storage layout (page 0 is the runtime's null page); page_table:
    [B, NB] int physical page per logical block; lengths: int or [B].
    With ``k_scales``/``v_scales`` ([P, ps, KV] float32) the arena is int8
    and each row dequantizes as ``row * scale``.  Returns [B, H, d].
    """
    B, H, d = q.shape
    P, ps, KV, _ = k_pages.shape
    NB = page_table.shape[1]
    if k_scales is not None:
        k_pages = k_pages.float() * k_scales.float()[..., None]
        v_pages = v_pages.float() * v_scales.float()[..., None]
    pt = page_table.long()
    k = k_pages[pt].reshape(B, NB * ps, KV, d).transpose(1, 2)
    v = v_pages[pt].reshape(B, NB * ps, KV, d).transpose(1, 2)
    return decode_attention_ref(q, k, v, lengths)


def rmsnorm_ref(x, scale, eps: float = 1e-6, residual=None):
    """RMSNorm with fp32 statistics; the scale is promoted to fp32 too.
    x: [..., d]; scale: [d].  Returns x's shape and dtype.  With
    ``residual`` (x's shape and dtype) it is the add, then the norm of the
    sum: returns ``(rmsnorm_ref(s), s)`` with ``s = x + residual``."""
    if residual is not None:
        s = x + residual
        return rmsnorm_ref(s, scale, eps), s
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(dt)


def rmsnorm_rstd_ref(x, eps: float = 1e-6):
    """Each row's ``rsqrt(mean(x**2) + eps)`` in fp32, x's leading shape:
    what the training forward saves for the backward."""
    return torch.rsqrt(x.float().square().mean(dim=-1) + eps)


def rmsnorm_bwd_ref(x, scale, dy, eps: float = 1e-6, d_sum=None):
    """The gradients of :func:`rmsnorm_ref`, step by step (no autograd).

    ``x`` is the normalised input (in the residual form, the sum ``s = x
    + r`` the forward returned), ``dy`` the gradient at the output.  Per
    row, with rstd = rsqrt(mean(x^2) + eps), x^ = x * rstd and g = scale *
    dy: dx = rstd * (g - x^ * mean(x^ * g)); ``d_sum``, the gradient
    arriving at the residual form's second output, adds to it (it is then
    the gradient of both x and r).  dscale sums dy * x^ over every row.
    Returns (dx in x's dtype, dscale in scale's dtype)."""
    d = x.shape[-1]
    rstd = rmsnorm_rstd_ref(x, eps)[..., None]
    xhat = x.float() * rstd
    g = dy.float() * scale.float()
    dx = rstd * (g - xhat * (xhat * g).mean(dim=-1, keepdim=True))
    if d_sum is not None:
        dx = dx + d_sum.float()
    dscale = (dy.float() * xhat).reshape(-1, d).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def ssd_scan_ref(xb, B_mat, C_mat, log_decay, h0=None):
    """Sequential scalar-decay SSD (the exact recurrence, one step per row).

    xb: [B, S, H, dh]; B_mat, C_mat: [B, S, ds]; log_decay: [B, S, H];
    h0: optional initial state [B, H, dh, ds].  Per row t:
    ``h = exp(ld_t) h + B_t x_t^T`` and ``y_t = C_t . h``.  Returns
    (y [B, S, H, dh], h_final [B, H, dh, ds]), both float32."""
    Bb, S, H, dh = xb.shape
    ds = B_mat.shape[-1]
    h = (torch.zeros((Bb, H, dh, ds), dtype=torch.float32, device=xb.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        h = torch.exp(log_decay[:, t].float())[:, :, None, None] * h + torch.einsum(
            "bs,bhd->bhds", B_mat[:, t].float(), xb[:, t].float())
        ys.append(torch.einsum("bs,bhds->bhd", C_mat[:, t].float(), h))
    return torch.stack(ys, dim=1), h


def ssd_chunked_ref(xb, B_mat, C_mat, log_decay, chunk: int, h0=None):
    """Chunked scalar-decay SSD, the arithmetic of the JAX mixer's chunked
    branch (``repro.models.ssm._ssd_chunked``): per chunk of Q = min(chunk,
    S) rows, the intra-chunk term ``(C B^T * exp(A_i - A_j) * tril) x``,
    the inter-chunk term ``exp(A_i) C . h_prev`` and the state update
    ``h = exp(A_tot) h_prev + sum_j exp(A_tot - A_j) B_j x_j^T``, with A
    the within-chunk cumulative log decay.  Q must divide S.

    Shapes as :func:`ssd_scan_ref`; returns (y, h_final), float32."""
    Bb, S, H, dh = xb.shape
    ds = B_mat.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    K = S // Q
    xb_c = xb.reshape(Bb, K, Q, H, dh).float()
    B_c = B_mat.reshape(Bb, K, Q, ds).float()
    C_c = C_mat.reshape(Bb, K, Q, ds).float()
    ld_c = log_decay.reshape(Bb, K, Q, H).float()

    A_cum = torch.cumsum(ld_c, dim=2)                        # [B,K,Q,H]
    A_tot = A_cum[:, :, -1, :]                               # [B,K,H]
    cb = torch.einsum("bkis,bkjs->bkij", C_c, B_c)           # [B,K,Q,Q]
    dec = A_cum[:, :, :, None, :] - A_cum[:, :, None, :, :]  # [B,K,Q,Q,H]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xb.device))
    w = torch.where(causal[None, None, :, :, None], torch.exp(dec),
                    torch.zeros((), device=xb.device))
    y_intra = torch.einsum("bkij,bkijh,bkjhd->bkihd", cb, w, xb_c)
    wj = torch.exp(A_tot[:, :, None, :] - A_cum)             # [B,K,Q,H]
    h_chunk = torch.einsum("bkjh,bkjs,bkjhd->bkhds", wj, B_c, xb_c)

    h = (torch.zeros((Bb, H, dh, ds), dtype=torch.float32, device=xb.device)
         if h0 is None else h0.float())
    h_prevs = []
    for k in range(K):                                       # inter-chunk scan
        h_prevs.append(h)
        h = torch.exp(A_tot[:, k])[:, :, None, None] * h + h_chunk[:, k]
    y_inter = torch.einsum("bkis,bkih,bkhds->bkihd", C_c, torch.exp(A_cum),
                           torch.stack(h_prevs, dim=1))
    return (y_intra + y_inter).reshape(Bb, S, H, dh), h


def ssd_ref(xb, B_mat, C_mat, log_decay, chunk: int, h0=None):
    """The plain SSD the ``ssd_scan`` wrapper runs on the CPU, branch for
    branch as the JAX mixer: chunked when min(chunk, S) divides S, the
    exact recurrence otherwise."""
    S = xb.shape[1]
    if S % min(chunk, S) == 0:
        return ssd_chunked_ref(xb, B_mat, C_mat, log_decay, chunk, h0)
    return ssd_scan_ref(xb, B_mat, C_mat, log_decay, h0)
