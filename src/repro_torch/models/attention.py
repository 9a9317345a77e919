"""Attention of the dense LM (the port of `repro.models.attention`): GQA
projections with optional bias and qk-norm, causal self-attention for
prefill, single-token decode against a KV cache, and the training
attention.

Prefill and decode go through the port's hand-written kernels (a CPU
tensor runs their plain twins): causal self-attention through
`kernels.flash_attention` — the JAX model reaches the Pallas kernel only
with `attention_impl="pallas"` and otherwise computes the same function
with `causal_blocked_attention`, so the port has one prefill path for
both — and decode through `kernels.decode_attention`, the function of
the JAX `decode_attention` (DESIGN.md §3).  Neither repeats the KV
heads: the kernels read query head h's KV head as h // (H // KV).

Training differentiates through `causal_blocked_attention`, the port of
the JAX XLA path (`_chunk_update`, `chunked_attention`): plain torch ops
under autograd, an online softmax over key chunks of `chunk_k` with
padded key slots at position 2**30, query chunks of `chunk_q` that skip
the key chunks wholly in their future (a skipped chunk is an exact no-op
of the update), and score/exp intermediates in `acc_dtype`.  It is not
the flash kernel's twin: JAX cannot differentiate its Pallas kernel
either, so training never reaches a kernel.  The JAX forms' `unroll`
(the roofline variant) and `cn` (a sharding constrainer) have no meaning
on one card and are dropped.

The non-causal forms, the encoder's self-attention and the
cross-attention of a prefill or a training step, are plain torch ops as
in JAX, which computes them outside any Pallas kernel: `full_attention`
(the (B,H,S,T) scores materialized), or `chunked_attention` with
`causal=False` where S·T > 2**22 (`models/lm._attn_mixer`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention.ops import \
    decode_attention as _decode_op
from repro_torch.kernels.flash_attention.ops import \
    flash_attention as _flash_op
from repro_torch.models.common import ParamSpec, apply_rope, rms_norm, upcast

NEG_INF = -1e30
PAD_POS = 2 ** 30          # position of a padded key slot: never attended


def attention_params(cfg, *, cross: bool = False, dtype=torch.bfloat16):
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": ParamSpec((D, H, hd), dtype, ("embed", "heads", "head_dim")),
        "wk": ParamSpec((D, KV, hd), dtype, ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((D, KV, hd), dtype, ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, hd, D), dtype, ("heads", "head_dim", "embed")),
        "pre_norm": ParamSpec((D,), torch.float32, ("unsharded",), "ones"),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamSpec((H, hd), dtype, ("heads", "head_dim"), "zeros")
        p["bk"] = ParamSpec((KV, hd), dtype, ("kv_heads", "head_dim"), "zeros")
        p["bv"] = ParamSpec((KV, hd), dtype, ("kv_heads", "head_dim"), "zeros")
    if cfg.qk_norm:
        p["q_norm"] = ParamSpec((hd,), torch.float32, ("unsharded",), "ones")
        p["k_norm"] = ParamSpec((hd,), torch.float32, ("unsharded",), "ones")
    return p


def _proj(x, w):
    """einsum("bsd,dhk->bshk", x, w) as one matrix product."""
    D, Hn, hd = w.shape
    return (x @ w.reshape(D, Hn * hd)).unflatten(-1, (Hn, hd))


def _project_qkv(p, x, ctx, cfg, positions, ctx_positions, *, rope: bool):
    """x: (B,S,D) -> q: (B,S,H,hd); ctx: (B,T,D) -> k, v: (B,T,KV,hd).
    `p` maps parameter names to tensors."""
    q = _proj(x, p["wq"])
    k = _proj(ctx, p["wk"])
    v = _proj(ctx, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, ctx_positions, cfg.rope_theta)
    return q, k, v


def repeat_kv(k, num_heads: int):
    """(B,T,KV,hd) -> (B,T,H,hd), KV head j serving heads j*G..j*G+G-1.
    The kernels never need it (they index the KV head); kept for the
    paths that materialize the repeat."""
    kv = k.shape[2]
    if kv == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // kv, dim=2)


def causal_attention(q, k, v):
    """Causal self-attention over aligned q/k (prefill): q (B,S,H,hd),
    k, v (B,S,KV,hd) -> (B,S,H,hd), on the flash-attention kernel."""
    return _flash_op(q, k, v, causal=True)


def decode_attention(q, k_cache, v_cache, cache_len):
    """q: (B,1,H,hd); caches: (B,T,KV,hd); positions < cache_len[b]
    attended.  On the decode-attention kernel."""
    return _decode_op(q, k_cache, v_cache, cache_len.to(torch.int32))


def full_attention(q, k, v, *, q_pos=None, k_pos=None, causal=True):
    """Attention with the (B,H,S,T) scores materialized: q (B,S,H,hd),
    k/v (B,T,H,hd).  With positions, causal masks keys past each query's
    position (or nothing when not causal); without, causal is the
    bottom-right mask (query i sees keys up to i + T - S).  Scores and
    softmax in float32, the probabilities cast to q's dtype for the
    product with v, as in JAX."""
    hd = q.shape[-1]
    s = upcast(torch.einsum("bshk,bthk->bhst", q, k)) / (hd ** 0.5)
    if q_pos is not None:
        if causal:
            mask = k_pos[:, None, :] <= q_pos[:, :, None]
            s = torch.where(mask[:, None], s, NEG_INF)
    elif causal:
        S, T = q.shape[1], k.shape[1]
        mask = torch.ones((S, T), dtype=torch.bool,
                          device=q.device).tril(T - S)
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthk->bshk", p.to(q.dtype), v)


# ---------------------------------------------------------------------------
# Training attention (differentiable, no kernel)
# ---------------------------------------------------------------------------

def _chunk_update(q, kc, vc, m, l, acc, smask, acc_dtype=torch.float32):
    """One online-softmax update. q:(B,S,H,hd), kc/vc:(B,ck,H,hd),
    smask:(B,S,ck) bool or None.  The m/l/acc carries stay float32; with
    acc_dtype=bf16 the (B,H,S,ck) score/exp intermediates are bf16."""
    hd = q.shape[-1]
    s = torch.einsum("bshk,bthk->bhst", q, kc).float() / (hd ** 0.5)
    if smask is not None:
        s = torch.where(smask[:, None], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    e = torch.exp((s - m_new[..., None]).to(acc_dtype).float()).to(acc_dtype)
    l_new = l * corr + e.sum(dim=-1, dtype=torch.float32)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bhst,bthk->bhsk", e, vc.to(acc_dtype)).float()
    return m_new, l_new, acc_new


def _pad_keys(k, v, k_pos, ck):
    """Pad the key axis to a whole number of `ck` chunks, the padded
    slots at position PAD_POS."""
    T = k.shape[1]
    Tp = -(-T // ck) * ck
    if Tp != T:
        k = F.pad(k, (0, 0, 0, 0, 0, Tp - T))
        v = F.pad(v, (0, 0, 0, 0, 0, Tp - T))
        k_pos = F.pad(k_pos, (0, Tp - T), value=PAD_POS)
    return k, v, k_pos


def _attend(q, k, v, q_pos, k_pos, ck, nk, causal, acc_dtype):
    """The online softmax of q over the first `nk` key chunks of width
    `ck` (k, v, k_pos already padded).  Returns (B,S,H,hd) in q's dtype."""
    B, S, H, hd = q.shape
    dev = q.device
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, S, hd), dtype=torch.float32, device=dev)
    for i in range(nk):
        sl = slice(i * ck, (i + 1) * ck)
        kp = k_pos[:, sl]
        if causal:
            smask = kp[:, None, :] <= q_pos[:, :, None]
        else:       # non-causal: only exclude padded key slots
            smask = (kp < PAD_POS)[:, None, :].expand(B, S, kp.shape[1])
        m, l, acc = _chunk_update(q, k[:, sl], v[:, sl], m, l, acc, smask,
                                  acc_dtype)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)                  # (B,S,H,hd)


def chunked_attention(q, k, v, *, q_pos, k_pos, causal=True,
                      chunk_k=2048, acc_dtype=torch.float32):
    """Flash-style attention over all key chunks with a running softmax:
    q (B,S,H,hd) at positions q_pos (B,S), k/v (B,T,H,hd) at k_pos
    (B,T)."""
    ck = min(chunk_k, k.shape[1])
    k, v, k_pos = _pad_keys(k, v, k_pos, ck)
    return _attend(q, k, v, q_pos, k_pos, ck, k.shape[1] // ck, causal,
                   acc_dtype)


def causal_blocked_attention(q, k, v, *, chunk_q=2048, chunk_k=2048,
                             acc_dtype=torch.float32):
    """Causal self-attention over aligned q/k (B,S,H,hd) at positions
    [0,S), the training path: the key chunks are the JAX scan's (width
    min(chunk_k, S) from 0), and each query chunk of `chunk_q` runs only
    the chunks up to its causal horizon."""
    B, S, H, hd = q.shape
    ck = min(chunk_k, S)
    cq = min(chunk_q, S)
    pos = torch.arange(S, device=q.device)[None].expand(B, S)
    kp, vp, kpos = _pad_keys(k, v, pos, ck)
    outs = []
    for lo in range(0, S, cq):
        hi = min(lo + cq, S)
        outs.append(_attend(q[:, lo:hi], kp, vp, pos[:, lo:hi], kpos, ck,
                            -(-hi // ck), True, acc_dtype))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
