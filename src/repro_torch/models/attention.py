"""Attention of the dense LM (the port of `repro.models.attention`): GQA
projections with optional bias and qk-norm, causal self-attention for
prefill, and single-token decode against a KV cache.

Both attention paths go through the port's hand-written kernels (a CPU
tensor runs their plain twins): causal self-attention through
`kernels.flash_attention` — the JAX model reaches the Pallas kernel only
with `attention_impl="pallas"` and otherwise computes the same function
with `causal_blocked_attention`, so the port has one path for both — and
decode through `kernels.decode_attention`, the function of the JAX
`decode_attention` (DESIGN.md §3).  Neither repeats the KV heads: the
kernels read query head h's KV head as h // (H // KV).  `full_attention`
and `chunked_attention` serve only the non-causal encoder and
cross-attention paths, which are not ported yet (ROADMAP.md §1 item 10d).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ops import \
    decode_attention as _decode_op
from repro_torch.kernels.flash_attention.ops import \
    flash_attention as _flash_op
from repro_torch.models.common import ParamSpec, apply_rope, rms_norm


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
