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
(the roofline variant) is dropped.

On a mesh (DESIGN.md §4) q, K/V and the caches are DTensors, and each
kernel runs on the rank's local shard under a sharding rule of its own:

* flash (`causal_attention`): q as placed (batch, and heads over
  "model"; under the `long` profile the sequence over ("data",
  "model")); K/V gathered over the sequence and, where `kv_heads`
  divides the head shards, sharded like the heads, else whole, with the
  rank's query heads [h0, h0 + H_l) reading KV head h0 // G (or the
  repeated K/V sliced where a shard's heads span groups unevenly); a
  rank holding query block r of S_l runs the kernel against keys [0,
  (r+1) S_l), whose causal mask the kernel aligns to the bottom right;
* decode (`decode_attention`): `cn` pins the cache to (batch, kv_seq,
  whole heads, head_dim), JAX's two constraint sites; q gathered to the
  cache's batch placement (and heads, for a head-sharded cross
  cache); each rank runs the (o, lse) form on its
  `kv_seq` shard with cache_len clamped to the shard (cache_len -
  offset in [0, T_local]), and `merge_partials` combines the shards:
  an all-reduce of the max log-sum-exp, then one of the weighted
  outputs and weights, over each mesh axis that shards `kv_seq` in turn
  (one axis, or ("data", "model") under `long`).

The non-causal forms, the encoder's self-attention and the
cross-attention of a prefill or a training step, are plain torch ops as
in JAX, which computes them outside any Pallas kernel: `full_attention`
(the (B,H,S,T) scores materialized), or `chunked_attention` with
`causal=False` where S·T > 2**22 (`models/lm._attn_mixer`).

On a mesh the training attention and the non-causal forms run, like
flash, on the rank's share (`local_attention`: q as placed, K/V
gathered over the sequence onto q's rows and heads), under autograd;
a query block of a sequence-sharded profile passes its offset to
`causal_blocked_attention`.  A cross cache keeps its sequence whole and
shards its KV heads, so `decode_attention` runs the plain form on the
rank's heads there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention.ops import \
    decode_attention as _decode_op
from repro_torch.kernels.flash_attention.ops import \
    flash_attention as _flash_op
from repro_torch.models.common import ParamSpec, apply_rope, rms_norm, upcast
from repro_torch.sharding.axes import even_grad, is_dtensor, split_dim

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
    return split_dim(x @ even_grad(w.reshape(D, Hn * hd), 1, Hn), -1,
                     (Hn, hd))


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
    k, v (B,S,KV,hd) -> (B,S,H,hd), on the flash-attention kernel (on a
    mesh, the rank's local shard of it: the module docstring)."""
    if is_dtensor(q):
        return _flash_sharded(q, k, v)
    return _flash_op(q, k, v, causal=True)


def _flash_sharded(q, k, v):
    def flash(ql, kl, vl, offset):
        # query block offset // S_l sees the keys up to its end
        kl, vl = kl[:, :offset + ql.shape[1]], vl[:, :offset + ql.shape[1]]
        return _flash_op(ql.contiguous(), kl.contiguous(), vl.contiguous(),
                         causal=True)
    return local_attention(flash, q, k, v)


def local_attention(fn, q, k, v):
    """`fn(q_l, k_l, v_l, offset)` on this rank's share of DTensors q
    (B,S,H,hd) and k, v (B,T,KV,hd), as a DTensor placed as q: q_l is
    the rank's shard of q as placed (its batch rows, its heads, or under
    a sequence-sharding profile its query block, which starts at
    position `offset`); k_l, v_l are K/V gathered over the sequence, on
    q's batch rows and, where the heads are sharded, on the rank's heads'
    KV heads: sharded like the heads where `kv_heads` divides the head
    shards, else whole, then the one KV head the rank's heads share, or
    the repeated K/V sliced where its heads span groups unevenly.  So
    k_l, v_l hold KV_l heads with H_l % KV_l == 0, and query head h of
    the shard reads KV head h // (H_l // KV_l).  Differentiable: a
    rank's part of a K/V it holds whole is a partial gradient
    (`sharding.axes.local_for`).  Plain tensors (one device) are the
    rank's share whole: `fn(q, k, v, 0)`."""
    if not is_dtensor(q):
        return fn(q, k, v, 0)
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding.axes import from_local, local_for, shard_index

    dm, qp = q.device_mesh, q.placements
    H, KV = q.shape[2], k.shape[2]
    G = H // KV
    hi, hn = shard_index(qp, dm, 2)
    kv_split = hn > 1 and KV % hn == 0
    kp = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else
          Shard(2) if isinstance(p, Shard) and p.dim == 2 and kv_split else
          Replicate() for p in qp]
    kl, vl = local_for(k, kp, qp), local_for(v, kp, qp)
    ql = q.to_local()
    Hl = ql.shape[2]
    if hn > 1 and not kv_split:
        h0 = hi * Hl
        if G % Hl == 0:               # the shard's heads share one KV head
            kl = kl[:, :, h0 // G:h0 // G + 1]
            vl = vl[:, :, h0 // G:h0 // G + 1]
        else:                         # heads span KV groups unevenly
            kl = repeat_kv(kl, H)[:, :, h0:h0 + Hl]
            vl = repeat_kv(vl, H)[:, :, h0:h0 + Hl]
    si, _ = shard_index(qp, dm, 1)
    o = fn(ql, kl, vl, si * ql.shape[1])
    return from_local(o.contiguous(), qp, dm, q.shape)


def decode_attention(q, k_cache, v_cache, cache_len, cn=None):
    """q: (B,1,H,hd); caches: (B,T,KV,hd); positions < cache_len[b]
    attended.  On the decode-attention kernel; with DTensor caches, on
    each rank's shard of them (the module docstring), `cn` pinning them
    (JAX's `cn` sites) and `cache_len` a (B,) tensor every rank holds
    whole."""
    if not is_dtensor(k_cache):
        return _decode_op(q, k_cache, v_cache, cache_len.to(torch.int32))
    if cn is not None:
        k_cache = cn(k_cache, "batch", "kv_seq", None, "head_dim")
        v_cache = cn(v_cache, "batch", "kv_seq", None, "head_dim")
    return _decode_sharded(q, k_cache, v_cache, cache_len)


def _decode_sharded(q, k, v, cache_len):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding.axes import (all_reduce, from_local,
                                           shard_dims, shard_index)

    dm, kp = k.device_mesh, k.placements
    # q to the cache's batch placement and, where the cache shards its
    # KV heads (a cross cache), to the rank's heads; whole elsewhere (cn
    # keeps a self cache's heads whole)
    qp = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
          for p in kp]
    ql = q.redistribute(dm, qp).to_local()
    kl, vl = k.to_local(), v.to_local()
    bi, _ = shard_index(kp, dm, 0)
    Bl, Tl = kl.shape[:2]
    if is_dtensor(cache_len):
        cache_len = cache_len.full_tensor()
    si, sn = shard_index(kp, dm, 1)
    clen = cache_len[bi * Bl:(bi + 1) * Bl].to(torch.int32)
    if sn == 1:
        o = _decode_op(ql.contiguous(), kl, vl, clen)
        return from_local(o.contiguous(), qp, dm, q.shape)
    clen = (clen - si * Tl).clamp(0, Tl).to(torch.int32)
    o, lse = _decode_op(ql.contiguous(), kl, vl, clen, with_lse=True)
    groups = [dm.get_group(i) for i in shard_dims(kp, 1) if dm.size(i) > 1]
    o = merge_partials(o, lse, lambda x, op: all_reduce(x, op, groups))
    return from_local(o.to(q.dtype), qp, dm, q.shape)


def merge_partials(o, lse, reduce):
    """Combine the shards' partial softmaxes: o (..., 1, H, hd) float32
    and lse (..., H) of this rank's shard -> the whole cache's (..., 1,
    H, hd) float32, `reduce(x, op)` reducing over the shards ("max",
    "sum").  One reduction of the max lse, then one of [exp(lse - max) o,
    exp(lse - max)] (..., H, hd+1), divided out.  A shard with no valid
    key (lse -inf) weighs 0; a row with none on any shard gives 0, never
    NaN."""
    m = reduce(lse, "max")
    w = torch.where(torch.isfinite(m), torch.exp(lse - m),
                    torch.zeros_like(lse))
    acc = reduce(torch.cat([o[..., 0, :, :] * w[..., None], w[..., None]],
                           dim=-1), "sum")
    return (acc[..., :-1] / acc[..., -1:].clamp_min(1e-30)).unsqueeze(-3)


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
                             acc_dtype=torch.float32, q_offset: int = 0):
    """Causal self-attention of q (B,S,H,hd) at positions [q_offset,
    q_offset + S) over k/v (B,T,H,hd) at [0,T), the training path: the
    key chunks are the JAX scan's (width min(chunk_k, T) from 0), and
    each query chunk of `chunk_q` runs only the chunks up to its causal
    horizon.  A query block of a sequence-sharded mesh (`q_offset` > 0)
    gives its rows' values of the whole sequence's call: a row's result
    does not depend on the other rows of its chunk, and a chunk wholly
    in its future is an exact no-op."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    ck = min(chunk_k, T)
    cq = min(chunk_q, T)
    kpos = torch.arange(T, device=q.device)[None].expand(B, T)
    qpos = kpos[:, q_offset:q_offset + S]
    kp, vp, kpos = _pad_keys(k, v, kpos, ck)
    outs = []
    for lo in range(0, S, cq):
        hi = min(lo + cq, S)
        outs.append(_attend(q[:, lo:hi], kp, vp, qpos[:, lo:hi], kpos, ck,
                            -(-(q_offset + hi) // ck), True, acc_dtype))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
