"""Public op of the decode-attention family: one query token against a KV
cache, what `models/attention.py:decode_attention` calls once per layer
per generated token (the JAX model computes the same function in
`repro.models.attention.decode_attention`; the Pallas kernel
`repro.kernels.decode_attention` is its TPU form).

q (B,1,H,hd) against caches (B,T,KV,hd) masked to `cache_len` (B,) int32
(positions >= cache_len[b] are not read), with H // KV <= 8 query heads
per KV head read by head index.  T need not be a multiple of any tile.
A CPU tensor runs the twin in `ref.py`; a CUDA tensor launches the
kernel in `csrc/decode_attention.cu` after the operands are checked,
else the op raises.  Every launch adds one to
`decode_attention.launches` and one to
`decode_attention.route_launches[route]` (`kernel.route`); a launch of
the (o, lse) form (`with_lse=True`, for a cache sharded over its
sequence axis, `models/attention.py`) also adds one to
`decode_attention.lse_launches`.  A fake CUDA operand (a dry run) is
checked the same way, bar the alignment, and gets empty outputs,
launching nothing; on the card, real or fake, the call reports `flops`
to `kernels.COST_SINKS`.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as tk
from repro_torch.kernels import check, is_fake, on_cpu
from repro_torch.kernels.decode_attention import kernel as K
from repro_torch.kernels.decode_attention import ref
from repro_torch.kernels.flash_attention.ops import check_attention_operands


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     with_lse: bool = False):
    """Flash-decode of one token.  Returns (B,1,H,hd) in q's dtype; with
    `with_lse`, (o (B,1,H,hd) float32, lse (B,H) float32), lse the
    log-sum-exp of each row's scaled scores over its valid positions
    (-inf, with o = 0, where cache_len is 0)."""
    if on_cpu(q, "decode_attention"):
        return ref.decode_attention_ref(q, k_cache, v_cache, cache_len,
                                        with_lse=with_lse)
    fake = is_fake(q)
    check_attention_operands("decode_attention", q, k_cache, v_cache,
                             q_len=1, fake=fake)
    B, _, H, _ = q.shape
    if H // k_cache.shape[2] > K.MAX_GROUP:
        raise ValueError(f"decode_attention: {H // k_cache.shape[2]} query "
                         f"heads per KV head, at most {K.MAX_GROUP}")
    check("decode_attention", "cache_len", cache_len, torch.int32, (B,),
          q.device)
    if with_lse:
        out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.empty((B, H), dtype=torch.float32, device=q.device)
    else:
        out, lse = torch.empty_like(q), None
    if tk.COST_SINKS:
        tk.note_cost("decode_attention", flops(q.shape, k_cache.shape[1]),
                     (q, k_cache, v_cache, cache_len, out, lse))
    if fake or q.numel() == 0:
        return (out, lse) if with_lse else out
    r = K.decode_attention(q, k_cache, v_cache, cache_len, out, lse=lse)
    decode_attention.launches += 1
    decode_attention.route_launches[r] += 1
    if with_lse:
        decode_attention.lse_launches += 1
        return out, lse
    return out


decode_attention.launches = 0
decode_attention.route_launches = dict.fromkeys(K.ROUTES, 0)
decode_attention.lse_launches = 0


def flops(q_shape, T: int) -> int:
    """The call's floating-point work: 4·H·hd per (batch row, cache
    position) pair, over all T positions of the cache.  The valid ones,
    cache_len[b], live on the card, and reading them would stop the
    host; so, as JAX's cost analysis of a masked read does, the whole
    capacity is counted, on a real launch as on a fake one."""
    B, _, H, hd = q_shape
    return 4 * B * H * hd * T
