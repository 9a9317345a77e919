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
`decode_attention.route_launches[route]` (`kernel.route`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import check, on_cpu
from repro_torch.kernels.decode_attention import kernel as K
from repro_torch.kernels.decode_attention import ref
from repro_torch.kernels.flash_attention.ops import check_attention_operands


def decode_attention(q, k_cache, v_cache, cache_len):
    """Flash-decode of one token.  Returns (B,1,H,hd) in q's dtype."""
    if on_cpu(q, "decode_attention"):
        return ref.decode_attention_ref(q, k_cache, v_cache, cache_len)
    check_attention_operands("decode_attention", q, k_cache, v_cache,
                             q_len=1)
    B, _, H, _ = q.shape
    if H // k_cache.shape[2] > K.MAX_GROUP:
        raise ValueError(f"decode_attention: {H // k_cache.shape[2]} query "
                         f"heads per KV head, at most {K.MAX_GROUP}")
    check("decode_attention", "cache_len", cache_len, torch.int32, (B,),
          q.device)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    r = K.decode_attention(q, k_cache, v_cache, cache_len, out)
    decode_attention.launches += 1
    decode_attention.route_launches[r] += 1
    return out


decode_attention.launches = 0
decode_attention.route_launches = dict.fromkeys(K.ROUTES, 0)
