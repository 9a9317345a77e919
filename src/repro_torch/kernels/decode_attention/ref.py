"""Plain PyTorch twin of the decode-attention kernel: the same function
as `repro.kernels.decode_attention.ref.decode_ref` and
`repro.models.attention.decode_attention`, one query token against a
(B,T,KV,hd) cache masked to `cache_len`, in float32 with GQA read by
head index.  A zero `cache_len` returns 0, not NaN: the denominator is
clamped at 1e-30 as in the Pallas kernel (the JAX forms, whose masked
scores are -1e30 rather than excluded, average the whole cache there).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import masked_softmax_av


def decode_attention_ref(q, k_cache, v_cache, cache_len, *,
                         with_lse: bool = False):
    """q: (B,1,H,hd); caches: (B,T,KV,hd); cache_len: (B,) int.  Returns
    (B,1,H,hd) in q's dtype; with `with_lse`, (o (B,1,H,hd) float32, lse
    (B,H) float32), lse the log-sum-exp of the scaled scores over the
    valid positions (-inf, with o = 0, where there are none)."""
    B, _, H, hd = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qf = q.float().reshape(B, 1, KV, G, hd).permute(0, 2, 3, 1, 4)
    kf = k_cache.float().permute(0, 2, 1, 3)[:, :, None]  # (B,KV,1,T,hd)
    vf = v_cache.float().permute(0, 2, 1, 3)[:, :, None]
    s = (qf @ kf.transpose(-1, -2)) / (hd ** 0.5)         # (B,KV,G,1,T)
    valid = (torch.arange(T, device=q.device)[None, :] <
             cache_len.to(q.device).long()[:, None])      # (B,T)
    mask = valid[:, None, None, None, :]
    o = masked_softmax_av(s, mask, vf)
    o = o.permute(0, 3, 1, 2, 4).reshape(B, 1, H, hd)
    if not with_lse:
        return o.to(q.dtype)
    lse = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    return o, lse.reshape(B, H)
