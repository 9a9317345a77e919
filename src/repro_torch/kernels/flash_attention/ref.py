"""Plain PyTorch twin of the flash-attention kernel: the same function as
`repro.kernels.flash_attention.ref.attention_ref`, computed in float32
with the scores materialized, GQA read by head index (query head h uses
KV head h // (H // KV), which is what `repeat_kv` gives), and a row with
no visible key returning 0 (its denominator clamped at 1e-30, as the
Pallas kernel clamps it) instead of NaN.

Causal alignment is the reference's: query row i sees key j iff
j <= i + (T - S), which for the model's S == T is j <= i.
"""
from __future__ import annotations

import torch


def masked_softmax_av(s: torch.Tensor, valid: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """softmax(s) · v over the last axis of `s`, with `valid` False
    entries excluded; rows with nothing valid give 0.  s (..., T) float32,
    v broadcastable for `p @ v` (float32)."""
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return (p @ v) / l.clamp_min(1e-30)


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """q: (B,S,H,hd); k, v: (B,T,KV,hd) with H % KV == 0.  Returns
    (B,S,H,hd) in q's dtype; every product and the softmax in float32."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, S, KV, G, hd).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]        # (B,KV,1,T,hd)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    s = (qf @ kf.transpose(-1, -2)) / (hd ** 0.5)         # (B,KV,G,S,T)
    if causal:
        i = torch.arange(S, device=q.device)[:, None]
        j = torch.arange(T, device=q.device)[None, :]
        valid = j <= i + (T - S)
    else:
        valid = torch.ones((S, T), dtype=torch.bool, device=q.device)
    o = masked_softmax_av(s, valid, vf)                   # (B,KV,G,S,hd)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)
