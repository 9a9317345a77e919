"""Public op of the flash-attention family: the causal self-attention of
prefill (`models/attention.py:causal_attention`), as
`repro.kernels.flash_attention.ops.flash_attention` is for the JAX
model's `attention_impl="pallas"` path.

q (B,S,H,hd) against k, v (B,T,KV,hd) with H % KV == 0, no `repeat_kv`:
query head h reads KV head h // (H // KV).  S and T need not be
multiples of any tile.  A CPU tensor runs the twin in `ref.py`; a CUDA
tensor launches the kernel in `csrc/flash_attention.cu` after the
operands are checked (bfloat16 or float32, head_dim 16, 32, 64 or 128,
contiguous, 16-byte aligned), else the op raises.  Every launch adds one
to `flash_attention.launches` and one to
`flash_attention.route_launches[route]` (`kernel.route`: bf16 at
head_dim 64/128 on the tensor cores, the rest scalar).  A fake CUDA
operand (a dry run) is checked the same way, bar the alignment, and
gets an empty output, launching nothing; on the card, real or fake, the
call reports `flops` to `kernels.COST_SINKS`.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as tk
from repro_torch.kernels import is_fake, on_cpu
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref


def check_attention_operands(op: str, q, k, v, q_len: int = None, *,
                             fake: bool = False):
    """Raise unless q (B,S,H,hd) and k, v (B,T,KV,hd) are what the CUDA
    kernels take: one device and one dtype (bfloat16 or float32), H a
    multiple of KV, a supported head_dim, contiguous and 16-byte
    aligned (not asked of `fake` operands, which have no address).
    `q_len` pins S."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{op}: q, k and v must be 4-D (B,S,H,hd)")
    B, S, H, hd = q.shape
    if q_len is not None and S != q_len:
        raise ValueError(f"{op}: q has {S} positions, expected {q_len}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"{op}: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{op}: {H} query heads over {k.shape[2]} KV heads")
    if hd not in K.HEAD_DIMS:
        raise ValueError(f"{op}: head_dim {hd} not in {K.HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in K.DTYPE_CODE or t.dtype != q.dtype:
            raise ValueError(f"{op}: {name} has dtype {t.dtype}; expected "
                             f"one of bfloat16/float32, equal for q, k, v")
        if t.device != q.device:
            raise ValueError(f"{op}: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous() or (not fake and t.data_ptr() % 16):
            raise ValueError(f"{op}: {name} must be contiguous and 16-byte "
                             f"aligned")


def flash_attention(q, k, v, *, causal: bool = True):
    """Blocked online-softmax attention.  Returns (B,S,H,hd) in q's
    dtype; query row i sees key j iff j <= i + T - S when causal."""
    if on_cpu(q, "flash_attention"):
        return ref.flash_attention_ref(q, k, v, causal=causal)
    fake = is_fake(q)
    check_attention_operands("flash_attention", q, k, v, fake=fake)
    out = torch.empty_like(q)
    if tk.COST_SINKS:
        tk.note_cost("flash_attention", flops(q.shape, k.shape[1], causal),
                     (q, k, v, out))
    if fake or q.numel() == 0:
        return out
    r = K.flash_attention(q, k, v, out, causal)
    flash_attention.launches += 1
    flash_attention.route_launches[r] += 1
    return out


def causal_pairs(S: int, T: int) -> int:
    """The (query, key) pairs a causal call attends: query i (of S) sees
    keys j <= i + T - S (of T), the mask aligned to the bottom right."""
    if T >= S:
        return S * (T - S + 1) + S * (S - 1) // 2
    return T * (T + 1) // 2


def flops(q_shape, T: int, causal: bool = True) -> int:
    """The call's floating-point work: 4·B·H·hd per attended (query, key)
    pair (q·k and p·v, a multiply and an add each)."""
    B, S, H, hd = q_shape
    return 4 * B * H * hd * (causal_pairs(S, T) if causal else S * T)


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(K.ROUTES, 0)
