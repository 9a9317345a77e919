"""ctypes launcher for the flash-attention CUDA kernel
(`csrc/flash_attention.cu`), which replaces the Pallas kernel
`repro.kernels.flash_attention.kernel.flash_attention_kernel`.

One block per (64-row query tile, query head, batch row) loops over the
64-key tiles up to the causal diagonal with the running max, denominator
and float32 accumulator in registers.  The design notes are in the CUDA
source.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
_FNS = {}


def _fn():
    if "f" not in _FNS:
        _FNS["f"] = build.bind(build.load("flash_attention"),
                               "flash_attention", 4, 8)
    return _FNS["f"]


def flash_attention(q, k, v, out, causal: bool) -> None:
    """q, out: (B,S,H,hd); k, v: (B,T,KV,hd); checked by the op."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               B, S, T, H, KV, hd, DTYPE_CODE[q.dtype], int(causal),
               torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: CUDA launch failed with "
                           f"error {rc}")
