"""ctypes launcher for the flash-attention CUDA kernel
(`csrc/flash_attention.cu`), which replaces the Pallas kernel
`repro.kernels.flash_attention.kernel.flash_attention_kernel`.

Two routes, chosen by `route` from the dtype and head_dim before the
launch (not a fallback: a failed build or launch raises):

* ``"tensor_core"`` (bfloat16 at head_dim 64 or 128: smollm,
  llama3.2-1b, the qwen configs): `flash_attention_tc`, one block per
  128-row query tile, TMA loads of 128-key tiles into a 2-stage
  shared-memory ring, both products on wgmma;
* ``"scalar"`` (float32, and bfloat16 at head_dim 16 or 32, the reduced
  test configs): `flash_attention`, the scalar-FMA kernel.

The design notes are in the CUDA source.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as tk
from repro_torch.kernels import build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
TC_HEAD_DIMS = (64, 128)
ROUTES = ("tensor_core", "scalar")
_FNS = {}


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel route for a dtype and head_dim the op accepts."""
    if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS:
        return "tensor_core"
    return "scalar"


def _fn(name: str):
    if name not in _FNS:
        lib = build.load("flash_attention")
        _FNS["scalar"] = build.bind(lib, "flash_attention", 4, 8)
        _FNS["tensor_core"] = build.bind(lib, "flash_attention_tc", 4, 7)
    return _FNS[name]


def flash_attention(q, k, v, out, causal: bool) -> str:
    """q, out: (B,S,H,hd); k, v: (B,T,KV,hd); checked by the op.
    Returns the route it launched."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    r = route(q.dtype, hd)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    with tk.device_stream(q) as stream:
        if r == "tensor_core":
            rc = _fn(r)(*ptrs, B, S, T, H, KV, hd, int(causal), stream)
        else:
            rc = _fn(r)(*ptrs, B, S, T, H, KV, hd, DTYPE_CODE[q.dtype],
                        int(causal), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention ({r} route): CUDA launch "
                           f"failed with error {rc}")
    return r
