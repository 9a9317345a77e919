"""ctypes launcher for the decode-attention CUDA kernel
(`csrc/decode_attention.cu`), which replaces the Pallas kernel
`repro.kernels.decode_attention.kernel.decode_attention_kernel`.

One block per (cache split, KV head, batch row) serves all H // KV query
heads of its KV head, so each cache byte is read once; the last block of
a (batch row, KV head) to finish combines the splits' partial softmaxes.
The design notes are in the CUDA source.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.kernel import DTYPE_CODE

MAX_GROUP = 8            # query heads per KV head the kernel serves
MIN_SPLIT_KEYS = 256     # fewest cache positions worth a block of their own
_FNS = {}
_SMS = {}
_SCRATCH = {}            # (device, stream) -> (part, counter)


def _fn():
    if "f" not in _FNS:
        _FNS["f"] = build.bind(build.load("decode_attention"),
                               "decode_attention", 7, 7)
    return _FNS["f"]


def group_pad(G: int) -> int:
    """The kernel's compiled head-group width: G rounded up to 1, 2, 4
    or 8 (padded heads compute on a zero query and are not written)."""
    return 1 if G <= 1 else 2 if G <= 2 else 4 if G <= 4 else 8


def n_splits(B: int, T: int, KV: int, device) -> int:
    """Cache splits per (batch row, KV head): enough blocks for four per
    SM (whole waves balance better), but no split shorter than
    MIN_SPLIT_KEYS positions."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    want = -(-4 * _SMS[idx] // max(B * KV, 1))
    return max(1, min(want, -(-T // MIN_SPLIT_KEYS)))


def _scratch(dev, stream, n_part: int, n_ctr: int):
    """The split partials (`part`, written before they are read) and the
    per-(batch row, KV head) tickets (`counter`, zeroed when allocated;
    the kernel's combining block resets its ticket to 0), kept per
    device and stream so that launches on one stream, which run in
    order, share them, and grown as needed."""
    key = (dev.index, stream)
    part, ctr = _SCRATCH.get(key, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=dev)
    if ctr is None or ctr.numel() < n_ctr:
        ctr = torch.zeros(n_ctr, dtype=torch.int32, device=dev)
    _SCRATCH[key] = (part, ctr)
    return part, ctr


def decode_attention(q, k_cache, v_cache, cache_len, out) -> None:
    """q, out: (B,1,H,hd); caches (B,T,KV,hd); cache_len (B,) int32;
    checked by the op."""
    B, _, H, hd = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    dev = q.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    ns = n_splits(B, T, KV, dev)
    gp = group_pad(H // KV)
    if ns > 1:
        part, counter = _scratch(dev, stream, B * KV * ns * gp * (hd + 2),
                                 B * KV)
        p_part, p_ctr = part.data_ptr(), counter.data_ptr()
    else:
        p_part = p_ctr = None
    rc = _fn()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
               cache_len.data_ptr(), out.data_ptr(), p_part, p_ctr,
               B, T, H, KV, hd, DTYPE_CODE[q.dtype], ns, stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention: CUDA launch failed with "
                           f"error {rc}")
