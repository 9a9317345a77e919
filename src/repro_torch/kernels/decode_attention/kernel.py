"""ctypes launcher for the decode-attention CUDA kernel
(`csrc/decode_attention.cu`), which replaces the Pallas kernel
`repro.kernels.decode_attention.kernel.decode_attention_kernel`.

One block per (cache split, KV head, batch row) serves all H // KV query
heads of its KV head, so each cache byte is read once; the last block of
a (batch row, KV head) to finish combines the splits' partial softmaxes.
Two routes, chosen by `route` before the launch as for flash attention:
``"tensor_core"`` (bfloat16 at head_dim 64 or 128; cp.async ring,
mma.sync scores and P.V) and ``"scalar"`` (float32, bfloat16 at
head_dim 16 or 32); both take their cache splits from
`n_splits`.  Given an `lse` tensor, either route also writes each
row's log-sum-exp and `out` in float32 (the (o, lse) form of a
sequence-sharded cache).  The design notes are in the CUDA source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as tk
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.kernel import (DTYPE_CODE, ROUTES,
                                                       route)

MAX_GROUP = 8            # query heads per KV head the kernel serves
TILE_KEYS = 64           # cache rows per tile of the tensor-core route
MIN_SPLIT_TILES = 8      # fewest tiles (512 keys) worth a split of their own
_FNS = {}
_SMS = {}
_OCC = {}
_SCRATCH = {}            # (device, stream) -> (part, counter)


def _fn(name: str):
    if name not in _FNS:
        lib = build.load("decode_attention")
        _FNS["scalar"] = build.bind(lib, "decode_attention", 8, 7)
        _FNS["tensor_core"] = build.bind(lib, "decode_attention_tc", 8, 6)
        occ = lib.decode_attention_tc_occupancy
        occ.argtypes = [ctypes.c_int, ctypes.c_void_p]
        occ.restype = ctypes.c_int
        _FNS["occupancy"] = occ
    return _FNS[name]


def group_pad(G: int) -> int:
    """The scalar route's compiled head-group width: G rounded up to 1,
    2, 4 or 8 (padded heads compute on a zero query and are not
    written)."""
    return 1 if G <= 1 else 2 if G <= 2 else 4 if G <= 4 else 8


def n_splits(B: int, T: int, KV: int, sms: int, blocks_per_sm: int) -> int:
    """Cache splits per (batch row, KV head).

    One streaming block per SM keeps enough cache bytes in flight to
    reach HBM, and every split past that only adds combine work
    (`chip_smoke.py` phase 8 on an H100: one split was as fast as 13 at
    B = 32, T = 32768 and ~1 µs faster than 3 or 4 at B = 8, T = 544,
    while at B = 1, T = 32768 this rule's 27 splits ran 8.7x faster than
    one).  So the grid aims at one block per SM, all of it
    resident at once (one wave at `blocks_per_sm`, the occupancy the
    card reports), with no split shorter than MIN_SPLIT_TILES tiles; a
    batch with a (batch row, KV head) pair per SM or more gets one split.
    T is the cache capacity (cache_len lives on the card and is not
    read)."""
    pairs = max(B * KV, 1)
    tiles = max(-(-T // TILE_KEYS), 1)
    one_per_sm = -(-sms // pairs)
    one_wave = max(sms * blocks_per_sm // pairs, 1)
    return max(1, min(one_per_sm, one_wave, tiles // MIN_SPLIT_TILES))


def _device_index(device) -> int:
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def sm_count(device) -> int:
    idx = _device_index(device)
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def tc_blocks_per_sm(device, hd: int) -> int:
    """Resident blocks per SM of the tensor-core route at head_dim hd,
    from the occupancy calculator on `device` (once per device)."""
    idx = _device_index(device)
    if (idx, hd) not in _OCC:
        n = ctypes.c_int(0)
        with torch.cuda.device(idx):
            rc = _fn("occupancy")(hd, ctypes.addressof(n))
        if rc != 0 or n.value < 1:
            raise RuntimeError(f"decode_attention: occupancy query failed "
                               f"(error {rc}, {n.value} blocks per SM)")
        _OCC[(idx, hd)] = n.value
    return _OCC[(idx, hd)]


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


def decode_attention(q, k_cache, v_cache, cache_len, out,
                     nsplit: int = None, lse=None) -> str:
    """q, out: (B,1,H,hd); caches (B,T,KV,hd); cache_len (B,) int32;
    checked by the op.  With `lse` (B,H) float32, `out` is float32 and
    takes the (o, lse) form.  `nsplit` overrides the split choice
    (timing only).  Returns the route it launched."""
    B, _, H, hd = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    dev = q.device
    r = route(q.dtype, hd)
    if r == "tensor_core":
        ns = nsplit or n_splits(B, T, KV, sm_count(dev),
                                tc_blocks_per_sm(dev, hd))
        rec = H // KV
    else:                       # the scalar route: one wave of one block/SM
        ns = nsplit or n_splits(B, T, KV, sm_count(dev), 1)
        rec = group_pad(H // KV)
    with tk.device_stream(q) as stream:
        if ns > 1:
            part, counter = _scratch(dev, stream,
                                     B * KV * ns * rec * (hd + 2), B * KV)
            p_part, p_ctr = part.data_ptr(), counter.data_ptr()
        else:
            p_part = p_ctr = None
        args = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                cache_len.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), p_part, p_ctr,
                B, T, H, KV, hd)
        if r == "tensor_core":
            rc = _fn(r)(*args, ns, stream)
        else:
            rc = _fn(r)(*args, DTYPE_CODE[q.dtype], ns, stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention ({r} route): CUDA launch "
                           f"failed with error {rc}")
    return r
