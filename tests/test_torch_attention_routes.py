"""What the two attention launchers decide in Python, before any launch,
checked on the CPU with no card: the route each (dtype, head_dim) takes
(the tensor-core kernels for bfloat16 at head_dim 64 and 128, the scalar
kernels for the rest), the decode kernel's cache splits for a given
number of SMs and resident blocks per SM, the operand checks that guard
both routes, and the per-route launch counters."""
from __future__ import annotations

import math

import pytest
import torch

from repro_torch import kernels as tk
from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ops as fa


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 64, "tensor_core"), (torch.bfloat16, 128, "tensor_core"),
    (torch.bfloat16, 16, "scalar"), (torch.bfloat16, 32, "scalar"),
    (torch.float32, 16, "scalar"), (torch.float32, 32, "scalar"),
    (torch.float32, 64, "scalar"), (torch.float32, 128, "scalar")])
def test_route_by_dtype_and_head_dim(dtype, hd, want):
    assert fk.route(dtype, hd) == want
    assert dk.route(dtype, hd) == want
    assert want in fk.ROUTES and want in dk.ROUTES


def test_serve_configs_take_the_tensor_core_route():
    """smollm-360m, llama3.2-1b and the qwen configs serve in bfloat16 at
    head_dim 64 or 128, so both attention kernels run on the tensor
    cores for them; the reduced configs (head_dim 16) stay scalar."""
    from repro_torch.configs import get_config
    for arch in ("smollm-360m", "llama3.2-1b", "qwen2.5-3b", "qwen3-8b"):
        cfg = get_config(arch)
        assert fk.route(torch.bfloat16, cfg.head_dim) == "tensor_core", arch
        red = cfg.reduced()
        assert fk.route(torch.bfloat16, red.head_dim) == "scalar", arch


# (B, T, KV, SMs, blocks per SM) -> splits.  The serve shape (9 tiles)
# is below two 8-tile splits, so one; the long one (160 pairs, more than
# the SMs) needs none; a lone pair with a long cache gets a split per SM
# down to the 8-tile minimum; B = 1 at 5 KV heads gets ceil(132 / 5) =
# 27; one SM means one split.
@pytest.mark.parametrize("args,want", [
    ((8, 544, 5, 132, 4), 1), ((32, 32768, 5, 132, 4), 1),
    ((32, 32768, 5, 132, 2), 1), ((8, 544, 5, 132, 1), 1),
    ((8, 544, 5, 1, 4), 1), ((32, 32768, 5, 1, 4), 1),
    ((1, 32768, 1, 132, 4), 64), ((1, 32768, 5, 132, 4), 27),
    ((4, 8192, 5, 132, 4), 7), ((8, 4096, 5, 132, 4), 4),
    ((2, 63, 1, 132, 4), 1), ((5, 700, 3, 132, 2), 1),
    ((1, 1, 5, 132, 4), 1), ((1, 0, 5, 132, 4), 1),
    ((1, 4096, 1, 200, 1), 8)])
def test_decode_splits(args, want):
    assert dk.n_splits(*args) == want


@pytest.mark.parametrize("B,T,KV", [(8, 544, 5), (32, 32768, 5),
                                    (1, 1, 1), (3, 4096, 2), (64, 2048, 8),
                                    (1, 32768, 8)])
@pytest.mark.parametrize("sms,bps", [(1, 4), (132, 4), (132, 2), (132, 1)])
def test_decode_splits_fill_one_wave(B, T, KV, sms, bps):
    """The grid stays one wave of resident blocks (unless the pairs alone
    exceed it), splits no cache below the 8-tile minimum, and stops short
    of a block per SM only where the wave or the cache length stops it."""
    ns = dk.n_splits(B, T, KV, sms, bps)
    pairs = B * KV
    top = max(math.ceil(T / dk.TILE_KEYS) // dk.MIN_SPLIT_TILES, 1)
    assert 1 <= ns <= top
    assert pairs * ns <= max(sms * bps, pairs)
    assert (pairs * ns >= sms or ns == top or
            pairs * (ns + 1) > sms * bps)
    assert ns == 1 or pairs * (ns - 1) < sms


def _qkv(q_shape, kv_shape, dtype=torch.bfloat16):
    return (torch.zeros(q_shape, dtype=dtype), torch.zeros(kv_shape, dtype=dtype),
            torch.zeros(kv_shape, dtype=dtype))


def test_operand_checks_accept_both_routes():
    for dtype in (torch.bfloat16, torch.float32):
        for hd in fk.HEAD_DIMS:
            fa.check_attention_operands("flash_attention",
                                        *_qkv((2, 65, 15, hd), (2, 65, 5, hd),
                                              dtype))


@pytest.mark.parametrize("case", ["misaligned", "strided", "head_dim",
                                  "dtype", "groups", "shape"])
def test_operand_checks_reject(case):
    """The checks both routes rely on: 16-byte aligned, contiguous rows
    (the TMA tensor maps and cp.async copies read 16 bytes at a time),
    a head_dim of 16-128, one dtype, H a multiple of KV."""
    q, k, v = _qkv((2, 64, 6, 64), (2, 64, 2, 64))
    if case == "misaligned":
        q = torch.zeros(2 * 64 * 6 * 64 + 1, dtype=torch.bfloat16)[1:] \
            .view(2, 64, 6, 64)
    elif case == "strided":
        k = torch.zeros(2, 64, 4, 64, dtype=torch.bfloat16)[:, :, ::2]
    elif case == "head_dim":
        q, k, v = _qkv((2, 64, 6, 48), (2, 64, 2, 48))
    elif case == "dtype":
        v = v.float()
    elif case == "groups":
        q, k, v = _qkv((2, 64, 5, 64), (2, 64, 2, 64))
    else:
        k = torch.zeros(2, 63, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.check_attention_operands("flash_attention", q, k, v)


def test_route_counters_reset_and_stay_on_the_cpu():
    """A CPU call runs the twin and moves no counter; `route_counts`
    reads the per-route counters, which `reset_launch_counts` zeroes."""
    fa.flash_attention.route_launches["scalar"] = 3
    da.decode_attention.route_launches["tensor_core"] = 2
    assert tk.route_counts()["flash_attention"]["scalar"] == 3
    tk.reset_launch_counts()
    zero = {name: dict.fromkeys(fk.ROUTES, 0) for name in tk.ROUTED}
    assert tk.route_counts() == zero
    q, k, v = _qkv((1, 8, 3, 64), (1, 8, 1, 64))
    fa.flash_attention(q, k, v)
    da.decode_attention(q[:, :1], k, v, torch.tensor([5], dtype=torch.int32))
    assert tk.route_counts() == zero
    assert tk.launch_counts() == {name: 0 for name in tk.OPS}
