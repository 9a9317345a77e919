"""The port's two attention kernel families on the CPU, where each op runs
its plain twin: held against the JAX Pallas kernels in interpret mode and
against their JAX `ref.py` oracles on the same inputs (made with numpy
from a seed; bfloat16 carried as its bits), over the shape sweeps of
`tests/test_kernels.py` plus a GQA group of 3 (smollm-360m's 15 query
heads over 5 KV heads), ragged lengths and the decode step's own JAX
form.  Tolerances are `tests/test_kernels.py`'s: float32 2e-4, bfloat16
3e-2 (the Pallas kernels round p to bfloat16 before P.V; the twins keep
it in float32)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_attention_kernel
from repro.kernels.decode_attention.ref import decode_ref
from repro.kernels.flash_attention.kernel import flash_attention_kernel
from repro.kernels.flash_attention.ref import attention_ref
from repro.models import attention as jattn
from repro_torch import kernels as tk
from repro_torch.kernels.decode_attention import ops as t_da
from repro_torch.kernels.flash_attention import ops as t_fa

TOLS = {"float32": dict(rtol=2e-4, atol=2e-4),
        "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _both(x: np.ndarray, dtype: str):
    """One float32 numpy array as the same values in JAX and in torch:
    bfloat16 is rounded once (by JAX) and its bits carried across."""
    if dtype == "float32":
        return jnp.asarray(x), torch.from_numpy(x.copy())
    j = jnp.asarray(x).astype(jnp.bfloat16)
    bits = np.asarray(j).view(np.uint16).copy()
    return j, torch.from_numpy(bits).view(torch.bfloat16)


def _qkv(seed, q_shape, kv_shape, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in (q_shape, kv_shape, kv_shape)]
    return [_both(a, dtype) for a in arrs]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,S,H,KV,hd,bq,bk", [
    (1, 128, 2, 2, 32, 64, 64),
    (2, 256, 4, 2, 64, 128, 64),
    (2, 192, 6, 3, 32, 64, 32),     # uneven head group
    (1, 64, 8, 1, 16, 32, 16),      # MQA
    (2, 96, 15, 5, 16, 32, 32),     # GQA group of 3, smollm-360m's heads
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_twin_matches_pallas_and_ref(B, S, H, KV, hd, bq, bk, dtype):
    (jq, tq), (jk, tk_), (jv, tv) = _qkv(B * S + H, (B, S, H, hd),
                                         (B, S, KV, hd), dtype)
    got = t_fa.flash_attention(tq, tk_, tv)
    assert got.dtype == tq.dtype and got.shape == (B, S, H, hd)
    pallas = flash_attention_kernel(jq, jk, jv, block_q=bq, block_k=bk,
                                    interpret=True)
    ref = attention_ref(jq, jk, jv)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **TOLS[dtype])
    np.testing.assert_allclose(_f32(got), _f32(ref), **TOLS[dtype])


def test_flash_twin_noncausal_and_model_path():
    """Non-causal against the Pallas kernel; causal against the JAX
    model's own XLA form (`causal_blocked_attention`, repeated KV) and
    against itself on repeated KV heads."""
    (jq, tq), (jk, tk_), (jv, tv) = _qkv(9, (1, 128, 2, 32), (1, 128, 2, 32),
                                         "float32")
    got = t_fa.flash_attention(tq, tk_, tv, causal=False)
    want = flash_attention_kernel(jq, jk, jv, block_q=64, block_k=64,
                                  causal=False, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOLS["float32"])
    (jq, tq), (jk, tk_), (jv, tv) = _qkv(3, (2, 64, 6, 16), (2, 64, 2, 16),
                                         "float32")
    want = jattn.causal_blocked_attention(
        jq, jattn.repeat_kv(jk, 6), jattn.repeat_kv(jv, 6), chunk_q=32,
        chunk_k=32)
    np.testing.assert_allclose(_f32(t_fa.flash_attention(tq, tk_, tv)),
                               _f32(want), **TOLS["float32"])
    # reading KV head h // G is what repeating the KV heads gives
    from repro_torch.models.attention import repeat_kv
    np.testing.assert_allclose(
        _f32(t_fa.flash_attention(tq, repeat_kv(tk_, 6), repeat_kv(tv, 6))),
        _f32(t_fa.flash_attention(tq, tk_, tv)), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_f32(repeat_kv(tk_, 6)),
                                  _f32(jattn.repeat_kv(jk, 6)))


@pytest.mark.parametrize("S,T", [(100, 100), (37, 37), (24, 61), (1, 50)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_twin_ragged_lengths(S, T, dtype):
    """S and T that are multiples of no tile (the Pallas kernel asserts
    divisibility), and S < T with the reference's bottom-right causal
    alignment, against the JAX oracle."""
    (jq, tq), (jk, tk_), (jv, tv) = _qkv(S * T, (2, S, 6, 16), (2, T, 2, 16),
                                         dtype)
    np.testing.assert_allclose(_f32(t_fa.flash_attention(tq, tk_, tv)),
                               _f32(attention_ref(jq, jk, jv)),
                               **TOLS[dtype])


def _lens(B, T, seed):
    clen = np.random.RandomState(seed).randint(1, T + 1, B).astype(np.int32)
    clen[0] = T
    clen[-1] = 1
    return clen


@pytest.mark.parametrize("B,T,H,KV,hd,bk", [
    (2, 256, 4, 2, 32, 64),
    (3, 512, 8, 4, 64, 128),
    (1, 128, 2, 1, 16, 32),
    (3, 96, 15, 5, 16, 32),         # GQA group of 3
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_twin_matches_pallas_and_ref(B, T, H, KV, hd, bk, dtype):
    (jq, tq), (jk, tk_), (jv, tv) = _qkv(T + H, (B, 1, H, hd),
                                         (B, T, KV, hd), dtype)
    clen = _lens(B, T, T)
    got = t_da.decode_attention(tq, tk_, tv, torch.from_numpy(clen))
    assert got.dtype == tq.dtype and got.shape == (B, 1, H, hd)
    jl = jnp.asarray(clen)
    pallas = decode_attention_kernel(jq, jk, jv, jl, block_k=bk,
                                     interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **TOLS[dtype])
    np.testing.assert_allclose(_f32(got), _f32(decode_ref(jq, jk, jv, jl)),
                               **TOLS[dtype])


@pytest.mark.parametrize("T", [544, 97, 1])
def test_decode_twin_matches_model_decode_ragged(T):
    """Any T (the serve capacity P + G = 544 is no multiple of the Pallas
    block of 512), against the JAX decode step's own form."""
    B = 3
    (jq, tq), (jk, tk_), (jv, tv) = _qkv(T, (B, 1, 6, 16), (B, T, 2, 16),
                                         "float32")
    clen = _lens(B, T, 1)
    got = t_da.decode_attention(tq, tk_, tv, torch.from_numpy(clen))
    want = jattn.decode_attention(jq, jk, jv, jnp.asarray(clen))
    np.testing.assert_allclose(_f32(got), _f32(want), **TOLS["float32"])


def test_decode_twin_empty_cache_is_zero_not_nan():
    (_, tq), (_, tk_), (_, tv) = _qkv(0, (2, 1, 4, 16), (2, 8, 2, 16),
                                      "float32")
    out = t_da.decode_attention(tq, tk_, tv,
                                torch.tensor([0, 3], dtype=torch.int32))
    assert torch.isfinite(out).all()
    assert torch.equal(out[0], torch.zeros_like(out[0]))


def test_cpu_attention_ops_launch_nothing_and_reject_other_devices():
    tk.reset_launch_counts()
    (_, tq), (_, tk_), (_, tv) = _qkv(1, (1, 8, 2, 16), (1, 8, 1, 16),
                                      "float32")
    t_fa.flash_attention(tq, tk_, tv)
    t_da.decode_attention(tq[:, :1], tk_, tv,
                          torch.tensor([5], dtype=torch.int32))
    assert tk.launch_counts() == {name: 0 for name in tk.OPS}
    with pytest.raises(ValueError, match="unsupported device"):
        t_fa.flash_attention(tq.to("meta"), tk_.to("meta"), tv.to("meta"))
