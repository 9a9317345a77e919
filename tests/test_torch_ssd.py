"""The port's SSD scan and SSD mixer against the JAX package on the CPU,
where the `ssd_scan` op runs its plain twin.  Inputs are made with numpy
from a seed and handed to both (bfloat16 rounded once by JAX and carried
as its bits).

- The twin against the Pallas kernel `ssd_scan_kernel` in interpret mode
  (float32 within 2e-5: the two do the same products and sums in another
  order; bfloat16 within 3e-2) and against the per-token oracle
  `ssd_ref` (1e-3, the tolerance of `tests/test_kernels.py`), over the
  shapes of `tests/test_kernels.py` plus one chunk (nc = 1) and a chunk
  that is no multiple of 16.
- The mixer: the port's `ssd_apply` (y and all four states),
  `ssd_decode` and `ssd_reference` against JAX's on carried float32
  weights, over the cases of `tests/test_ssd.py`, the ragged S = 48
  included, and the prefill-then-decode continuation.  float32 within
  1e-4; bfloat16 `ssd_apply` within 3e-2 (the JAX form rounds its
  intra-chunk output and chunk states to bf16, the op keeps them in
  float32)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.ssd_scan.kernel import ssd_scan_kernel
from repro.kernels.ssd_scan.ref import ssd_ref
from repro.models import ssd as jssd
from repro.models.common import init_tree
from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan import ops as t_ss
from repro_torch.models import ssd as tssd

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


def _both(x: np.ndarray, dtype: str = "float32"):
    """One float32 array as the same values in JAX and in torch."""
    if dtype == "float32":
        return jnp.asarray(x), torch.from_numpy(x.copy())
    j = jnp.asarray(x).astype(jnp.bfloat16)
    bits = np.asarray(j).view(np.uint16).copy()
    return j, torch.from_numpy(bits).view(torch.bfloat16)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _scan_inputs(seed, B, nc, Q, H, P, N, dtype):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, nc, Q, H, P)) * 0.5).astype(np.float32)
    Bm = (rng.standard_normal((B, nc, Q, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, nc, Q, N)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, nc, Q, H)))).astype(
        np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    return ([_both(a, dtype) for a in (x, Bm, Cm)] +
            [_both(dt), _both(A)])


@pytest.mark.parametrize("B,nc,Q,H,P,N", [
    (1, 2, 16, 2, 8, 8),
    (2, 4, 16, 3, 8, 16),
    (2, 8, 32, 4, 16, 32),
    (2, 1, 48, 3, 16, 16),          # one chunk
    (1, 3, 20, 2, 16, 16),          # a chunk no multiple of 16
])
def test_twin_matches_pallas_kernel_and_oracle(B, nc, Q, H, P, N):
    ins = _scan_inputs(nc * Q + H, B, nc, Q, H, P, N, "float32")
    j_in, t_in = [a for a, _ in ins], [b for _, b in ins]
    n0 = t_ss.ssd_scan.launches
    y, st = t_ss.ssd_scan(*t_in)
    assert t_ss.ssd_scan.launches == n0          # the twin, no launch
    assert y.dtype == torch.float32 and y.shape == (B, nc, Q, H, P)
    assert st.dtype == torch.float32 and st.shape == (B, H, P, N)
    yk, sk = ssd_scan_kernel(*j_in, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yk), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sk), rtol=2e-5,
                               atol=2e-5)
    yr, sr = ssd_ref(*[np.asarray(a) for a in j_in])
    np.testing.assert_allclose(y.numpy(), yr, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(st.numpy(), sr, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("B,nc,Q,H,P,N", [(2, 4, 16, 3, 8, 16),
                                          (1, 1, 64, 2, 16, 16)])
def test_twin_matches_pallas_kernel_bf16(B, nc, Q, H, P, N):
    ins = _scan_inputs(7 + Q, B, nc, Q, H, P, N, "bfloat16")
    j_in, t_in = [a for a, _ in ins], [b for _, b in ins]
    yk, sk = ssd_scan_kernel(*j_in, interpret=True)
    y, st = t_ss.ssd_scan(*t_in)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    np.testing.assert_allclose(_f32(y), _f32(yk), **BF16_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sk), **BF16_TOL)
    y32, st32 = t_ss.ssd_scan(*t_in, out_dtype=torch.float32)
    assert y32.dtype == torch.float32
    assert torch.equal(y32.to(torch.bfloat16), y) and torch.equal(st32, st)


def test_op_refuses_other_devices_and_dtypes():
    x = torch.zeros(1, 1, 4, 2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        t_ss.ssd_scan(x, x, x, x, x)
    x = torch.zeros(1, 1, 4, 2, 16)
    with pytest.raises(ValueError, match="out_dtype"):
        t_ss.ssd_scan(x, x, x, x, x, out_dtype=torch.float16)


# --------------------------------------------------------------------- #
# the SSD mixer
# --------------------------------------------------------------------- #
def _cfgs(chunk=None):
    j = j_get_config("mamba2-130m").reduced()
    t = get_config("mamba2-130m").reduced()
    if chunk is not None:
        j = dataclasses.replace(j, ssm_chunk=chunk)
        t = dataclasses.replace(t, ssm_chunk=chunk)
    return j, t


def _params(jcfg, dtype="float32", seed=0):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    p = init_tree(jax.random.PRNGKey(seed), jssd.ssd_params(jcfg, jdt))
    t = {}
    for k, v in p.items():
        a = np.asarray(v)
        t[k] = (torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
                if a.dtype == jnp.bfloat16 else torch.from_numpy(a.copy()))
    return p, t


def _x(cfg, B, S, dtype="float32", seed=1):
    x = (np.random.default_rng(seed).standard_normal((B, S, cfg.d_model))
         * 0.3).astype(np.float32)
    return _both(x, dtype)


@pytest.mark.parametrize("S,chunk", [(32, 8), (64, 16), (48, 16)])
def test_ssd_apply_matches_jax(S, chunk):
    jcfg, tcfg = _cfgs(chunk)
    jp, tp = _params(jcfg)
    jx, tx = _x(jcfg, 2, S)
    jy, jst = jssd.ssd_apply(jp, jx, jcfg)
    y, st = tssd.ssd_apply(tp, tx, tcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32_TOL)
    assert set(st) == set(jst) == {"ssm", "conv_x", "conv_B", "conv_C"}
    for k in st:
        assert st[k].dtype == torch.float32
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                   **F32_TOL, err_msg=k)
    # and the chunked scan equals the sequential recurrence, as the JAX
    # test holds it
    np.testing.assert_allclose(y.numpy(),
                               tssd.ssd_reference(tp, tx, tcfg).numpy(),
                               rtol=2e-3, atol=2e-3)


def test_ssd_apply_matches_jax_bf16():
    jcfg, tcfg = _cfgs(16)
    jp, tp = _params(jcfg, "bfloat16")
    jx, tx = _x(jcfg, 2, 48, "bfloat16")
    jy, jst = jssd.ssd_apply(jp, jx, jcfg)
    y, st = tssd.ssd_apply(tp, tx, tcfg)
    assert y.dtype == torch.bfloat16 and st["ssm"].dtype == torch.float32
    np.testing.assert_allclose(_f32(y), _f32(jy), **BF16_TOL)
    for k in st:
        assert st[k].dtype == (torch.float32 if k == "ssm"
                               else torch.bfloat16), k
        np.testing.assert_allclose(_f32(st[k]), _f32(jst[k]), **BF16_TOL,
                                   err_msg=k)


def test_ssd_reference_and_decode_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    jx, tx = _x(jcfg, 2, 12)
    np.testing.assert_allclose(tssd.ssd_reference(tp, tx, tcfg).numpy(),
                               np.asarray(jssd.ssd_reference(jp, jx, jcfg)),
                               **F32_TOL)
    # one decode step from a nonzero cache, updated in place
    rng = np.random.default_rng(5)
    jc, tc = {}, {}
    for k, v in tssd.ssd_init_cache(tcfg, 2, torch.float32).items():
        jc[k], tc[k] = _both(rng.standard_normal(v.shape).astype(np.float32))
    keep = dict(tc)
    jy, jc2 = jssd.ssd_decode(jp, jx[:, :1], jc, jcfg)
    y, tc2 = tssd.ssd_decode(tp, tx[:, :1], tc, tcfg)
    assert tc2 is tc and all(tc[k] is keep[k] for k in tc)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32_TOL)
    for k in tc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc2[k]),
                                   **F32_TOL, err_msg=k)


def test_prefill_state_continues_decode():
    """The port's prefill state + decode steps == JAX's, and == the
    sequential oracle over the whole sequence."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    B, S = 2, 32
    jx, tx = _x(jcfg, B, S + 3)
    _, cache = tssd.ssd_apply(tp, tx[:, :S], tcfg)
    _, jcache = jssd.ssd_apply(jp, jx[:, :S], jcfg)
    outs, jouts = [], []
    for t in range(3):
        y, cache = tssd.ssd_decode(tp, tx[:, S + t:S + t + 1], cache, tcfg)
        jy, jcache = jssd.ssd_decode(jp, jx[:, S + t:S + t + 1], jcache, jcfg)
        outs.append(y)
        jouts.append(jy)
    y_dec = torch.cat(outs, dim=1).numpy()
    np.testing.assert_allclose(y_dec, np.asarray(jnp.concatenate(jouts, 1)),
                               **F32_TOL)
    y_full = tssd.ssd_reference(tp, tx, tcfg)
    np.testing.assert_allclose(y_dec, y_full[:, S:].numpy(), rtol=3e-3,
                               atol=3e-3)
    for k in cache:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   **F32_TOL, err_msg=k)
