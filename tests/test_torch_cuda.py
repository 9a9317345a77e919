"""The port's CUDA kernels against their plain PyTorch twins, on the
card (marked `gpu`; each test skips without a CUDA device).  This file
imports no JAX, so it runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_cuda.py

The same inputs on the CPU run the twins, which `test_torch_kernels.py`
holds bit-equal to the JAX kernels; here the kernel must equal the twin
bit for bit, and each launch must count once."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.leader_fanout import ops as lf
from repro_torch.kernels.raft_tick import ops as rt


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _t(rng, lo, hi, shape):
    return torch.as_tensor(rng.integers(lo, hi, shape).astype(np.int32))


def _equal(want, got):
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("N,L,W,due", [(87, 4096, 256, 0.5), (1, 1, 1, 1.0),
                                       (5, 33, 256, 1.0), (24, 200, 8, 0.0)])
def test_log_match_append(N, L, W, due):
    _need_cuda()
    rng = np.random.default_rng(N + L)
    frm = _t(rng, 0, L + 1, (N,))
    args = [_t(rng, 0, 4, (N, L)), _t(rng, 0, 8, (N, L)),
            _t(rng, 0, 64, (N, L)), _t(rng, 0, 4, (L,)), _t(rng, 0, 8, (L,)),
            _t(rng, 0, 64, (L,)), _t(rng, 0, L + 1, (N,)), frm,
            torch.clamp(frm + _t(rng, -8, W + 40, (N,)), max=L),
            torch.as_tensor(rng.random(N) < due)]
    want = rt.log_match_append(*[a.clone() for a in args], w=W)
    n0 = rt.log_match_append.launches
    got = rt.log_match_append(*[a.cuda() for a in args], w=W)
    assert rt.log_match_append.launches == n0 + 1
    _equal(want, got)


@pytest.mark.gpu
@pytest.mark.parametrize("N,L,dead", [(87, 4096, 0.3), (87, 4096, 1.0),
                                      (1, 16, 0.0), (1024, 64, 0.5)])
def test_commit_majority(N, L, dead):
    _need_cuda()
    rng = np.random.default_rng(N * L)
    args = [_t(rng, 0, L + 1, (N,)), torch.as_tensor(rng.random(N) >= dead),
            _t(rng, 0, 3, (L,)), torch.tensor(1, dtype=torch.int32)]
    for majority in (0, 1, N // 2 + 1, N, N + 2):
        _equal([rt.commit_majority(*args, majority)],
               [rt.commit_majority(*[a.cuda() for a in args], majority)])


@pytest.mark.gpu
@pytest.mark.parametrize("N,K,A", [(87, 1024, 8), (3, 5, 8), (7, 64, 1)])
def test_apply_last_wins(N, K, A):
    _need_cuda()
    rng = np.random.default_rng(N + K + A)
    args = [_t(rng, -4, 4, (N, K)), _t(rng, -K - 3, K + 3, (N, A)),
            _t(rng, 0, 2 ** 20, (N, A)),
            torch.as_tensor(rng.random((N, A)) < 0.7)]
    _equal([rt.apply_last_wins(*[a.clone() for a in args])],
           [rt.apply_last_wins(*[a.cuda() for a in args])])


@pytest.mark.gpu
@pytest.mark.parametrize("N,budget,has_leader,alive", [
    (87, 16, True, 0.8), (87, 0, True, 0.8), (87, 16, False, 0.8),
    (87, 16, True, 0.0), (1, 16, True, 1.0), (1024, 16, True, 0.8)])
def test_leader_fanout(N, budget, has_leader, alive):
    _need_cuda()
    rng = np.random.default_rng(N + budget)
    warn = np.where(rng.random(N) < 0.3, rng.integers(0, 5, N), -1)
    arrive = np.where(rng.random(N) < 0.6, -1, rng.integers(0, 40, N))
    s = lambda lo, hi: torch.tensor(int(rng.integers(lo, hi)),
                                    dtype=torch.int32)
    args = [_t(rng, 0, 6, (N,)), torch.as_tensor(rng.random(N) < alive),
            torch.as_tensor(warn.astype(np.int32)), _t(rng, -1, N, (N,)),
            _t(rng, 0, 4097, (N,)), torch.as_tensor(arrive.astype(np.int32)),
            _t(rng, 0, 4097, (N,)), _t(rng, 0, 4097, (N,)),
            _t(rng, 0, 4, (N,)), _t(rng, 0, 4097, (N,)),
            _t(rng, 1, 20, (N, N)), s(0, N), torch.tensor(has_leader),
            s(0, 100), s(0, 4097), s(0, 4), s(0, 4097)]
    kw = dict(msg_budget=budget, max_ship=256, entries_per_msg=32)
    _equal(lf.leader_fanout(*args, **kw),
           lf.leader_fanout(*[a.cuda() for a in args], **kw))
