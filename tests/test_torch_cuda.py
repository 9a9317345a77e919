"""The port's CUDA kernels against their plain PyTorch twins, on the
card (marked `gpu`; each test skips without a CUDA device).  This file
imports no JAX, so it runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_cuda.py

The same inputs on the CPU run the twins, which `test_torch_kernels.py`
holds bit-equal to the JAX kernels; here the kernel must equal the twin
bit for bit, floats included, and each launch must count once.  Every op
takes a leading member axis B; the cases run at B = 1 and at B = 3."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.ae_sync import ops as ae
from repro_torch.kernels.group_digest import ops as gd
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
@pytest.mark.parametrize("B,N,L,W,due", [
    (1, 87, 4096, 256, 0.5), (1, 1, 1, 1, 1.0), (3, 5, 33, 256, 1.0),
    (3, 24, 200, 8, 0.0), (5, 87, 4096, 256, 0.7)])
def test_log_match_append(B, N, L, W, due):
    _need_cuda()
    rng = np.random.default_rng(N + L + B)
    frm = _t(rng, 0, L + 1, (B, N))
    args = [_t(rng, 0, 4, (B, N, L)), _t(rng, 0, 8, (B, N, L)),
            _t(rng, 0, 64, (B, N, L)), _t(rng, 0, 4, (B, L)),
            _t(rng, 0, 8, (B, L)), _t(rng, 0, 64, (B, L)),
            _t(rng, 0, L + 1, (B, N)), frm,
            torch.clamp(frm + _t(rng, -8, W + 40, (B, N)), max=L),
            torch.as_tensor(rng.random((B, N)) < due)]
    want = rt.log_match_append(*[a.clone() for a in args], w=W)
    n0 = rt.log_match_append.launches
    got = rt.log_match_append(*[a.cuda() for a in args], w=W)
    assert rt.log_match_append.launches == n0 + 1
    _equal(want, got)


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,L,dead", [(1, 87, 4096, 0.3), (1, 87, 4096, 1.0),
                                        (1, 1, 16, 0.0), (1, 1024, 64, 0.5),
                                        (5, 87, 4096, 0.2)])
def test_commit_majority(B, N, L, dead):
    _need_cuda()
    rng = np.random.default_rng(N * L + B)
    args = [_t(rng, 0, L + 1, (B, N)),
            torch.as_tensor(rng.random((B, N)) >= dead),
            _t(rng, 0, 3, (B, L)), torch.ones((B,), dtype=torch.int32)]
    for majority in (0, 1, N // 2 + 1, N, N + 2):
        m = torch.full((B,), majority, dtype=torch.int32)
        _equal([rt.commit_majority(*args, m)],
               [rt.commit_majority(*[a.cuda() for a in args], m.cuda())])
    # a fleet mixing cluster sizes: one majority per member
    m = torch.as_tensor(rng.integers(0, N + 3, B).astype(np.int32))
    _equal([rt.commit_majority(*args, m)],
           [rt.commit_majority(*[a.cuda() for a in args], m.cuda())])


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,K,A", [(1, 87, 1024, 8), (1, 3, 5, 8),
                                     (3, 7, 64, 1), (5, 87, 1024, 8)])
def test_apply_last_wins(B, N, K, A):
    _need_cuda()
    rng = np.random.default_rng(N + K + A + B)
    args = [_t(rng, -4, 4, (B, N, K)), _t(rng, -K - 3, K + 3, (B, N, A)),
            _t(rng, 0, 2 ** 20, (B, N, A)),
            torch.as_tensor(rng.random((B, N, A)) < 0.7)]
    _equal([rt.apply_last_wins(*[a.clone() for a in args])],
           [rt.apply_last_wins(*[a.cuda() for a in args])])


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,budget,has_leader,alive", [
    (1, 87, 16, True, 0.8), (1, 87, 0, True, 0.8), (1, 87, 16, False, 0.8),
    (1, 87, 16, True, 0.0), (1, 1, 16, True, 1.0), (1, 1024, 16, True, 0.8),
    (5, 87, 16, True, 0.8)])
def test_leader_fanout(B, N, budget, has_leader, alive):
    _need_cuda()
    rng = np.random.default_rng(N + budget + B)
    warn = np.where(rng.random((B, N)) < 0.3, rng.integers(0, 5, (B, N)), -1)
    arrive = np.where(rng.random((B, N)) < 0.6, -1,
                      rng.integers(0, 40, (B, N)))
    s = lambda lo, hi: _t(rng, lo, hi, (B,))
    args = [_t(rng, 0, 6, (B, N)), torch.as_tensor(rng.random((B, N)) < alive),
            torch.as_tensor(warn.astype(np.int32)), _t(rng, -1, N, (B, N)),
            _t(rng, 0, 4097, (B, N)),
            torch.as_tensor(arrive.astype(np.int32)),
            _t(rng, 0, 4097, (B, N)), _t(rng, 0, 4097, (B, N)),
            _t(rng, 0, 4, (B, N)), _t(rng, 0, 4097, (B, N)),
            _t(rng, 1, 20, (B, N, N)), s(0, N),
            torch.full((B,), has_leader), s(0, 100), s(0, 4097), s(0, 4),
            s(0, 4097)]
    kw = dict(msg_budget=budget, max_ship=256, entries_per_msg=32)
    _equal(lf.leader_fanout(*args, **kw),
           lf.leader_fanout(*[a.cuda() for a in args], **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("B,O,N,S,voters,interval", [
    (1, 550, 87, 4, 0.1, 4), (5, 550, 87, 4, 0.1, 4), (3, 7, 9, 2, 0.0, 1),
    (2, 130, 17, 3, 1.0, 0), (1, 1, 1, 1, 1.0, 1)])
def test_ae_sync(B, O, N, S, voters, interval):
    _need_cuda()
    rng = np.random.default_rng(B + O + N)
    args = [torch.as_tensor(rng.random((B, O)) < 0.8),
            _t(rng, -1, N + 2, (B, O)), _t(rng, 0, 64, (B, O)),
            _t(rng, 0, 4, (B, O)), _t(rng, -2 ** 31, 2 ** 31 - 1, (B, O)),
            _t(rng, -1, 40, (B, O)), _t(rng, 0, 9, (B, O)),
            _t(rng, 0, S, (B, O)), torch.as_tensor(rng.random((B, N)) < 0.8),
            torch.as_tensor(rng.random((B, N)) < voters),
            _t(rng, 0, 65, (B, N)), _t(rng, 0, 4, (B, N)),
            _t(rng, -2 ** 31, 2 ** 31 - 1, (B, N)), _t(rng, 0, S, (B, N)),
            _t(rng, 1, 20, (B, S, S)), _t(rng, 0, 100, (B,)),
            torch.full((B,), interval, dtype=torch.int32)]
    n0 = ae.ae_sync.launches
    got = ae.ae_sync(*[a.cuda() for a in args])
    assert ae.ae_sync.launches == n0 + 1
    _equal(ae.ae_sync(*args), got)


@pytest.mark.gpu
@pytest.mark.parametrize("B,G,Fi,Ff,dropped", [
    (5, 1, 355, 3, 0.0), (13, 3, 40, 3, 0.2), (37, 1, 1, 3, 0.0),
    (21, 6, 7, 2, 0.5), (6, 3, 5, 2, 1.0)])
def test_group_reduce(B, G, Fi, Ff, dropped):
    _need_cuda()
    rng = np.random.default_rng(B * G + Fi)
    gids = np.where(rng.random(B) < dropped, G, rng.integers(0, G, B))
    args = [torch.as_tensor(gids.astype(np.int32)),
            _t(rng, -50, 2 ** 20, (B, Fi)),
            torch.as_tensor((rng.standard_normal((B, Ff)) * 1e3)
                            .astype(np.float32))]
    n0 = gd.group_reduce.launches
    got = gd.group_reduce(*[a.cuda() for a in args], n_groups=G)
    assert gd.group_reduce.launches == n0 + 1
    _equal(gd.group_reduce(*args, n_groups=G), got)
