"""The port's CUDA kernels against their plain PyTorch twins, on the
card (marked `gpu`; each test skips without a CUDA device).  This file
imports no JAX, so it runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_cuda.py

The same inputs on the CPU run the twins, which `test_torch_kernels.py`
holds bit-equal to the JAX kernels; here the kernel must equal the twin
bit for bit, floats included, and each launch must count once.  Every
consensus op takes a leading member axis B; the cases run at B = 1 to
B = 32.  The two attention kernels (held to the JAX kernels by
`test_torch_attention_kernels.py`) and the SSD scan (held to the JAX
kernel by `test_torch_ssd.py`) match their twins within float32 2e-4 and
bfloat16 3e-2: the sums run in another order.  The attention kernels'
and the SSD scan's tile edges also check which route (tensor cores for
bfloat16 at head_dim 64/128, and for the scan at P, N in {64, 128};
scalar for the rest) each launch took, and one test (two cards or
more) launches on the second card while the first is current."""
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
    """Equal bit for bit (+0 and -0 apart); a float NaN matches a NaN
    whatever its payload (the card's adder returns its canonical NaN)."""
    for a, b in zip(want, got):
        b = b.cpu()
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype.is_floating_point:
            nan = torch.isnan(a)
            assert torch.equal(nan, torch.isnan(b))
            a, b = a.masked_fill(nan, 0), b.masked_fill(nan, 0)
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b.cpu())


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


def _lma_edge(rng, kind, B, N, L, W):
    """A window edge, every row due: from = 0 (the prev read at position
    0, which the window overwrites with another term), from = L, upto
    below from, a matching log longer than the window, a window past
    what the threads hold in registers (W > 256).  Returns the op's
    operands."""
    frm = _t(rng, 0, L + 1, (B, N))
    up = torch.clamp(frm + _t(rng, -8, W + 40, (B, N)), max=L)
    lterm = _t(rng, 0, 4, (B, L))
    term = _t(rng, 0, 4, (B, N, L))
    log_len = _t(rng, 0, L + 1, (B, N))
    if kind == "from0":
        frm[:] = 0
        up = _t(rng, 1, W + 1, (B, N))
        term[:, :, 0] = lterm[:, None, 0] + 1
    elif kind == "fromL":
        frm[:] = L
        up[:] = L
        term[:, ::2, L - 1] = lterm[:, None, L - 1]
    elif kind == "upto_below_from":
        frm = _t(rng, 4, L + 1, (B, N))
        up = frm - _t(rng, 1, 4, (B, N))
    elif kind == "longer":
        term[:] = lterm[:, None, :]
        log_len[:] = L
        frm = _t(rng, 1, L - W, (B, N))
        up = frm + W // 2
    elif kind == "wide":
        up = torch.clamp(frm + W + 40, max=L)
    return [term, _t(rng, 0, 8, (B, N, L)), _t(rng, 0, 64, (B, N, L)),
            lterm, _t(rng, 0, 8, (B, L)), _t(rng, 0, 64, (B, L)), log_len,
            frm, up, torch.ones((B, N), dtype=torch.bool)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,B,N,L,W", [
    ("from0", 1, 87, 4096, 256), ("fromL", 1, 87, 4096, 256),
    ("upto_below_from", 1, 87, 4096, 256), ("longer", 1, 87, 4096, 256),
    ("random", 1, 87, 4096, 1), ("random", 3, 33, 64, 1),
    ("wide", 1, 87, 4096, 512), ("wide", 2, 9, 1500, 1024),
    ("random", 1, 1024, 512, 256), ("random", 32, 87, 4096, 256),
    ("from0", 32, 87, 4096, 512), ("longer", 5, 87, 4096, 512)])
def test_log_match_append_edges(kind, B, N, L, W):
    _need_cuda()
    rng = np.random.default_rng(N + L + W + B)
    args = _lma_edge(rng, kind, B, N, L, W)
    want = rt.log_match_append(*[a.clone() for a in args], w=W)
    n0 = rt.log_match_append.launches
    got = rt.log_match_append(*[a.cuda() for a in args], w=W)
    assert rt.log_match_append.launches == n0 + 1
    _equal(want, got)
    if kind in ("from0", "longer"):
        assert bool(got[4].all())


# the commit kernel's edges: N across a warp's edge up to one block, L
# from one entry to the paper's 4096 (ragged between), and a B = 32 fleet
COMMIT_CASES = [(1, 87, 4096, 0.3), (1, 87, 4096, 1.0), (1, 1, 16, 0.0),
                (1, 1024, 64, 0.5), (5, 87, 4096, 0.2)] + [
    (1, n, ln, 0.3) for n in (1, 32, 33, 87, 1024)
    for ln in (1, 16, 33, 4096)] + [(32, 87, 4096, 0.3), (32, 33, 33, 0.5)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,L,dead", COMMIT_CASES)
def test_commit_majority(B, N, L, dead):
    """Random (not monotone) leader terms; majorities 0 to N + 2, one per
    member in a fleet; no live voter; the majority-th match at or past
    L."""
    _need_cuda()
    rng = np.random.default_rng(N * L + B)

    def check(args, m):
        n0 = rt.commit_majority.launches
        got = rt.commit_majority(*[a.cuda() for a in args], m.cuda())
        assert rt.commit_majority.launches == n0 + 1
        _equal([rt.commit_majority(*args, m)], [got])

    args = [_t(rng, 0, L + 1, (B, N)),
            torch.as_tensor(rng.random((B, N)) >= dead),
            _t(rng, 0, 3, (B, L)), _t(rng, 0, 3, (B,))]
    for majority in (0, 1, N // 2 + 1, N, N + 1, N + 2):
        check(args, torch.full((B,), majority, dtype=torch.int32))
    # a fleet mixing cluster sizes: one majority per member
    mixed = torch.as_tensor(rng.integers(0, N + 3, B).astype(np.int32))
    check(args, mixed)
    # no live voter
    check([args[0], torch.zeros((B, N), dtype=torch.bool), *args[2:]],
          mixed)
    # every live voter at or past L: the limit is L itself
    check([_t(rng, L, L + 4, (B, N)), *args[1:]], mixed)


# the apply kernel's edges: A from one lane to two warps' worth of lanes
APPLY_CASES = [(1, 87, 1024, 8), (1, 3, 5, 8), (3, 7, 64, 1),
               (5, 87, 1024, 8)] + [
    (b, 87, 1024, a) for a in (1, 8, 31, 32, 33, 64) for b in (1, 5)] + [
    (32, 87, 1024, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,K,A", APPLY_CASES)
def test_apply_last_wins(B, N, K, A):
    """Random keys in [-K-3, K+3); every entry of a row on one key; no
    valid entry; keys at -K-1, -1, K, K+1 (wrapped, written, dropped)."""
    _need_cuda()
    rng = np.random.default_rng(N + K + A + B)
    kv = _t(rng, -4, 4, (B, N, K))
    vals = _t(rng, 0, 2 ** 20, (B, N, A))
    valid = torch.as_tensor(rng.random((B, N, A)) < 0.7)
    one = torch.as_tensor(np.repeat(rng.integers(-K - 3, K + 3, (B, N, 1)),
                                    A, axis=2).astype(np.int32))
    edge = torch.as_tensor(rng.choice(
        np.array([-K - 1, -1, K, K + 1, 0, K - 1], dtype=np.int32),
        (B, N, A)))
    for keys, ok in ((_t(rng, -K - 3, K + 3, (B, N, A)), valid),
                     (one, valid), (one, torch.ones_like(valid)),
                     (_t(rng, -K - 3, K + 3, (B, N, A)),
                      torch.zeros_like(valid)), (edge, valid)):
        args = [kv, keys, vals, ok]
        n0 = rt.apply_last_wins.launches
        got = rt.apply_last_wins(*[a.cuda() for a in args])
        assert rt.apply_last_wins.launches == n0 + 1
        _equal([rt.apply_last_wins(*[a.clone() for a in args])], [got])


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
    n0 = lf.leader_fanout.launches
    got = lf.leader_fanout(*[a.cuda() for a in args], **kw)
    assert lf.leader_fanout.launches == n0 + 1
    _equal(lf.leader_fanout(*args, **kw), got)


@pytest.mark.gpu
@pytest.mark.parametrize("B,N", [(5, 87), (1, 1024)])
@pytest.mark.parametrize("max_ship,epm", [(256, 32), (254, 1), (255, 1),
                                          (4096, 1), (0, 7)])
def test_leader_fanout_cost_width(B, N, max_ship, epm):
    """Batch costs from a constant 1 up to 4097 (max_ship 4096 over one
    entry a message), so the rank's scan sums wide values, with budgets
    that cut inside the direct nodes."""
    _need_cuda()
    rng = np.random.default_rng(N + max_ship + epm)
    args = [torch.zeros((B, N), dtype=torch.int32),
            torch.as_tensor(rng.random((B, N)) < 0.9),
            torch.full((B, N), -1, dtype=torch.int32),
            _t(rng, -1, N, (B, N)), _t(rng, 0, 4097, (B, N)),
            torch.full((B, N), -1, dtype=torch.int32),
            _t(rng, 0, 4097, (B, N)), _t(rng, 0, 4097, (B, N)),
            _t(rng, 0, 4, (B, N)), _t(rng, 0, 4097, (B, N)),
            _t(rng, 1, 20, (B, N, N)), _t(rng, 0, N, (B,)),
            torch.ones((B,), dtype=torch.bool), _t(rng, 0, 100, (B,)),
            _t(rng, 0, 4097, (B,)), _t(rng, 0, 4, (B,)),
            _t(rng, 0, 4097, (B,))]
    args[0][:, ::9] = 3                         # some secretaries
    for budget in (N // 2, N * (1 + max_ship // epm) // 3):
        kw = dict(msg_budget=budget, max_ship=max_ship, entries_per_msg=epm)
        n0 = lf.leader_fanout.launches
        got = lf.leader_fanout(*[a.cuda() for a in args], **kw)
        assert lf.leader_fanout.launches == n0 + 1
        _equal(lf.leader_fanout(*args, **kw), got)


@pytest.mark.gpu
@pytest.mark.parametrize("B,N", [(1, 32), (1, 33), (1, 64), (1, 65),
                                 (1, 87), (5, 87), (1, 1024), (32, 87)])
@pytest.mark.parametrize("cut", ["lane31", "lane32", "past"])
def test_leader_fanout_rank_cut(B, N, cut):
    """Every node a live follower of leader 0, nodes 1-2 secretaries,
    node 3 relayed (n_sec = 2), the rest direct; member 0's budget puts
    its rank cut on lane 31, on lane 0 of the next warp (lane 31 again
    at N = 32) or past the total, the other members' at random."""
    _need_cuda()
    rng = np.random.default_rng(N + B)
    role = torch.zeros((B, N), dtype=torch.int32)
    role[:, 1:3] = 3
    sec_of = torch.full((B, N), -1, dtype=torch.int32)
    sec_of[:, 3] = 1
    match = _t(rng, 0, 4097, (B, N))
    ldr_len = _t(rng, 0, 4097, (B,))
    max_ship, epm = 256, 32
    cost = 1 + torch.clamp(ldr_len[:, None] - match, 0, max_ship) // epm
    rank = torch.cumsum(torch.where(torch.arange(N) > 3, cost, 0), 1)[0]
    budget = {"lane31": rank[31], "lane32": rank[min(32, N - 1)],
              "past": rank[-1] + 1}[cut]
    args = [role, torch.ones((B, N), dtype=torch.bool),
            torch.full((B, N), -1, dtype=torch.int32), sec_of, match,
            torch.full((B, N), -1, dtype=torch.int32),
            _t(rng, 0, 4097, (B, N)), _t(rng, 0, 4097, (B, N)),
            _t(rng, 0, 4, (B, N)), _t(rng, 0, 4097, (B, N)),
            _t(rng, 1, 20, (B, N, N)), torch.zeros((B,), dtype=torch.int32),
            torch.ones((B,), dtype=torch.bool), _t(rng, 0, 100, (B,)),
            ldr_len, _t(rng, 0, 4, (B,)), _t(rng, 0, 4097, (B,))]
    kw = dict(msg_budget=int(budget) + 2, max_ship=max_ship,
              entries_per_msg=epm)
    n0 = lf.leader_fanout.launches
    got = lf.leader_fanout(*[a.cuda() for a in args], **kw)
    assert lf.leader_fanout.launches == n0 + 1
    want = lf.leader_fanout(*args, **kw)
    _equal(want, got)
    last = {"lane31": 31, "lane32": min(32, N - 1), "past": N - 1}[cut]
    assert int(want[5][0]) == last - 3 + 2


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


def _ae_edge_args(kind, B, O, N, S, interval, seed):
    """The op's operands at an edge of the kernel: "last_word" (every
    alive voter in the last 32-node word), "fol_out" (wired followers at
    -1, -5, N, N + 3 and in range), "neg_tick" (tick + phase below 0) or
    "random"."""
    rng = np.random.default_rng(seed)
    alive = rng.random((B, N)) < 0.8
    voter = rng.random((B, N)) < 0.6
    fol = rng.integers(-1, N + 2, (B, O))
    tick = rng.integers(0, 100, B)
    phase = rng.integers(0, 9, (B, O))
    if kind == "last_word":
        lo = (N - 1) // 32 * 32
        alive[:, :lo] &= ~voter[:, :lo]
        alive[:, N - 1] = voter[:, N - 1] = True
        fol[:, ::3] = N - 1
    elif kind == "fol_out":
        fol = rng.choice(np.array([-1, -5, N, N + 3, 0, N - 1]), (B, O))
    elif kind == "neg_tick":
        tick[:] = -13
        phase = rng.integers(-9, 4, (B, O))
    i32 = lambda a: torch.as_tensor(np.asarray(a).astype(np.int32))
    return [torch.as_tensor(rng.random((B, O)) < 0.8), i32(fol),
            _t(rng, 0, 64, (B, O)), _t(rng, 0, 4, (B, O)),
            _t(rng, -2 ** 31, 2 ** 31 - 1, (B, O)), _t(rng, -1, 40, (B, O)),
            i32(phase), _t(rng, 0, S, (B, O)), torch.as_tensor(alive),
            torch.as_tensor(voter), _t(rng, 0, 65, (B, N)),
            _t(rng, 0, 4, (B, N)), _t(rng, -2 ** 31, 2 ** 31 - 1, (B, N)),
            _t(rng, 0, S, (B, N)), _t(rng, 1, 20, (B, S, S)), i32(tick),
            torch.full((B,), interval, dtype=torch.int32)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,B,O,N,S,interval", [
    *[("last_word", 2, 40, n, 3, 4) for n in (1, 31, 32, 33, 64, 65, 128,
                                               129, 1024, 1100)],
    *[("random", 2, 50, 20, s, 1) for s in (1, 4, 5, 6)],
    *[("random", 2, o, 9, 2, 1) for o in (1, 31, 32, 33, 129)],
    ("fol_out", 3, 60, 17, 3, 1), ("neg_tick", 3, 60, 17, 3, 4),
    ("neg_tick", 3, 60, 17, 3, 3), ("random", 3, 60, 17, 3, 0),
    ("random", 3, 60, 17, 3, -3), ("last_word", 5, 550, 87, 4, 1),
    ("random", 5, 550, 87, 6, 1), ("random", 5, 550, 2000, 4, 1)])
def test_ae_sync_edges(kind, B, O, N, S, interval):
    """The kernel's edges: N across its 32-node words, across the 128 of
    its one-trip instance and past the 1024 its lane masks cover, S * S
    across the 32 entries its lanes preload, O
    across its warps, wired followers out of range, a negative tick +
    phase, an interval <= 0."""
    _need_cuda()
    args = _ae_edge_args(kind, B, O, N, S, interval, O * 31 + N + S)
    n0 = ae.ae_sync.launches
    got = ae.ae_sync(*[a.cuda() for a in args])
    assert ae.ae_sync.launches == n0 + 1
    _equal(ae.ae_sync(*args), got)


def _group_edge_args(B, G, empty, seed, Fi=20):
    """Ids over [0, G] (G drops), group `empty` left empty, int lanes
    over all of int32 (the sums wrap), float lanes with NaN, +-inf, +0
    and -0 (see `test_torch_kernels.group_edge_case`)."""
    rng = np.random.default_rng(seed)
    gids = rng.integers(0, G + 1, B)
    if empty is not None:
        gids[gids == empty] = (empty + 1) % G
    pick = lambda vals: rng.choice(np.array(vals, np.float32), B)
    normal = (rng.standard_normal(B) * 100.0).astype(np.float32)
    flt = np.stack([
        normal, pick([0.0, -0.0]), pick([-0.0, -np.inf, -1.5]),
        np.where(rng.random(B) < 0.1, np.float32(np.nan), normal[::-1]),
        pick([-np.inf, np.inf, 1.0]),
        np.where(rng.random(B) < 0.5, pick([0.0, -0.0]), normal)], 1)
    return [torch.as_tensor(gids.astype(np.int32)),
            _t(rng, -2 ** 31, 2 ** 31, (B, Fi)),
            torch.as_tensor(flt.astype(np.float32))]


@pytest.mark.gpu
@pytest.mark.parametrize("B,G,empty", [
    (1, 1, None), (8, 2, None), (9, 3, None), (15, 3, None), (16, 3, 1),
    (17, 3, None), (32, 2, None), (33, 5, 4), (100, 3, 0), (40, 8, 5),
    (64, 8, None)])
def test_group_reduce_edges(B, G, empty):
    """B across the kernel's 8-member chunks and its two chunk buffers,
    up to 8 groups, an empty one, NaN / +-inf / +-0 floats, wrapping int
    sums."""
    _need_cuda()
    args = _group_edge_args(B, G, empty, B * 7 + G)
    n0 = gd.group_reduce.launches
    got = gd.group_reduce(*[a.cuda() for a in args], n_groups=G)
    assert gd.group_reduce.launches == n0 + 1
    _equal(gd.group_reduce(*args, n_groups=G), got)


@pytest.mark.gpu
@pytest.mark.parametrize("gids", [[0, 2, 0, 2, 2], [3, 3, 3, 3, 3]],
                         ids=["empty_group", "all_dropped"])
def test_group_reduce_outputs_unfilled(gids):
    """The op allocates its outputs with `torch.empty`: after tensors of
    the outputs' sizes were filled with a sentinel and freed, so the
    allocator likely hands that memory back, every cell still equals
    the twin (an empty group: 0 sums and a -inf max)."""
    _need_cuda()
    G, Fi, Ff = 3, 355, 3
    rng = np.random.default_rng(7)
    args = [torch.tensor(gids, dtype=torch.int32),
            _t(rng, -50, 2 ** 20, (5, Fi)),
            torch.as_tensor((rng.standard_normal((5, Ff)) * 1e3)
                            .astype(np.float32))]
    dev = [a.cuda() for a in args]
    for _ in range(3):
        junk = [torch.full((G, Fi), 0x5A5A5A5A, dtype=torch.int32,
                           device="cuda"),
                torch.full((G, Ff), 1234.5, device="cuda"),
                torch.full((G, Ff), 1234.5, device="cuda")]
        torch.cuda.synchronize()
        del junk
        got = gd.group_reduce(*dev, n_groups=G)
        want = gd.group_reduce(*args, n_groups=G)
        _equal(want, got)
        assert not want[0][1].any() and (want[2][1] == -torch.inf).all()


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


# --------------------------------------------------------------------- #
# the model stack's attention kernels: kernel == twin within tolerance
# --------------------------------------------------------------------- #
ATT_TOLS = {torch.float32: dict(rtol=2e-4, atol=2e-4),
            torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}


def _att(rng, shape, dtype):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)
                           ).to(dtype)


def _close(want, got, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), **ATT_TOLS[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,T,H,KV,hd", [
    (2, 512, 512, 15, 5, 64), (1, 130, 130, 15, 5, 64), (2, 77, 77, 6, 6, 128),
    (1, 33, 33, 8, 1, 16), (2, 24, 61, 6, 2, 32), (1, 1, 1, 2, 1, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention(B, S, T, H, KV, hd, dtype):
    _need_cuda()
    from repro_torch.kernels.flash_attention import ops as fa
    rng = np.random.default_rng(B * S + T + H)
    q, k, v = (_att(rng, (B, S, H, hd), dtype), _att(rng, (B, T, KV, hd), dtype),
               _att(rng, (B, T, KV, hd), dtype))
    n0 = fa.flash_attention.launches
    got = fa.flash_attention(q.cuda(), k.cuda(), v.cuda())
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    _close(fa.flash_attention(q, k, v), got, dtype)


@pytest.mark.gpu
def test_flash_attention_noncausal():
    _need_cuda()
    from repro_torch.kernels.flash_attention import ops as fa
    rng = np.random.default_rng(5)
    q, k, v = (_att(rng, (2, 70, 6, 64), torch.float32),
               _att(rng, (2, 90, 2, 64), torch.float32),
               _att(rng, (2, 90, 2, 64), torch.float32))
    got = fa.flash_attention(q.cuda(), k.cuda(), v.cuda(), causal=False)
    _close(fa.flash_attention(q, k, v, causal=False), got, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,KV,hd", [
    (8, 544, 15, 5, 64), (3, 1000, 8, 1, 64), (4, 77, 16, 2, 128),
    (2, 33, 8, 4, 16), (32, 4096, 15, 5, 64), (1, 1, 3, 3, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention(B, T, H, KV, hd, dtype):
    _need_cuda()
    from repro_torch.kernels.decode_attention import ops as da
    rng = np.random.default_rng(B * T + H)
    q, k, v = (_att(rng, (B, 1, H, hd), dtype), _att(rng, (B, T, KV, hd), dtype),
               _att(rng, (B, T, KV, hd), dtype))
    clen = torch.as_tensor(rng.integers(1, T + 1, B).astype(np.int32))
    clen[0], clen[-1] = T, 1
    n0 = da.decode_attention.launches
    got = da.decode_attention(q.cuda(), k.cuda(), v.cuda(), clen.cuda())
    torch.cuda.synchronize()
    assert da.decode_attention.launches == n0 + 1
    _close(da.decode_attention(q, k, v, clen), got, dtype)
    zero = da.decode_attention(q.cuda(), k.cuda(), v.cuda(),
                               torch.zeros_like(clen).cuda())
    assert torch.equal(zero.cpu(), torch.zeros_like(zero.cpu()))


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,KV,hd", [
    (8, 136, 32, 8, 64), (9, 520, 32, 8, 64), (4, 77, 16, 2, 128),
    (2, 33, 8, 4, 16), (8, 4096, 15, 5, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_lse_form(B, T, H, KV, hd, dtype):
    """The (o, lse) form of a `kv_seq` shard: o and lse float32 against
    the twin's, cache_len 0 giving o = 0 and lse = -inf, and the launch
    counted in `lse_launches` as well."""
    _need_cuda()
    from repro_torch.kernels.decode_attention import ops as da
    rng = np.random.default_rng(B * T + H + 1)
    q, k, v = (_att(rng, (B, 1, H, hd), dtype), _att(rng, (B, T, KV, hd), dtype),
               _att(rng, (B, T, KV, hd), dtype))
    clen = torch.as_tensor(rng.integers(1, T + 1, B).astype(np.int32))
    clen[0], clen[1] = 0, T
    n0, l0 = da.decode_attention.launches, da.decode_attention.lse_launches
    o, lse = da.decode_attention(q.cuda(), k.cuda(), v.cuda(), clen.cuda(),
                                 with_lse=True)
    torch.cuda.synchronize()
    assert (da.decode_attention.launches, da.decode_attention.lse_launches) \
        == (n0 + 1, l0 + 1)
    assert o.dtype == lse.dtype == torch.float32 and lse.shape == (B, H)
    wo, wlse = da.decode_attention(q, k, v, clen, with_lse=True)
    _close(wo, o, dtype)
    assert torch.equal(o[0].cpu(), torch.zeros_like(o[0].cpu()))
    assert torch.isneginf(lse[0]).all()
    _close(wlse[1:], lse[1:], dtype)


# the routes' tile edges: 64-row warpgroups and 128-row blocks of the
# tensor-core flash kernel, its 64-key tiles, the decode kernel's 64-row
# cache tiles; G = 1, 3, 8 at hd 64 and 128, bf16 (tensor cores) and f32
# (scalar).  Each case checks which route's counter moved.
EDGE_GROUPS = [(3, 3, 64), (15, 5, 64), (16, 2, 128), (6, 2, 128),
               (8, 1, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("S,T", [(1, 1), (63, 63), (64, 64), (65, 65),
                                 (127, 127), (129, 129), (65, 200),
                                 (1, 129), (130, 70)])
@pytest.mark.parametrize("H,KV,hd", EDGE_GROUPS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_routes(S, T, H, KV, hd, dtype):
    _need_cuda()
    from repro_torch import kernels as K_
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fa
    rng = np.random.default_rng(S * T + H + hd)
    q, k, v = (_att(rng, (2, S, H, hd), dtype), _att(rng, (2, T, KV, hd), dtype),
               _att(rng, (2, T, KV, hd), dtype))
    route = fk.route(dtype, hd)
    assert route == ("tensor_core" if dtype == torch.bfloat16 else "scalar")
    for causal in (True, False):
        n0 = K_.route_counts()["flash_attention"]
        got = fa.flash_attention(q.cuda(), k.cuda(), v.cuda(), causal=causal)
        torch.cuda.synchronize()
        n1 = K_.route_counts()["flash_attention"]
        assert {r: n1[r] - n0[r] for r in n1} == {
            r: int(r == route) for r in fk.ROUTES}
        _close(fa.flash_attention(q, k, v, causal=causal), got, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 63, 64, 65, 129, 700])
@pytest.mark.parametrize("H,KV,hd", EDGE_GROUPS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_routes(T, H, KV, hd, dtype):
    _need_cuda()
    from repro_torch import kernels as K_
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention import ops as da
    rng = np.random.default_rng(T + H + hd)
    B = 3
    q, k, v = (_att(rng, (B, 1, H, hd), dtype), _att(rng, (B, T, KV, hd), dtype),
               _att(rng, (B, T, KV, hd), dtype))
    clen = torch.as_tensor(np.array([T, 1, (T + 1) // 2], dtype=np.int32))
    route = dk.route(dtype, hd)
    n0 = K_.route_counts()["decode_attention"]
    got = da.decode_attention(q.cuda(), k.cuda(), v.cuda(), clen.cuda())
    torch.cuda.synchronize()
    n1 = K_.route_counts()["decode_attention"]
    assert {r: n1[r] - n0[r] for r in n1} == {
        r: int(r == route) for r in dk.ROUTES}
    _close(da.decode_attention(q, k, v, clen), got, dtype)
    # one split (no combine) and the chosen split agree
    out = torch.empty_like(q.cuda())
    dk.decode_attention(q.cuda(), k.cuda(), v.cuda(), clen.cuda(), out,
                        nsplit=1)
    _close(da.decode_attention(q, k, v, clen), out, dtype)


@pytest.mark.gpu
def test_reduced_serve_on_the_card():
    """The reduced model served on the card: flash once per layer per
    batch, decode once per layer per token, tokens in range."""
    _need_cuda()
    from repro_torch import kernels as K_
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.serve import serve
    cfg = get_config("smollm-360m").reduced().with_layers(2)
    K_.reset_launch_counts()
    r = serve(cfg, RunConfig(remat=False), device="cuda", requests=16,
              batch=8, prompt_len=24, gen_len=5, seed=1)
    counts = K_.launch_counts()
    assert counts["flash_attention"] == 2 * 2
    assert counts["decode_attention"] == 2 * 2 * 5
    for g in r["generated"]:
        assert g.shape == (8, 6) and g.min() >= 0 and \
            g.max() < cfg.padded_vocab


# --------------------------------------------------------------------- #
# the SSD scan and mamba2 serving
# --------------------------------------------------------------------- #
@pytest.mark.gpu
@pytest.mark.parametrize("B,nc,Q,H,P,N", [
    (2, 2, 256, 24, 64, 128), (1, 1, 48, 24, 64, 128), (3, 4, 16, 8, 16, 16),
    (1, 2, 100, 3, 16, 128), (2, 1, 7, 5, 64, 16), (2, 2, 128, 8, 128, 64),
    (1, 2, 100, 3, 128, 128), (2, 1, 63, 4, 64, 64), (1, 3, 1, 4, 64, 128),
    (2, 1, 65, 4, 64, 128), (1, 3, 255, 4, 128, 64), (1, 2, 64, 4, 16, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_ssd_scan(B, nc, Q, H, P, N, dtype, out_dtype):
    _need_cuda()
    from repro_torch.kernels.ssd_scan import ops as ss
    rng = np.random.default_rng(B * nc + Q + H)
    x, Bm, Cm = (_att(rng, s, dtype) * 0.5 for s in
                 ((B, nc, Q, H, P), (B, nc, Q, N), (B, nc, Q, N)))
    dt = torch.nn.functional.softplus(_att(rng, (B, nc, Q, H), torch.float32))
    A = -torch.exp(_att(rng, (H,), torch.float32) * 0.3)
    n0 = ss.ssd_scan.launches
    y, st = ss.ssd_scan(*[t.cuda() for t in (x, Bm, Cm, dt, A)],
                        out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert ss.ssd_scan.launches == n0 + 1
    yw, sw = ss.ssd_scan(x, Bm, Cm, dt, A, out_dtype=out_dtype)
    assert y.dtype == yw.dtype and st.dtype == torch.float32
    _close(yw, y, dtype)
    _close(sw, st, dtype)


# the tensor-core route's tile edges: 64-row output tiles, 16-row k-steps
# of the chunk-state product, one and several chunks; each case checks
# which route's counter moved
@pytest.mark.gpu
@pytest.mark.parametrize("Q", [1, 63, 64, 65, 100, 255, 256])
@pytest.mark.parametrize("nc", [1, 3])
@pytest.mark.parametrize("P,N", [(64, 128), (128, 64), (16, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_routes(Q, nc, P, N, dtype):
    _need_cuda()
    from repro_torch import kernels as K_
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan import ops as ss
    rng = np.random.default_rng(Q * nc + P + N)
    B, H = 2, 4
    x, Bm, Cm = (_att(rng, s, dtype) * 0.5 for s in
                 ((B, nc, Q, H, P), (B, nc, Q, N), (B, nc, Q, N)))
    dt = torch.nn.functional.softplus(_att(rng, (B, nc, Q, H), torch.float32))
    A = -torch.exp(_att(rng, (H,), torch.float32) * 0.3)
    route = sk.route(dtype, P, N)
    assert route == ("tensor_core" if dtype == torch.bfloat16 and P != 16
                     else "scalar")
    n0 = K_.route_counts()["ssd_scan"]
    y, st = ss.ssd_scan(*[t.cuda() for t in (x, Bm, Cm, dt, A)])
    torch.cuda.synchronize()
    n1 = K_.route_counts()["ssd_scan"]
    assert {r: n1[r] - n0[r] for r in n1} == {
        r: int(r == route) for r in sk.ROUTES}
    yw, sw = ss.ssd_scan(x, Bm, Cm, dt, A)
    _close(yw, y, dtype)
    _close(sw, st, dtype)


@pytest.mark.gpu
def test_launch_on_second_device():
    """With device 0 current, one consensus kernel, flash_attention and
    ssd_scan run on cuda:1 (operands, outputs and launches there) and
    match their twins; device 0 stays current."""
    _need_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ss
    dev = torch.device("cuda:1")
    torch.cuda.set_device(0)
    rng = np.random.default_rng(11)
    B, N, L = 2, 9, 64
    match = _t(rng, 0, L, (B, N))
    alive = torch.as_tensor(rng.random((B, N)) < 0.8)
    lterm = _t(rng, 1, 4, (B, L))
    cur, maj = _t(rng, 1, 4, (B,)), torch.full((B,), 5, dtype=torch.int32)
    want = rt.commit_majority(match, alive, lterm, cur, maj)
    got = rt.commit_majority(*(t.to(dev) for t in (match, alive, lterm, cur,
                                                   maj)))
    assert got.device == dev
    _equal([want], [got])
    bf16 = torch.bfloat16
    q, k, v = (_att(rng, (1, 130, 6, 64), bf16),
               _att(rng, (1, 130, 2, 64), bf16),
               _att(rng, (1, 130, 2, 64), bf16))
    got = fa.flash_attention(q.to(dev), k.to(dev), v.to(dev))
    assert got.device == dev
    _close(fa.flash_attention(q, k, v), got, bf16)
    x, Bm, Cm = (_att(rng, s, bf16) * 0.5 for s in
                 ((1, 2, 100, 4, 64, 128), (1, 2, 100, 128),
                  (1, 2, 100, 128)))
    dt = torch.nn.functional.softplus(_att(rng, (1, 2, 100, 4),
                                           torch.float32))
    A = -torch.exp(_att(rng, (4,), torch.float32) * 0.3)
    y, st = ss.ssd_scan(*(t.to(dev) for t in (x, Bm, Cm, dt, A)))
    torch.cuda.synchronize(dev)
    assert y.device == dev and st.device == dev
    yw, sw = ss.ssd_scan(x, Bm, Cm, dt, A)
    _close(yw, y, bf16)
    _close(sw, st, bf16)
    assert torch.cuda.current_device() == 0


@pytest.mark.gpu
def test_mamba2_prefill_decode_on_the_card():
    """The reduced mamba2 at a ragged prompt: the card's prefill and two
    decode steps against the CPU's on the same float32 weights, ssd_scan
    once per layer in prefill and never in decode."""
    _need_cuda()
    import copy
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels.ssd_scan import ops as ss
    from repro_torch.models import lm
    cfg = get_config("mamba2-130m").reduced().with_layers(2)
    run = RunConfig(remat=False, param_dtype="float32",
                    activation_dtype="float32")
    m_cpu = lm.init_lm(cfg, run, seed=2, device="cpu")
    m_gpu = copy.deepcopy(m_cpu).to("cuda")
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, 256, (2, 37)).astype(np.int32))
    outs = []
    for model, dev in ((m_cpu, "cpu"), (m_gpu, "cuda")):
        caches = lm.alloc_caches(cfg, 2, 40, torch.float32, dev)
        n0 = ss.ssd_scan.launches
        with torch.no_grad():
            logits = [lm.forward(model, toks.to(dev), mode="prefill",
                                 caches=caches)[0]]
            pos = torch.full((2,), 37, dtype=torch.int32, device=dev)
            for step in range(2):
                nxt = toks[:, step:step + 1].to(dev)
                logits.append(lm.forward(model, nxt, mode="decode",
                                         caches=caches,
                                         cache_len=pos + step)[0])
        n = ss.ssd_scan.launches - n0
        assert n == (2 if dev == "cuda" else 0)
        outs.append([t.cpu() for t in logits])
    for want, got in zip(*outs):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.gpu
def test_run_chaos_on_the_card():
    """A warned mass-kill drill on a small cluster under an AWS trace
    market: the card's `ChaosReport` (snapshots and events included)
    equals the CPU's from the same draws, and the safety checks and the
    trace-replayed leader timeline hold."""
    _need_cuda()
    import dataclasses
    from repro_torch.core.cluster_config import ClusterConfig, SiteConfig
    from repro_torch.core.draws import CpuDraws
    from repro_torch.market import mass_kill, run_chaos
    sites = tuple(SiteConfig(f"g{i}", followers=f, rtt_intra=1,
                             rtt_inter=6 + 2 * i, on_demand_price=0.0416,
                             spot_price_mean=0.0125)
                  for i, f in enumerate((2, 1, 1)))
    cfg = ClusterConfig(name="gchaos", sites=sites, max_log=256,
                        key_space=64, max_secretaries=4, max_observers=8,
                        period_ticks=50)
    faults = mass_kill(25, n_nodes=cfg.max_nodes, ticks=60,
                       spare=(0, 1, 2), warning_ticks=3)
    kw = dict(warning_ticks=3, ticks=60, seed=0, spot_bid=10.0,
              trace_on=True)
    dev = torch.device("cuda")
    card = run_chaos(cfg, faults, device=dev, draws=CpuDraws(0, dev), **kw)
    host = run_chaos(cfg, faults, device="cpu", **kw)
    a, b = dataclasses.asdict(card), dataclasses.asdict(host)
    for k in ("trace", "events"):
        a.pop(k), b.pop(k)
    assert a == b
    for x, y in zip(card.trace, host.trace):
        for k in x:
            assert np.array_equal(x[k], y[k]), k
    assert card.events == host.events
    assert card.safety_error is None and card.trace_leader_match
    assert card.killed_total >= 1


def _walk_cluster(name, followers):
    from repro_torch.core.cluster_config import ClusterConfig, SiteConfig
    sites = tuple(SiteConfig(f"{name}{i}", followers=f, rtt_intra=1,
                             rtt_inter=6 + 2 * i, on_demand_price=0.0416,
                             spot_price_mean=0.0125 + 0.001 * i)
                  for i, f in enumerate(followers))
    return ClusterConfig(name=name, sites=sites, max_log=256, key_space=64,
                         max_secretaries=4, max_observers=8,
                         period_ticks=50)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["default", "write16", "open_loop",
                                  "observers", "pad_nodes", "fleet"])
def test_export_walk_trace_replays_on_the_card(case):
    """The walk exported on the card from `TorchDraws(seed)` replays a
    same-seed card sim at the exporter's rates and shapes, at another
    write rate, under an open-loop plan, with digest-tier observers,
    with padded nodes, and as a fleet member padded to a wider member:
    the trace-market run's reports and state equal the process-market
    run's (the price stream depends on the seed and S alone)."""
    _need_cuda()
    from repro_torch import market as TM
    from repro_torch import workload as TW
    from repro_torch.core.fleet import FleetSim, MemberSpec
    from repro_torch.core.runtime import BWRaftSim
    from repro_torch.core.state import member
    dev = torch.device("cuda")
    cfg = _walk_cluster("gwalk", (2, 1))
    trace = TM.export_walk_trace(cfg, seed=4, epochs=2, device=dev)
    if case == "fleet":
        other = MemberSpec(cfg=_walk_cluster("gwide", (4, 3)), seed=9)
        a = FleetSim([MemberSpec(cfg=cfg, seed=4, phi=0.02), other],
                     device=dev)
        b = FleetSim([MemberSpec(cfg=cfg, seed=4, phi=0.02, market="trace",
                                 trace=trace), other], device=dev)
        for e in range(2):
            assert repr(a.run_epoch()[0]) == repr(b.run_epoch()[0]), e
        sa, sb = member(a.state, 0), member(b.state, 0)
    else:
        kw = {"default": {}, "write16": {"write_rate": 16.0},
              "observers": {"n_observers": 16},
              "pad_nodes": {"pad_nodes": 3},
              "open_loop": {"arrivals": TW.OpenLoop(
                  write=TW.DiurnalRate(3.0, amplitude=0.5, phase=0.3),
                  read=TW.FlashCrowd(TW.DiurnalRate(20.0, amplitude=0.5),
                                     mult=4.0, every_ticks=25,
                                     burst_ticks=5),
                  ticks=60)}}[case]
        a = BWRaftSim(cfg, seed=4, phi=0.02, device=dev, **kw)
        b = BWRaftSim(cfg, seed=4, phi=0.02, market="trace", trace=trace,
                      device=dev, **kw)
        for e in range(2):
            assert repr(a.run_epoch()) == repr(b.run_epoch()), (case, e)
        sa, sb = a.state, b.state
    for k, v in sa.items():
        assert torch.equal(v, sb[k]), (case, k)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 2])
def test_train_step_on_the_card(M):
    """One float32 train step of the reduced smollm-360m (TF32 off) on
    the card against the CPU from the same weights and batch: loss and
    grad_norm rtol 1e-4, every parameter within 2 x lr + 1e-6 relative
    (AdamW's first step is +-lr wherever |g| >> eps, so a gradient of
    rounding size that flips sign moves a parameter by up to 2 x lr)."""
    _need_cuda()
    import copy
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import steps as S
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("smollm-360m").reduced().with_layers(2)
    run = RunConfig(remat=True, param_dtype="float32",
                    activation_dtype="float32", num_microbatches=M)
    m0 = lm.init_lm(cfg, run, seed=3, device="cpu", trainable=True)
    batch = TokenPipeline(DataConfig(cfg.vocab_size, 32, 4)).batch_at(
        0, device="cpu")
    out = []
    for dev in ("cpu", "cuda"):
        st = S.init_train_state(copy.deepcopy(m0).to(dev))
        st, met = S.make_train_step(cfg, run)(
            st, {k: v.to(dev) for k, v in batch.items()})
        out.append((met, [p.detach().cpu() for p in
                          st["params"].parameters()]))
    (mc, pc), (mg, pg) = out
    for k in ("loss", "grad_norm"):
        assert abs(mg[k].item() - mc[k].item()) <= 1e-4 * abs(mc[k].item())
    for a, b in zip(pc, pg):
        assert ((a - b).abs() <= 2 * run.learning_rate + 1e-6 * a.abs()
                ).all()


@pytest.mark.gpu
def test_coordinator_and_checkpoint_on_the_card(tmp_path):
    """The coordinator on the card: a leader, a CKPT_COMMIT read back
    from the state machine, a new leader after killing the old one, and
    a card tree restored from the store bit for bit with its digest; the
    four per-tick kernels launch once per coordinator tick."""
    _need_cuda()
    from repro_torch import kernels as K
    from repro_torch.checkpoint.store import CheckpointStore, tree_digest
    from repro_torch.coord.coordinator import ConsensusCoordinator
    from repro_torch.core import state as SM
    cfg = _walk_cluster("gcoord", (2, 2, 1))
    K.reset_launch_counts()
    coord = ConsensusCoordinator(cfg, seed=2)
    lid = coord.wait_for_leader()
    gen = torch.Generator(device="cuda").manual_seed(0)
    tree = {"w": torch.randn((300, 40), generator=gen, device="cuda")
            .to(torch.bfloat16),
            "opt": {"step": torch.ones((), dtype=torch.int32,
                                       device="cuda")}}
    store = CheckpointStore(str(tmp_path))
    digest = store.save(7, tree, blocking=False)
    store.wait()
    coord.commit_checkpoint(7, digest)
    assert coord.last_committed_checkpoint() == (7, int(digest[:3], 16))
    coord.kill_pod(lid)
    assert coord.wait_for_leader() != lid
    coord.kv._step(20)
    step, tag = coord.last_committed_checkpoint()
    got, d2 = store.restore(step, tree)
    assert d2 == digest == tree_digest(got) and tag == int(d2[:3], 16)
    assert got["w"].device.type == "cuda"
    assert torch.equal(got["w"], tree["w"])
    ticks = int(coord.sim.state["tick"])
    counts = K.launch_counts()
    assert ticks > 0 and all(counts[k] == ticks for k in (
        "log_match_append", "commit_majority", "apply_last_wins",
        "leader_fanout"))
    assert SM.leader_id(coord.sim.state).device.type == "cuda"


# --------------------------------------------------------------------- #
# MoE, cross-attention and the encoder-decoder (ROADMAP item 10d)
# --------------------------------------------------------------------- #
def _attn_layers(cfg):
    """(self-attention layers, cross layers) of `cfg`."""
    from repro_torch.models import lm
    kinds = lm.layer_kinds(cfg)
    G = cfg.num_layers // len(kinds)
    return (G * sum(k.mixer == "attn" for k in kinds),
            G * sum(k.cross for k in kinds))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "llama-3.2-vision-90b",
                                  "seamless-m4t-medium",
                                  "jamba-1.5-large-398b"])
def test_10d_prefill_decode_on_the_card(arch):
    """The reduced model, float32 with a drawn gate and a seeded context:
    the card's prefill and three decode steps against the CPU's on the
    same weights within 1e-3, `chip_smoke.py`'s float32 card-vs-CPU
    tolerance for whole models: on these random weights attention is
    ill-conditioned, so each layer's own float32 rounding (phase 16(a)
    reads the reduced vision's layers, fed equal inputs, up to 1.4e-4
    apart, the float32 twin itself 3.3e-5 from float64, the kernels no
    further) carries through five layers and the decode steps (one
    draw put 30 of 12,288 logits up to 5.5e-4 apart); flash once per
    self-attention layer in prefill, decode once per self-attention and
    once per cross layer a step."""
    _need_cuda()
    import copy
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.serve import draw_gates, seeded_context
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    run = RunConfig(remat=False, param_dtype="float32",
                    activation_dtype="float32")
    m_cpu = draw_gates(lm.init_lm(cfg, run, seed=4, device="cpu"), 5)
    m_gpu = copy.deepcopy(m_cpu).to("cuda")
    B, P, G = 2, 24, 3
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, 256, (B, P)).astype(np.int32))
    ctx = seeded_context(cfg, B, P, 7)
    n_self, n_cross = _attn_layers(cfg)
    outs = []
    for model, dev in ((m_cpu, "cpu"), (m_gpu, "cuda")):
        caches = lm.alloc_caches(cfg, B, P + G, torch.float32, dev)
        K.reset_launch_counts()
        with torch.no_grad():
            logits = [lm.forward(model, toks.to(dev), mode="prefill",
                                 caches=caches,
                                 **{k: v.to(dev) for k, v in ctx.items()})[0]]
            pos = torch.full((B,), P, dtype=torch.int32, device=dev)
            for step in range(G):
                nxt = toks[:, step:step + 1].to(dev)
                logits.append(lm.forward(model, nxt, mode="decode",
                                         caches=caches,
                                         cache_len=pos + step)[0])
        counts = K.launch_counts()
        if dev == "cuda":
            assert counts["flash_attention"] == n_self
            assert counts["decode_attention"] == (n_self + n_cross) * G
        outs.append([t.cpu() for t in logits])
    print(f"{arch}: max |card - CPU| over the logits "
          f"{max((g - w).abs().max().item() for w, g in zip(*outs)):.4g}")
    for want, got in zip(*outs):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "llama-3.2-vision-90b",
                                  "seamless-m4t-medium"])
def test_10d_reduced_serve_on_the_card(arch):
    """`serve()` of the reduced model on the card with the reference's
    context stubs: flash once per self-attention layer per batch, decode
    once per self-attention and per cross layer per token, tokens in
    range."""
    _need_cuda()
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.serve import serve
    cfg = get_config(arch).reduced()
    n_self, n_cross = _attn_layers(cfg)
    K.reset_launch_counts()
    r = serve(cfg, RunConfig(remat=False), device="cuda", requests=16,
              batch=8, prompt_len=24, gen_len=5, seed=1)
    counts = K.launch_counts()
    assert counts["flash_attention"] == n_self * 2
    assert counts["decode_attention"] == (n_self + n_cross) * 2 * 5
    for g in r["generated"]:
        assert g.shape == (8, 6) and g.min() >= 0 and \
            g.max() < cfg.padded_vocab
