"""The port's four kernel twins against the JAX kernel layer: the same
numpy-seeded int32 inputs go through the JAX `ops.py` op (the Pallas
kernel, in interpret mode on the CPU), the JAX `ref.py`, and the
PyTorch twin, and all three must be bit-equal — across dead or padded
rows, degenerate windows, no voters, no leader, budget 0, the
warned-secretary handoff, and negative or out-of-range keys.  On CPU
tensors the ops run the twins and count no launch; on the card the CUDA
kernels are held against the same twins (`test_torch_cuda.py` and
`chip_smoke.py`)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.leader_fanout import ops as j_lf
from repro.kernels.leader_fanout import ref as j_lf_ref
from repro.kernels.raft_tick import ops as j_rt
from repro.kernels.raft_tick import ref as j_rt_ref
from repro_torch import kernels as tk
from repro_torch.kernels.leader_fanout import ops as t_lf
from repro_torch.kernels.raft_tick import ops as t_rt


def _i32(rng, lo, hi, shape):
    return rng.integers(lo, hi, shape).astype(np.int32)


def _both(case):
    """(jax arrays, CPU tensors) of one numpy case."""
    return ([jnp.asarray(v) for v in case.values()],
            [torch.as_tensor(np.array(v)) for v in case.values()])


def _assert_same(outs, names):
    base = [np.asarray(x) for x in outs[0]]
    for other in outs[1:]:
        for name, a, b in zip(names, base, other):
            b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
            assert a.shape == b.shape, name
            assert np.array_equal(a, b.astype(a.dtype)), name


# --------------------------------------------------------------------- #
def lma_case(seed, N, L, W, *, due_frac=0.5, empty=False):
    rng = np.random.default_rng(seed)
    hi = 1 if empty else L + 1
    return dict(
        log_term=_i32(rng, 0, 4, (N, L)), log_key=_i32(rng, 0, 8, (N, L)),
        log_val=_i32(rng, 0, 64, (N, L)),
        ldr_term=_i32(rng, 0, 4, (L,)), ldr_key=_i32(rng, 0, 8, (L,)),
        ldr_val=_i32(rng, 0, 64, (L,)),
        log_len=_i32(rng, 0, hi, (N,)), app_from_len=_i32(rng, 0, hi, (N,)),
        app_upto=_i32(rng, 0, hi, (N,)), due=rng.random(N) < due_frac)


LMA_CASES = [dict(seed=s, N=int(n), L=int(l), W=int(w))
             for s, (n, l, w) in enumerate(
                 np.random.default_rng(11).integers([1, 1, 1], [24, 200, 64],
                                                    (6, 3)))] + [
    dict(seed=90, N=1, L=1, W=1),
    dict(seed=91, N=3, L=7, W=64, empty=True),          # empty logs
    dict(seed=92, N=5, L=33, W=256, due_frac=1.0),      # W wider than L
    dict(seed=93, N=4, L=16, W=8, due_frac=0.0),        # nobody due
]


@pytest.mark.parametrize("case", LMA_CASES,
                         ids=lambda c: "-".join(map(str, c.values())))
def test_log_match_append_bit_equal(case):
    kw = dict(case)
    W = kw.pop("W")
    c = lma_case(kw.pop("seed"), kw.pop("N"), kw.pop("L"), W, **kw)
    j, t = _both(c)
    names = ("log_term", "log_key", "log_val", "new_len", "accept")
    ref = list(j_rt_ref.log_match_append_ref(*j, w=W))
    ref[4] = ref[4] != 0
    _assert_same([j_rt.log_match_append(*j, w=W), ref,
                  t_rt.log_match_append(*t, w=W)], names)


def commit_case(seed, N, L, *, dead_frac=0.3):
    rng = np.random.default_rng(seed)
    return dict(match_len=_i32(rng, 0, L + 1, (N,)),
                voter_alive=rng.random(N) >= dead_frac,
                ldr_term=_i32(rng, 0, 4, (L,)),
                ldr_cur_term=np.int32(rng.integers(0, 4)))


@pytest.mark.parametrize("seed,N,L,majority,dead_frac", [
    (0, 7, 100, 4, 0.3), (1, 23, 199, 12, 0.1), (2, 9, 40, 1, 0.5),
    (3, 12, 64, 30, 0.2),                 # majority above N: nothing
    (4, 8, 32, 5, 1.0),                   # no live voter
    (5, 1, 16, 1, 0.0), (6, 15, 150, 8, 0.0)])
def test_commit_majority_bit_equal(seed, N, L, majority, dead_frac):
    c = commit_case(seed, N, L, dead_frac=dead_frac)
    j, t = _both(c)
    outs = [(j_rt.commit_majority(*j, majority),),
            (j_rt_ref.commit_majority_ref(*j, majority),),
            (t_rt.commit_majority(*t, majority),)]
    _assert_same(outs, ("commit",))


@pytest.mark.parametrize("seed,N,K,A", [
    (0, 7, 64, 8), (1, 23, 199, 3), (2, 1, 1, 1), (3, 12, 50, 8),
    (4, 5, 3, 8)])
def test_apply_last_wins_bit_equal(seed, N, K, A):
    """Duplicate keys (last wins), negative keys (wrap once) and keys
    outside [0, K) (dropped)."""
    rng = np.random.default_rng(seed)
    c = dict(kv=_i32(rng, -4, 4, (N, K)),
             keys=_i32(rng, -K - 3, K + 3, (N, A)),
             vals=_i32(rng, 0, 2 ** 20, (N, A)),
             valid=rng.random((N, A)) < 0.7)
    j, t = _both(c)
    _assert_same([(j_rt.apply_last_wins(*j),),
                  (j_rt_ref.apply_last_wins_ref(*j),),
                  (t_rt.apply_last_wins(*t),)], ("kv",))


def fanout_case(seed, N, L, *, has_leader=True, alive_frac=0.8,
                warn_frac=0.3):
    rng = np.random.default_rng(seed)
    warn = np.where(rng.random(N) < warn_frac, rng.integers(0, 5, N), -1)
    arrive = np.where(rng.random(N) < 0.6, -1, rng.integers(0, 40, N))
    s = lambda lo, hi: np.int32(rng.integers(lo, hi))
    return dict(
        role=_i32(rng, 0, 6, (N,)), alive=rng.random(N) < alive_frac,
        warn_timer=warn.astype(np.int32), sec_of=_i32(rng, -1, N, (N,)),
        match_len=_i32(rng, 0, L + 1, (N,)),
        app_arrive_t=arrive.astype(np.int32),
        app_from_len=_i32(rng, 0, L + 1, (N,)),
        app_upto=_i32(rng, 0, L + 1, (N,)), app_term=_i32(rng, 0, 4, (N,)),
        app_commit=_i32(rng, 0, L + 1, (N,)), rtt=_i32(rng, 1, 20, (N, N)),
        lid_c=s(0, N), has_leader=np.asarray(has_leader),
        tick=s(0, 100), ldr_len=s(0, L + 1), ldr_term=s(0, 4),
        ldr_commit=s(0, L + 1))


def handoff_case(seed):
    """Every follower wired to an alive secretary, half of them warned:
    the warned ones hand their followers back to the leader."""
    c = fanout_case(seed, 24, 64, alive_frac=1.0, warn_frac=0.0)
    c["role"][:] = 0
    c["role"][7:15] = 3
    c["sec_of"][:] = -1
    c["sec_of"][:7] = 7 + np.arange(7)
    c["warn_timer"][7:15:2] = 2
    c["app_arrive_t"][:] = -1
    c["lid_c"] = np.int32(0)
    return c


FANOUT = [(fanout_case(s, int(n), int(l)), b, m, e)
          for s, (n, l, b, m, e) in enumerate(
              np.random.default_rng(7).integers([1, 1, 0, 1, 1],
                                                [24, 128, 20, 64, 64],
                                                (6, 5)))] + [
    (fanout_case(50, 20, 64, has_leader=False), 16, 256, 32),   # no leader
    (fanout_case(51, 20, 64, alive_frac=0.0), 16, 256, 32),     # all dead
    (fanout_case(52, 20, 64), 0, 256, 32),                      # budget 0
    (fanout_case(53, 20, 64, warn_frac=1.0), 16, 256, 32),
    (handoff_case(54), 16, 256, 32),
    (handoff_case(55), 2, 256, 32),
]


@pytest.mark.parametrize("case,budget,max_ship,epm", FANOUT,
                         ids=[str(i) for i in range(len(FANOUT))])
def test_leader_fanout_bit_equal(case, budget, max_ship, epm):
    kw = dict(msg_budget=int(budget), max_ship=int(max_ship),
              entries_per_msg=int(epm))
    j, t = _both(case)
    names = ("app_arrive_t", "app_from_len", "app_upto", "app_term",
             "app_commit", "work")
    _assert_same([j_lf.leader_fanout(*j, **kw),
                  j_lf_ref.leader_fanout_ref(*j, **kw),
                  t_lf.leader_fanout(*t, **kw)], names)


def test_cpu_ops_launch_nothing():
    """On CPU tensors every op runs its twin: the launch counts stay 0."""
    tk.reset_launch_counts()
    c = lma_case(0, 5, 20, 8)
    t_rt.log_match_append(*_both(c)[1], w=8)
    t_rt.commit_majority(*_both(commit_case(0, 5, 20))[1], 3)
    t_lf.leader_fanout(*_both(fanout_case(0, 6, 10))[1], msg_budget=4,
                       max_ship=16, entries_per_msg=4)
    assert tk.launch_counts() == {name: 0 for name in tk.OPS}


def test_ops_reject_other_devices():
    meta = torch.zeros((3, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        t_rt.apply_last_wins(meta, meta[:, :2], meta[:, :2],
                             torch.zeros((3, 2), dtype=torch.bool,
                                         device="meta"))
