"""The port's six kernel twins against the JAX kernel layer: the same
numpy-seeded inputs go through the JAX `ops.py` op (the Pallas kernel,
in interpret mode on the CPU), the JAX `ref.py`, and the PyTorch twin,
and all three must be bit-equal, floats included — across dead or
padded rows, degenerate windows, no voters, no leader, budget 0, the
warned-secretary handoff, negative or out-of-range keys, ragged, empty
and dropped groups, dead observers and dead wired followers.  The port's
ops take a leading member axis B: single cases run at B = 1, and the
batched cases stack several members into one call, which must equal the
JAX op member by member.  On CPU tensors the ops run the twins and count
no launch; on the card the CUDA kernels are held against the same twins
(`test_torch_cuda.py` and `chip_smoke.py`)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from repro.core import fleet as j_fleet
from repro.kernels.ae_sync import ops as j_ae
from repro.kernels.ae_sync import ref as j_ae_ref
from repro.kernels.group_digest import ops as j_gd
from repro.kernels.group_digest import ref as j_gd_ref
from repro.kernels.leader_fanout import ops as j_lf
from repro.kernels.leader_fanout import ref as j_lf_ref
from repro.kernels.raft_tick import ops as j_rt
from repro.kernels.raft_tick import ref as j_rt_ref
from repro_torch import kernels as tk
from repro_torch.core import fleet as t_fleet
from repro_torch.kernels.ae_sync import ops as t_ae
from repro_torch.kernels.group_digest import ops as t_gd
from repro_torch.kernels.leader_fanout import ops as t_lf
from repro_torch.kernels.raft_tick import ops as t_rt


def _i32(rng, lo, hi, shape):
    return rng.integers(lo, hi, shape).astype(np.int32)


def _both(case):
    """(jax arrays, B = 1 CPU tensors) of one numpy case."""
    return ([jnp.asarray(v) for v in case.values()],
            [torch.as_tensor(np.array(v))[None] for v in case.values()])


def _stacked(cases):
    """The B CPU tensors of several numpy cases, stacked by member."""
    return [torch.as_tensor(np.stack([np.asarray(c[k]) for c in cases]))
            for k in cases[0]]


def _assert_same(outs, names):
    """outs[0] and outs[1] are unbatched JAX results, outs[2] the port's
    B = 1 result."""
    base = [np.asarray(x) for x in outs[0]]
    for other in outs[1:]:
        for name, a, b in zip(names, base, other):
            b = b[0].numpy() if isinstance(b, torch.Tensor) \
                else np.asarray(b)
            assert a.shape == b.shape, name
            assert np.array_equal(a, b.astype(a.dtype)), name


def _assert_members(got, wants, names):
    """A batched port result equals each member's JAX result."""
    for b, want in enumerate(wants):
        for name, g, w in zip(names, got, want):
            w = np.asarray(w)
            assert np.array_equal(g[b].numpy().astype(w.dtype), w), (b, name)


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


def lma_edge_case(kind, seed, N=6, L=24, W=8):
    """The window's edges, every row due: from = 0 (prev < 0 reads
    position 0, which the window overwrites with another term), from =
    L, upto below from, a matching log longer than the window, W = 1.
    Returns (case, W)."""
    c = lma_case(seed, N, L, W, due_frac=1.0)
    rng = np.random.default_rng(seed + 1000)
    frm, up = c["app_from_len"], c["app_upto"]
    if kind == "from0":
        frm[:] = 0
        up[:] = rng.integers(1, W + 1, N)
        c["log_term"][:, 0] = c["ldr_term"][0] + 1
    elif kind == "fromL":
        frm[:] = L
        up[:] = L
        c["log_term"][::2, L - 1] = c["ldr_term"][L - 1]
    elif kind == "upto_below_from":
        frm[:] = rng.integers(4, L + 1, N)
        up[:] = frm - rng.integers(1, 4, N)
    elif kind == "longer":
        c["log_term"][:] = c["ldr_term"]
        c["log_len"][:] = L
        frm[:] = rng.integers(1, L - W, N)
        up[:] = frm + W // 2
    elif kind == "w1":
        W = 1
    return c, W


LMA_EDGES = ["from0", "fromL", "upto_below_from", "longer", "w1"]


@pytest.mark.parametrize("kind", LMA_EDGES)
def test_log_match_append_window_edges(kind):
    c, W = lma_edge_case(kind, 100 + LMA_EDGES.index(kind))
    j, t = _both(c)
    names = ("log_term", "log_key", "log_val", "new_len", "accept")
    ref = list(j_rt_ref.log_match_append_ref(*j, w=W))
    ref[4] = ref[4] != 0
    got = t_rt.log_match_append(*t, w=W)
    _assert_same([j_rt.log_match_append(*j, w=W), ref, got], names)
    assert bool(got[4].all()) == (kind in ("from0", "longer"))


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
    (5, 1, 16, 1, 0.0), (6, 15, 150, 8, 0.0),
    (7, 64, 33, 33, 0.2)])                # more voters than entries
def test_commit_majority_bit_equal(seed, N, L, majority, dead_frac):
    c = commit_case(seed, N, L, dead_frac=dead_frac)
    j, t = _both(c)
    outs = [(j_rt.commit_majority(*j, majority),),
            (j_rt_ref.commit_majority_ref(*j, majority),),
            (t_rt.commit_majority(*t, torch.tensor([majority],
                                                   dtype=torch.int32)),)]
    _assert_same(outs, ("commit",))


APPLY_CASES = [(0, 7, 64, 8, False), (1, 23, 199, 3, False),
               (2, 1, 1, 1, False), (3, 12, 50, 8, False),
               (4, 5, 3, 8, False),
               (5, 6, 40, 33, False), (6, 4, 40, 64, False),   # A > 32
               (7, 9, 20, 8, True), (8, 3, 20, 33, True)]      # one key


@pytest.mark.parametrize("seed,N,K,A,one_key", APPLY_CASES,
                         ids=["-".join(map(str, c[:4]))
                              + ("-one_key" if c[4] else "")
                              for c in APPLY_CASES])
def test_apply_last_wins_bit_equal(seed, N, K, A, one_key):
    """Duplicate keys (last wins), negative keys (wrap once) and keys
    outside [0, K) (dropped); A past one warp of lanes; every entry of a
    row on one key."""
    rng = np.random.default_rng(seed)
    keys = _i32(rng, -K - 3, K + 3, (N, 1 if one_key else A))
    c = dict(kv=_i32(rng, -4, 4, (N, K)),
             keys=np.repeat(keys, A, axis=1) if one_key else keys,
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


def fanout_cut_case(seed, N, cut, L=64, max_ship=32, epm=8):
    """Every node a live follower of leader 0 with nothing in flight;
    nodes 1 and 2 alive, unwarned secretaries, node 3 relayed through
    node 1, so n_sec = 2 and every node past 3 is direct.  The budget
    puts the rank cut on lane 31 ("lane31"), on lane 0 of the next warp
    ("lane32") or past the total ("past").  Returns (case, budget)."""
    c = fanout_case(seed, N, L, alive_frac=1.0)
    c["role"][:] = 0
    c["role"][1:3] = 3
    c["warn_timer"][:] = -1
    c["sec_of"][:] = -1
    c["sec_of"][3] = 1
    c["app_arrive_t"][:] = -1
    c["lid_c"] = np.int32(0)
    c["has_leader"] = np.asarray(True)
    direct = np.arange(N) > 3
    pending = np.maximum(c["ldr_len"] - c["match_len"], 0)
    rank = np.cumsum(np.where(direct, 1 + np.minimum(pending, max_ship)
                              // epm, 0))
    at = {"lane31": rank[31], "lane32": rank[min(32, N - 1)],
          "past": rank[-1] + 1}[cut]
    return c, int(at) + 2


FANOUT_CUTS = [(n, cut) for n in (32, 33, 64, 65, 87)
               for cut in ("lane31", "lane32", "past")
               if not (n == 32 and cut == "lane32")]


@pytest.mark.parametrize("N,cut", FANOUT_CUTS)
def test_leader_fanout_rank_cut_at_warp_edges(N, cut):
    """The budget rank crosses a warp's edge: the last node shipped is
    lane 31, lane 0 of the next warp, or every direct node ships."""
    c, budget = fanout_cut_case(200 + N, N, cut)
    kw = dict(msg_budget=budget, max_ship=32, entries_per_msg=8)
    j, t = _both(c)
    names = ("app_arrive_t", "app_from_len", "app_upto", "app_term",
             "app_commit", "work")
    got = t_lf.leader_fanout(*t, **kw)
    _assert_same([j_lf.leader_fanout(*j, **kw),
                  j_lf_ref.leader_fanout_ref(*j, **kw), got], names)
    shipped = (got[0][0] != t[5][0]).numpy()
    last = {"lane31": 31, "lane32": 32, "past": N - 1}[cut]
    assert shipped[last] and not shipped[last + 1:].any()
    assert int(got[5][0]) == last - 3 + 2


def test_cpu_ops_launch_nothing():
    """On CPU tensors every op runs its twin: the launch counts stay 0."""
    tk.reset_launch_counts()
    c = lma_case(0, 5, 20, 8)
    t_rt.log_match_append(*_both(c)[1], w=8)
    t_rt.commit_majority(*_both(commit_case(0, 5, 20))[1],
                         torch.tensor([3], dtype=torch.int32))
    t_lf.leader_fanout(*_both(fanout_case(0, 6, 10))[1], msg_budget=4,
                       max_ship=16, entries_per_msg=4)
    t_ae.ae_sync(*_torch_ae(ae_case(0, 6, 8, 2)))
    gids, im, fm = group_case(0, 6, 2, 5, 3)
    t_gd.group_reduce(torch.as_tensor(gids), torch.as_tensor(im),
                      torch.as_tensor(fm), n_groups=2)
    assert tk.launch_counts() == {name: 0 for name in tk.OPS}


# --------------------------------------------------------------------- #
# batched calls: one call over B members == the JAX op per member
# --------------------------------------------------------------------- #
def test_raft_tick_ops_batched_per_member():
    """B = 3 members of one shape in one call, each with its own
    majority (a fleet mixes cluster sizes): every member equals its
    unbatched JAX op."""
    cases = [lma_case(20 + b, 9, 40, 16) for b in range(3)]
    got = t_rt.log_match_append(*_stacked(cases), w=16)
    _assert_members(got, [j_rt.log_match_append(
        *[jnp.asarray(v) for v in c.values()], w=16) for c in cases],
        ("log_term", "log_key", "log_val", "new_len", "accept"))
    cases = [commit_case(30 + b, 11, 50) for b in range(3)]
    majorities = [2, 6, 9]
    got = t_rt.commit_majority(*_stacked(cases),
                               torch.tensor(majorities, dtype=torch.int32))
    _assert_members((got,), [(j_rt.commit_majority(
        *[jnp.asarray(v) for v in c.values()], m),)
        for c, m in zip(cases, majorities)], ("commit",))
    rng = np.random.default_rng(40)
    cases = [dict(kv=_i32(rng, -4, 4, (5, 30)),
                  keys=_i32(rng, -33, 33, (5, 8)),
                  vals=_i32(rng, 0, 2 ** 20, (5, 8)),
                  valid=rng.random((5, 8)) < 0.7) for _ in range(3)]
    got = t_rt.apply_last_wins(*_stacked(cases))
    _assert_members((got,), [(j_rt.apply_last_wins(
        *[jnp.asarray(v) for v in c.values()]),) for c in cases], ("kv",))


def test_leader_fanout_batched_per_member():
    cases = [fanout_case(60, 14, 64), fanout_case(61, 14, 64, warn_frac=1.0),
             fanout_case(62, 14, 64, has_leader=False)]
    kw = dict(msg_budget=5, max_ship=32, entries_per_msg=8)
    got = t_lf.leader_fanout(*_stacked(cases), **kw)
    _assert_members(got, [j_lf.leader_fanout(
        *[jnp.asarray(v) for v in c.values()], **kw) for c in cases],
        ("app_arrive_t", "app_from_len", "app_upto", "app_term",
         "app_commit", "work"))


# --------------------------------------------------------------------- #
# group_reduce (the Multi-Raft group digest, DESIGN.md §9)
# --------------------------------------------------------------------- #
def group_case(seed, B, G, Fi, Ff, *, dropped_frac=0.2):
    rng = np.random.default_rng(seed)
    gids = np.where(rng.random(B) < dropped_frac, G,
                    rng.integers(0, max(G, 1), B)).astype(np.int32)
    return (gids, rng.integers(-50, 2 ** 20, (B, Fi)).astype(np.int32),
            (rng.standard_normal((B, Ff)) * 100.0).astype(np.float32))


def _same_bits(a, b):
    """Equal bit for bit (+0 and -0 apart), NaN where the other is NaN
    (whatever its payload)."""
    if a.dtype.kind != "f":
        return np.array_equal(a, b)
    nan = np.isnan(a)
    return np.array_equal(nan, np.isnan(b)) and np.array_equal(
        a.view(np.int32)[~nan], b.view(np.int32)[~nan])


def _check_group(gids, int_mat, flt_mat, G):
    j = [jnp.asarray(a) for a in (gids, int_mat, flt_mat)]
    t = [torch.as_tensor(a) for a in (gids, int_mat, flt_mat)]
    outs = [j_gd.group_reduce(*j, n_groups=G),
            j_gd_ref.group_reduce_ref(*j, n_groups=G),
            t_gd.group_reduce(*t, n_groups=G)]
    base = [np.asarray(x) for x in outs[0]]
    for other in outs[1:]:
        for name, a, b in zip(("int_sum", "flt_sum", "flt_max"), base,
                              other):
            b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert _same_bits(a, b), (name, G)
    return outs[2]


@pytest.mark.parametrize("seed,B,G,Fi,Ff,dropped", [
    (0, 13, 3, 40, 3, 0.2),       # ragged groups, B not a multiple of 8
    (1, 5, 1, 355, 3, 0.0),       # the slice's fleet shape: one group
    (2, 21, 6, 7, 2, 0.5),        # many groups, half dropped
    (3, 9, 4, 150, 1, 0.0)])
def test_group_reduce_bit_equal(seed, B, G, Fi, Ff, dropped):
    _check_group(*group_case(seed, B, G, Fi, Ff, dropped_frac=dropped), G)


def group_edge_case(seed, B, G, *, Fi=20, empty=None):
    """Ids over [0, G] (G drops), group `empty` left empty; int lanes
    over all of int32, so the sums wrap; six float lanes: general
    values, only +0 and -0 (the max settles ties of zeros), -0 / -inf /
    -1.5, values with NaN, -inf / +inf / 1 (inf - inf is NaN), and
    values with +0 and -0."""
    rng = np.random.default_rng(seed)
    gids = rng.integers(0, G + 1, B).astype(np.int32)
    if empty is not None:
        gids[gids == empty] = (empty + 1) % G
    pick = lambda vals: rng.choice(np.array(vals, np.float32), B)
    normal = (rng.standard_normal(B) * 100.0).astype(np.float32)
    flt = np.stack([
        normal, pick([0.0, -0.0]), pick([-0.0, -np.inf, -1.5]),
        np.where(rng.random(B) < 0.1, np.float32(np.nan), normal[::-1]),
        pick([-np.inf, np.inf, 1.0]),
        np.where(rng.random(B) < 0.5, pick([0.0, -0.0]), normal)], 1)
    return (gids, rng.integers(-2 ** 31, 2 ** 31, (B, Fi)).astype(np.int32),
            flt.astype(np.float32))


@pytest.mark.parametrize("B,G,empty", [
    (1, 1, None), (15, 3, None), (16, 3, 1), (17, 3, None), (32, 2, None),
    (33, 5, 4), (100, 3, 0), (40, 8, 5), (64, 8, None)])
def test_group_reduce_edges(B, G, empty):
    """B across the CUDA kernel's 8-member chunks; up to 8 groups, some
    empty; NaN, +-inf, +0 and -0 in the float lanes; int sums that wrap:
    the twin equals the JAX op and ref bit for bit."""
    gids, im, fm = group_edge_case(B * 7 + G, B, G, empty=empty)
    g_int, _, g_max = _check_group(gids, im, fm, G)
    if empty is not None:
        assert not g_int[empty].any() and (g_max[empty] == -np.inf).all()


def test_group_reduce_empty_and_all_dropped():
    """An empty group gives 0 sums and a -inf max; all members dropped
    leaves every group empty."""
    gids, im, fm = group_case(4, 6, 3, 5, 2)
    gids[:] = np.where(gids == 1, 0, gids)            # group 1 empty
    g_int, g_sum, g_max = _check_group(gids, im, fm, 3)
    assert not g_int[1].any() and not g_sum[1].any()
    assert (g_max[1] == -np.inf).all()
    g_int, g_sum, g_max = _check_group(np.full(6, 3, np.int32), im, fm, 3)
    assert not g_int.any() and not g_sum.any()
    assert (g_max == -np.inf).all()


def test_group_reduce_float_order_is_segment_sum_order():
    """One big group: the twin's ascending accumulation reproduces
    segment_sum's float result bit for bit."""
    rng = np.random.default_rng(42)
    B = 37
    flt = (rng.standard_normal((B, 3)) * 1e3).astype(np.float32)
    gids = np.zeros((B,), np.int32)
    got = t_gd.group_reduce(torch.as_tensor(gids),
                            torch.zeros((B, 1), dtype=torch.int32),
                            torch.as_tensor(flt), n_groups=1)[1]
    want = jax.ops.segment_sum(jnp.asarray(flt), jnp.asarray(gids),
                               num_segments=1)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_fleet_group_digest_equals_jax():
    """The fleet's packing around the kernel: `fleet._group_digest` on a
    synthetic digest (ragged groups, a dropped member, an empty group)
    equals the JAX fleet's, every leaf."""
    rng = np.random.default_rng(9)
    B, H = 7, 165
    dg = {}
    for k in j_fleet._GROUP_SUM_KEYS:
        if k in ("write_lat_hist", "read_lat_hist"):
            dg[k] = rng.integers(0, 50, (B, H)).astype(np.int32)
        elif k == "trace_metrics":
            dg[k] = rng.integers(0, 9, (B, 16)).astype(np.int32)
        elif k in j_fleet._GROUP_FLOAT_KEYS:
            dg[k] = (rng.random(B) * 10).astype(np.float32)
        else:
            dg[k] = rng.integers(0, 1000, B).astype(np.int32)
    dg["read_lat_max"] = (rng.random(B) * 30).astype(np.float32)
    gids = np.array([0, 2, 0, 4, 2, 2, 0], np.int32)     # 1 empty, 4 drop
    want = j_fleet._group_digest({k: jnp.asarray(v) for k, v in dg.items()},
                                 jnp.asarray(gids), 4, backend="xla")
    got = t_fleet._group_digest({k: torch.as_tensor(v)
                                 for k, v in dg.items()},
                                torch.as_tensor(gids), 4)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype, k
        assert np.array_equal(got[k].numpy(), w), k


# --------------------------------------------------------------------- #
# ae_sync (the digest tier's anti-entropy round, DESIGN.md §13)
# --------------------------------------------------------------------- #
def ae_case(seed, O, N, S, *, voter_frac=0.6, alive_frac=0.8, interval=4):
    rng = np.random.default_rng(seed)
    i = lambda lo, hi, sh: rng.integers(lo, hi, sh).astype(np.int32)
    u32 = lambda sh: rng.integers(0, 2 ** 32, sh, dtype=np.uint32)
    return dict(
        dobs_alive=rng.random(O) < 0.7, dobs_fol=i(-1, N + 2, (O,)),
        dobs_applied=i(0, 64, (O,)), dobs_term=i(0, 4, (O,)),
        dobs_digest=u32((O,)), dobs_synced_t=i(-1, 40, (O,)),
        ae_phase=i(0, max(interval, 1) + 1, (O,)),
        dobs_site=i(0, S, (O,)), alive=rng.random(N) < alive_frac,
        is_voter=rng.random(N) < voter_frac,
        applied_len=i(0, 65, (N,)), term=i(0, 4, (N,)),
        applied_digest=u32((N,)), site=i(0, S, (N,)),
        site_rtt=i(1, 20, (S, S)), tick=np.int32(rng.integers(0, 100)),
        ae_interval=np.int32(interval))


_AE_OUT = ("dobs_applied", "dobs_term", "dobs_digest", "dobs_synced_t")


def _torch_ae(case):
    """A numpy case as the port's B = 1 operands (uint32 as int32)."""
    out = []
    for v in case.values():
        a = np.array(v)
        out.append(torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32
                                   else a)[None])
    return out


def _check_ae(case):
    j = [jnp.asarray(v) for v in case.values()]
    jr = dict(case, dobs_alive=case["dobs_alive"].astype(np.int32),
              dobs_digest=case["dobs_digest"].view(np.int32),
              applied_digest=case["applied_digest"].view(np.int32))
    want = [np.asarray(x) for x in j_ae.ae_sync(*j)]
    want[2] = want[2].view(np.int32)
    ref = [np.asarray(x) for x in j_ae_ref.ae_sync_ref(
        *[jnp.asarray(v) for v in jr.values()])]
    got = t_ae.ae_sync(*_torch_ae(case))
    for name, w, r, g in zip(_AE_OUT, want, ref, got):
        assert g.dtype == torch.int32, name
        assert np.array_equal(w, r.astype(np.int32)), name
        assert np.array_equal(g[0].numpy(), w), name
    return [g[0].numpy() for g in got]


@pytest.mark.parametrize("seed,O,N,S,voter_frac,interval", [
    (0, 11, 9, 3, 0.6, 4), (1, 40, 23, 4, 0.3, 1), (2, 1, 1, 1, 1.0, 0),
    (3, 130, 17, 2, 0.5, 7), (4, 6, 5, 3, 0.9, 3)])
def test_ae_sync_bit_equal(seed, O, N, S, voter_frac, interval):
    _check_ae(ae_case(seed, O, N, S, voter_frac=voter_frac,
                      interval=interval))


def ae_edge_case(kind, seed, O, N, S, interval):
    """An `ae_case` at an edge of the CUDA kernel: "last_word" (the
    alive voters all in the last 32-node word, so the first one is
    there), "fol_out" (wired followers at -1, -5, N, N + 3 and in
    range), "neg_tick" (tick + ae_phase below 0) or "random"."""
    case = ae_case(seed, O, N, S, interval=interval)
    rng = np.random.default_rng(seed + 1)
    if kind == "last_word":
        lo = (N - 1) // 32 * 32
        case["alive"][:lo] &= ~case["is_voter"][:lo]    # dead voters only
        case["alive"][N - 1] = case["is_voter"][N - 1] = True
        case["dobs_fol"][::3] = N - 1
    elif kind == "fol_out":
        case["dobs_fol"] = rng.choice(np.array([-1, -5, N, N + 3, 0, N - 1],
                                               np.int32), O)
    elif kind == "neg_tick":
        case["tick"] = np.int32(-13)
        case["ae_phase"] = rng.integers(-9, 4, O).astype(np.int32)
    return case


AE_EDGES = ([("last_word", 40, n, 3, 4) for n in (1, 31, 32, 33, 64, 65,
                                                  128, 129, 1024, 1100)] +
            [("random", 50, 20, s, 1) for s in (1, 4, 5, 6)] +
            [("random", o, 9, 2, 1) for o in (1, 31, 32, 33, 129)] +
            [("fol_out", 60, 17, 3, 1), ("neg_tick", 60, 17, 3, 4),
             ("neg_tick", 60, 17, 3, 3), ("random", 60, 17, 3, 0),
             ("random", 60, 17, 3, -3)])


@pytest.mark.parametrize("kind,O,N,S,interval", AE_EDGES,
                         ids=lambda v: str(v))
def test_ae_sync_edges(kind, O, N, S, interval):
    """The CUDA kernel's edges: N across its 32-node words (the first
    alive voter in the last one), across the 128 of its one-trip
    instance and past the 1024 its lane masks cover, S * S across the 32
    entries its lanes preload, O across its warps,
    wired followers out of range, a negative tick + phase (floor mod)
    and an interval <= 0 (read as 1): the twin equals the JAX op and ref
    bit for bit."""
    _check_ae(ae_edge_case(kind, O * 31 + N + S, O, N, S, interval))


def test_ae_sync_no_voter_and_dead_observers():
    """No alive voter: nothing is due and every row passes through;
    dead slots never adopt even when due."""
    case = ae_case(5, 6, 8, 2)
    case["is_voter"][:] = False
    got = _check_ae(case)
    for name, g in zip(_AE_OUT, got):
        want = np.asarray(case[name])
        assert np.array_equal(g, want.view(np.int32) if want.dtype ==
                              np.uint32 else want), name
    case = ae_case(6, 6, 8, 2, interval=1)
    case["dobs_alive"][:] = False
    got = _check_ae(case)
    assert np.array_equal(got[3], case["dobs_synced_t"])


def test_ae_sync_dead_wired_follower_falls_back():
    """A slot wired to a dead voter syncs from the first alive voter and
    ages by that voter's site hop."""
    case = ae_case(7, 4, 6, 2, interval=1)
    case["dobs_alive"][:] = True
    case["is_voter"][:] = True
    case["alive"][:] = [False, True, True, True, True, True]
    case["dobs_fol"][:] = 0
    case["dobs_applied"][:] = 0
    got = _check_ae(case)
    assert (got[0] == case["applied_len"][1]).all()
    hop = case["site_rtt"][case["dobs_site"], case["site"][1]]
    assert np.array_equal(got[3], case["tick"] - hop)


def test_ae_sync_monotone_adoption():
    """A slot ahead of its source keeps its applied index and digest."""
    case = ae_case(8, 4, 6, 2, interval=1)
    case["dobs_alive"][:] = True
    case["dobs_applied"][:] = 1000
    case["applied_len"][:] = 0
    got = _check_ae(case)
    assert (got[0] == 1000).all()
    assert np.array_equal(got[2], case["dobs_digest"].view(np.int32))


def test_ae_sync_batched_per_member():
    """B = 3 members in one call, each its own tick and interval."""
    cases = [ae_case(10 + b, 9, 7, 3, interval=b + 1) for b in range(3)]
    got = t_ae.ae_sync(*[torch.cat(ts) for ts in
                         zip(*[_torch_ae(c) for c in cases])])
    for b, case in enumerate(cases):
        want = [np.asarray(x) for x in j_ae.ae_sync(
            *[jnp.asarray(v) for v in case.values()])]
        want[2] = want[2].view(np.int32)
        for name, g, w in zip(_AE_OUT, got, want):
            assert np.array_equal(g[b].numpy(), w), (b, name)


def test_ops_reject_other_devices():
    meta = torch.zeros((3, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        t_rt.apply_last_wins(meta, meta[:, :2], meta[:, :2],
                             torch.zeros((3, 2), dtype=torch.bool,
                                         device="meta"))
