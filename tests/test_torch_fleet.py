"""The port's batched fleet (`core/fleet.py`) and Multi-Raft
(`core/multiraft.py`) against live JAX runs on the CPU, each member fed
the JAX draw tape of its seed, and the batched tick against itself: one
B = 3 tick over three different clusters equals three B = 1 ticks.
The fleet's transfer count (`d2h_bytes`, through `state.pytree_nbytes`)
equals JAX's, and its rolling digests the recompute-from-scratch
`state.prefix_digest` at an epoch's end.

Integer, bool and digest results must be equal; float results (cost,
read-latency sums and what derives from them) are held to rtol=1e-6,
because XLA reorders float32 sums inside its jitted epoch.  The torch
fleet is compared with the JAX fleet, never with a solo sim for the
`lease_fixed` recipe."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import multiraft as JMR
from repro.core.fleet import FleetSim as JFleet
from repro.core.fleet import MemberSpec as JSpec
from repro.core.multiraft import MultiRaftSim as JMultiRaft
from repro_torch.core import multiraft as TMR
from repro_torch.core import state as TSM
from repro_torch.core import step as TST
from repro_torch.core.draws import TorchDraws, fleet_epoch, row
from repro_torch.core.fleet import FleetShapes
from repro_torch.core.fleet import FleetSim as TFleet
from repro_torch.core.fleet import MemberSpec as TSpec
from repro_torch.core.multiraft import MultiRaftSim as TMultiRaft

from test_torch_runtime import assert_reports_equal, assert_states_equal
from test_torch_tape import JaxTape, port_config, small_config


def _slice_specs(Spec, MR, cfg, small):
    """A small version of the slice's fleet: BW-Raft with a 6-slot
    digest rack, Raft, two grouped Multi-Raft shards at chi = 0.1, and a
    BW-Raft member of a smaller config padded to the fleet's shapes."""
    return ([Spec(cfg=cfg, mode="bwraft", write_rate=3.0, read_rate=24.0,
                  seed=0, phi=0.02, n_observers=6, staleness_bound=8,
                  ae_interval=3),
             Spec(cfg=cfg, mode="raft", write_rate=3.0, read_rate=24.0,
                  seed=1)] +
            MR.shard_specs(cfg, shards=2, write_rate=3.0, read_rate=24.0,
                           cross_shard_frac=0.1, seed=4, group_id=0) +
            [Spec(cfg=small, mode="bwraft", write_rate=2.0, read_rate=16.0,
                  seed=3)])


def _assert_digests_equal(jdg, tdg, ctx):
    assert set(jdg) == set(tdg), ctx
    for k in jdg:
        a, b = np.asarray(jdg[k]), tdg[k]
        assert a.shape == b.shape, (ctx, k)
        if a.dtype == np.float32:
            np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=f"{ctx} {k}")
        else:
            assert np.array_equal(a, b), (ctx, k)


def test_fleet_matches_jax():
    """Two managed epochs of the slice's fleet: every member's
    EpochReport, the group's MultiRaftReport, the per-member and group
    digests, and the final batched state equal the JAX fleet's."""
    jc, jsmall = small_config(), small_config("tsm", followers=(1, 1),
                                              max_log=128)
    jf = JFleet(_slice_specs(JSpec, JMR, jc, jsmall), backend="xla")
    tf = TFleet(_slice_specs(TSpec, TMR, port_config(jc),
                             port_config(jsmall)), device="cpu",
                draws=[JaxTape(s) for s in (0, 1, 4, 21, 3)])
    assert tf.shapes == FleetShapes(**vars(jf.shapes))
    for i in range(len(tf.members)):
        assert tf.pads_for(i) == jf.pads_for(i)
    for e in range(2):
        for i, (a, b) in enumerate(zip(jf.run_epoch(), tf.run_epoch())):
            assert_reports_equal(a, b, f"epoch {e} member {i}")
        assert_reports_equal(jf.group_reports[0][-1],
                             tf.group_reports[0][-1], f"group epoch {e}")
        _assert_digests_equal(jf.last_digest, tf.last_digest, f"dg {e}")
        _assert_digests_equal(jf.last_group_digest, tf.last_group_digest,
                              f"group dg {e}")
    assert_states_equal(jf.state, tf.state, "fleet")
    assert tf.reports[0][-1].n_obs_digest > 0
    assert tf.reports[0][-1].decision is not None
    assert tf.d2h_bytes == jf.d2h_bytes > 0     # both pytree_nbytes


def test_rolling_digest_equals_prefix_digest_after_an_epoch(monkeypatch):
    """The slice's fleet (its first member with the digest rack) for one
    epoch: at the epoch's end, before the compaction clears the logs,
    every alive node's rolling `applied_digest` equals the
    recompute-from-scratch `prefix_digest` of its log's applied prefix
    (DESIGN.md §13)."""
    from repro_torch.core import runtime as TRT
    seen, compact = [], TRT.compact_state
    monkeypatch.setattr(TRT, "compact_state",
                        lambda st: compact(seen.append(st) or st))
    cfg, small = small_config(), small_config("tsm", followers=(1, 1),
                                              max_log=128)
    tf = TFleet(_slice_specs(TSpec, TMR, port_config(cfg),
                             port_config(small)), device="cpu")
    tf.run_epoch()
    st = seen[-1]
    want = TSM.prefix_digest(st["log_key"], st["log_val"], st["applied_len"])
    alive = st["alive"]
    assert int((st["applied_len"][alive] > 0).sum()) > 10
    assert torch.equal(st["applied_digest"][alive], want[alive])


def test_fixed_role_single_dispatch_matches_jax():
    """The fixed-role sweep recipe: run(1), lease_fixed(2, 3), then
    run(2) on the multi-epoch path, against the JAX scan path."""
    jc = small_config()
    ax = {"seed": [0, 5], "write_rate": [3.0]}
    jf = JFleet.from_sweep(jc, ax, manage_resources=False, phi=0.02,
                           backend="xla")
    tf = TFleet.from_sweep(port_config(jc), ax, manage_resources=False,
                           phi=0.02, device="cpu",
                           draws=[JaxTape(0), JaxTape(5)])
    assert tf.single_dispatch_eligible and jf.single_dispatch_eligible
    for f in (jf, tf):
        f.run(1)
        f.lease_fixed(2, 3)
    jr, tr = jf.run(2), tf.run(2)
    for i in range(2):
        for e in range(2):
            assert_reports_equal(jr[i][e], tr[i][e], f"member {i} epoch {e}")
    _assert_digests_equal(jf.last_digest, tf.last_digest, "last digest")
    assert_states_equal(jf.state, tf.state, "fixed role")
    assert [len(r) for r in tf.reports] == [3, 3]


@pytest.mark.parametrize("engine", ["fleet", "sequential"])
def test_multiraft_sim_matches_jax(engine):
    """Two shards at chi = 0.1 over 2 epochs, both engines."""
    jc = small_config()
    kw = dict(shards=2, cross_shard_frac=0.1, write_rate=4.0, seed=2)
    jm = JMultiRaft(jc, engine=engine, backend="xla", **kw)
    tm = TMultiRaft(port_config(jc), engine=engine, device="cpu",
                    draws=[JaxTape(2), JaxTape(19)], **kw)
    for e in range(2):
        a, b = jm.run_epoch(), tm.run_epoch()
        assert_reports_equal(a, b, f"{engine} epoch {e}")
    if engine == "fleet":
        assert b.two_pc_prepares > 0 and b.metrics is not None


def test_batched_tick_has_no_coupling():
    """One B = 3 tick over three different members (three configs
    padded to one shape, one with a digest rack, a trace ring on) equals
    three B = 1 ticks, leaf for leaf, over 60 ticks.  No JAX."""
    cfgs = [port_config(small_config()),
            port_config(small_config("tb", followers=(1, 1, 1))),
            port_config(small_config("tc", followers=(1,), max_log=96))]
    specs = [TSpec(cfg=cfgs[0], seed=0, phi=0.05, prelease=(2, 3),
                   manage_resources=False),
             TSpec(cfg=cfgs[1], mode="raft", seed=1, trace_on=True,
                   warning_ticks=2, phi=0.05),
             TSpec(cfg=cfgs[2], seed=2, n_observers=5, prelease=(1, 2),
                   manage_resources=False, cross_shard_frac=0.3,
                   two_pc_ticks=4)]
    fleet = TFleet(specs, device="cpu")
    T = 60
    bundle = fleet_epoch([TorchDraws(s, "cpu") for s in (0, 1, 2)], T,
                         fleet.state, fleet._cfg_c)
    batched = fleet.state
    solo = [TSM.batch1(TSM.member(fleet.state, i)) for i in range(3)]
    statics = [TSM.stack_static([m.static], "cpu") for m in fleet.members]
    cfgs_c = [TSM.batch1(TSM.member(fleet._cfg_c, i)) for i in range(3)]
    for t in range(T):
        r = row(bundle, t)
        batched, _ = TST.tick(batched, fleet._bstatic, fleet._cfg_c, r)
        for i in range(3):
            solo[i], _ = TST.tick(solo[i], statics[i], cfgs_c[i],
                                  TSM.batch1(TSM.member(r, i)))
    for i in range(3):
        for k, v in batched.items():
            assert torch.equal(v[i], solo[i][k][0]), (i, k)
    assert int(batched["commit_len"].max()) > 0
    assert int(batched["dobs_applied"][2].max()) > 0


def test_fleet_guards_and_unported_fields():
    """The shard-group guards raise as the JAX fleet's asserts do; each
    host-service field (DESIGN.md §10-§12) is accepted, a trace market
    without a trace gets the JAX package's message, the host pipeline
    builds but refuses shard groups (JAX asserts the same), and an
    unknown pipeline is refused."""
    cfg = port_config(small_config())
    shard = TMR.shard_specs(cfg, shards=2, cross_shard_frac=0.1)
    with pytest.raises(ValueError, match="ragged-group"):
        TFleet(shard[:1], device="cpu")
    with pytest.raises(ValueError, match="mode='raft'"):
        TFleet([TSpec(cfg=cfg, group_id=0, manage_resources=False)],
               device="cpu")
    with pytest.raises(ValueError, match="period_ticks"):
        TFleet([TSpec(cfg=cfg),
                TSpec(cfg=dataclasses.replace(cfg, period_ticks=20))],
               device="cpu")
    from repro_torch import market as TM
    from repro_torch import workload as TW
    trace = TM.load("aws-us-east", ticks=60)
    services = {
        "trace": trace,
        "arrivals": TW.OpenLoop(write=TW.ConstantRate(2.0),
                                read=TW.ConstantRate(8.0), ticks=20),
        "keypop": TW.ZipfianKeys(1.1),
        "faults": TM.kill_nodes([0], 3, n_nodes=cfg.max_nodes, ticks=10),
        "bid_policy": TM.HazardAwareBid(mean_price=[0.0125, 0.0135]),
    }
    for field, obj in services.items():
        f = TFleet([TSpec(cfg=cfg, **{field: obj})], device="cpu")
        assert getattr(f.members[0].spec, field) is obj
    f = TFleet([TSpec(cfg=cfg, market="trace", trace=trace)], device="cpu")
    assert bool(f._cfg_c["market_trace"][0]) and f.trace_ticks == 60
    with pytest.raises(ValueError, match="needs a market.MarketTrace"):
        TFleet([TSpec(cfg=cfg, market="trace")], device="cpu")
    host = TFleet([TSpec(cfg=cfg)], pipeline="host", device="cpu")
    assert host.pipeline == "host" and not host.single_dispatch_eligible
    with pytest.raises(ValueError, match="shard groups need the device"):
        TFleet(shard, pipeline="host", device="cpu")
    with pytest.raises(ValueError, match="pipeline='bogus'"):
        TFleet([TSpec(cfg=cfg)], pipeline="bogus", device="cpu")
    with pytest.raises(ValueError, match="sweep axis"):
        TFleet.from_sweep(cfg, {"backend": ["xla"]}, device="cpu")
