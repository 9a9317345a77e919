"""The port's open-loop workload (`repro_torch.workload`) against the JAX
package's on the CPU, and the host services through the sim and the
fleet: `BWRaftSim` under an open-loop plan with Zipfian keys (and
`set_arrivals` / `set_bid` mid-run), and a `FleetSim` whose members
carry traces, plans and fault schedules of different widths, each
against a live JAX run fed the same draw tapes.

Host code is equal bit for bit; in the epoch, integer, bool and digest
results are equal and floats are held to rtol=1e-6.  The torch fleet is
compared with the JAX fleet, never with a solo sim."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from benchmarks.common import system_specs as jax_system_specs
from repro import market as JM
from repro import workload as JW
from repro.core import multiraft as JMR
from repro.core.fleet import FleetSim as JFleet
from repro.core.fleet import MemberSpec as JSpec
from repro.core.runtime import BWRaftSim as JaxSim
from repro.market.chaos import kill_nodes as jkill_nodes
from repro_torch import market as TM
from repro_torch import workload as TW
from repro_torch.core import multiraft as TMR
from repro_torch.core.fleet import FleetSim as TFleet
from repro_torch.core.fleet import MemberSpec as TSpec
from repro_torch.core.fleet import system_specs as torch_system_specs
from repro_torch.core.runtime import BWRaftSim as TorchSim
from repro_torch.market.chaos import kill_nodes as tkill_nodes

from test_torch_fleet import _assert_digests_equal
from test_torch_runtime import assert_reports_equal, assert_states_equal
from test_torch_tape import JaxTape, port_config, small_config


def _plan(W, ticks, *, write=3.0, read=20.0, offset=0):
    return W.OpenLoop(
        write=W.DiurnalRate(write, amplitude=0.5, phase=0.3),
        read=W.FlashCrowd(W.DiurnalRate(read, amplitude=0.5),
                          mult=4.0, every_ticks=25, burst_ticks=5,
                          offset=offset),
        ticks=ticks)


# --------------------------------------------------------------------- #
# workload/arrivals.py
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("ticks", [1, 37, 200])
def test_arrival_providers_equal_jax(ticks):
    """Every provider, the curve validation, a plan's materialize /
    scaled / fit_to, the Zipf CDF and the host Poisson total equal the
    JAX package's bit for bit."""
    for W in (JW, TW):
        assert W.RateProcess.__name__ == "RateProcess"
    cases = [
        (JW.ConstantRate(2.5), TW.ConstantRate(2.5)),
        (JW.ConstantRate(-1.0), TW.ConstantRate(-1.0)),
        (JW.DiurnalRate(4.0, amplitude=1.5, period_ticks=13, phase=0.4),
         TW.DiurnalRate(4.0, amplitude=1.5, period_ticks=13, phase=0.4)),
        (JW.FlashCrowd(JW.DiurnalRate(3.0), mult=6.0, every_ticks=7,
                       burst_ticks=2, offset=3),
         TW.FlashCrowd(TW.DiurnalRate(3.0), mult=6.0, every_ticks=7,
                       burst_ticks=2, offset=3)),
        (np.linspace(0, 3, ticks, dtype=np.float32),
         np.linspace(0, 3, ticks, dtype=np.float32)),
    ]
    for j, t in cases:
        a = JW.materialize_curve(j, ticks)
        b = TW.materialize_curve(t, ticks)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    jp, tp = _plan(JW, ticks, offset=2), _plan(TW, ticks, offset=2)
    for a, b in zip(jp.materialize(), tp.materialize()):
        assert np.array_equal(a, b)
    for a, b in zip(jp.scaled(0.55, 0.5).materialize(),
                    tp.scaled(0.55, 0.5).materialize()):
        assert np.array_equal(a, b)
    for width in (1, ticks, 3 * ticks + 1):
        ja, tb = jp.fit_to(width), tp.fit_to(width)
        assert ja[2] == tb[2]
        assert np.array_equal(ja[0], tb[0]) and np.array_equal(ja[1], tb[1])
        assert JW.host_poisson_totals(ja[0], ja[2], 120) == \
            TW.host_poisson_totals(tb[0], tb[2], 120)
    for s, pad in ((1.1, 0), (0.7, 9)):
        assert np.array_equal(JW.ZipfianKeys(s).materialize(ticks, pad),
                              TW.ZipfianKeys(s).materialize(ticks, pad))
    with pytest.raises(AssertionError, match="non-negative"):
        TW.materialize_curve(np.full(ticks, -1.0), ticks)


# --------------------------------------------------------------------- #
# the sim
# --------------------------------------------------------------------- #
def test_open_loop_sim_matches_jax():
    """Two managed epochs under a diurnal + flash-crowd plan with Zipfian
    keys, then `set_arrivals` to a shorter plan and `set_bid`, a third
    epoch: every report and the final state equal the JAX run."""
    cfg = small_config()
    kw = dict(seed=1, phi=0.02)
    jsim = JaxSim(cfg, backend="xla", arrivals=_plan(JW, 80),
                  keypop=JW.ZipfianKeys(1.1), **kw)
    tsim = TorchSim(port_config(cfg), device="cpu", draws=JaxTape(1),
                    arrivals=_plan(TW, 80), keypop=TW.ZipfianKeys(1.1),
                    **kw)
    for e in range(2):
        assert_reports_equal(jsim.run_epoch(), tsim.run_epoch(),
                             f"open loop epoch {e}")
    curve = tsim.cfg_c["write_curve"]
    jsim.set_arrivals(_plan(JW, 30, write=5.0))
    tsim.set_arrivals(_plan(TW, 30, write=5.0))
    jsim.set_bid([0.013, 0.011])
    tsim.set_bid([0.013, 0.011])
    assert tsim.cfg_c["write_curve"] is curve, "the leaf was reallocated"
    assert_reports_equal(jsim.run_epoch(), tsim.run_epoch(), "swapped")
    assert_states_equal(jsim.state, tsim.state, "open loop")
    for k in ("write_curve", "read_curve", "arrival_len", "spot_bid",
              "key_cdf", "open_loop", "key_zipf"):
        assert np.array_equal(np.asarray(jsim.cfg_c[k]),
                              tsim.cfg_c[k].numpy()), k


# --------------------------------------------------------------------- #
# the fleet
# --------------------------------------------------------------------- #
def _mixed_specs(W, M, Spec, MR, system_specs, kill_nodes, cfg):
    """A comparison point under one open-loop plan with Zipfian keys,
    the BW-Raft member on the AWS trace with a hazard-aware bid policy
    (system_specs: BW-Raft, Raft, two grouped shards), plus members of
    other widths: per-node Google evictions (60 ticks), a 30-tick plan,
    and a fault schedule (80 ticks) under a 2-tick warning window."""
    aws = M.load("aws-us-east", ticks=100)
    mean = aws.fit_to(cfg.num_sites, 100).price.mean(axis=1)
    specs = system_specs(
        cfg, write_rate=3.0, read_rate=20.0, seed=0, shards=2,
        group_id=0, market="trace", trace=aws,
        arrivals=_plan(W, 100), keypop=W.ZipfianKeys(1.1),
        bid_policy=M.HazardAwareBid(mean_price=mean, window_ticks=50),
        bid_on_trace=True)
    specs += [
        Spec(cfg=cfg, write_rate=2.0, read_rate=12.0, seed=5,
             market="trace",
             trace=M.load("google-evict", ticks=60, node_rows=6)),
        Spec(cfg=cfg, mode="raft", write_rate=2.0, read_rate=12.0, seed=6,
             arrivals=_plan(W, 30, offset=4)),
        Spec(cfg=cfg, write_rate=2.0, read_rate=12.0, seed=7,
             warning_ticks=2,
             faults=kill_nodes([0, 4], 12, n_nodes=cfg.max_nodes,
                               ticks=80, hold=4)),
    ]
    return specs


def test_mixed_width_fleet_matches_jax():
    """Two epochs of a fleet whose members carry traces, plans and fault
    schedules of different widths and a per-epoch bid policy: every
    member's report, the group report, the digests, the bids and the
    final batched state equal the JAX fleet's, member for member."""
    jc = small_config()
    pc = port_config(jc)
    jf = JFleet(_mixed_specs(JW, JM, JSpec, JMR, jax_system_specs,
                             jkill_nodes, jc), backend="xla")
    tf = TFleet(_mixed_specs(TW, TM, TSpec, TMR, torch_system_specs,
                             tkill_nodes, pc), device="cpu",
                draws=[JaxTape(s) for s in (0, 0, 0, 17, 5, 6, 7)])
    assert (tf.trace_ticks, tf.arrival_ticks, tf.fault_ticks) == \
        (jf.trace_ticks, jf.arrival_ticks, jf.fault_ticks) == (100, 100, 80)
    assert not tf.single_dispatch_eligible
    for e in range(2):
        for i, (a, b) in enumerate(zip(jf.run_epoch(), tf.run_epoch())):
            assert_reports_equal(a, b, f"epoch {e} member {i}")
        assert_reports_equal(jf.group_reports[0][-1],
                             tf.group_reports[0][-1], f"group epoch {e}")
        _assert_digests_equal(jf.last_digest, tf.last_digest, f"dg {e}")
        assert np.array_equal(np.asarray(jf._cfg_c["spot_bid"]),
                              tf._cfg_c["spot_bid"].numpy()), e
    assert_states_equal(jf.state, tf.state, "mixed fleet")
    assert sum(r.killed for r in tf.reports[6]) > 0


def test_system_specs_match_the_benchmarks():
    """The port's `system_specs` builds the members the benchmarks'
    `system_specs` builds, field for field, with the host-service
    objects carried to the same members."""
    jc = small_config()
    pc = port_config(jc)
    j = _mixed_specs(JW, JM, JSpec, JMR, jax_system_specs, jkill_nodes,
                     jc)[:4]
    t = _mixed_specs(TW, TM, TSpec, TMR, torch_system_specs, tkill_nodes,
                     pc)[:4]
    objects = ("cfg", "trace", "arrivals", "keypop", "bid_policy", "faults")
    for a, b in zip(j, t):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        for k in objects:
            da.pop(k), db.pop(k)
        assert da == db
        for k in objects[1:]:
            assert (getattr(a, k) is None) == (getattr(b, k) is None), k
        if a.arrivals is not None:
            for x, y in zip(a.arrivals.materialize(),
                            b.arrivals.materialize()):
                assert np.array_equal(x, y)
