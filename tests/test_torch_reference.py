"""The frozen reference forms of the port (DESIGN.md §7.1, §12):
`tick(reference=True)`, `spot_step_reference`, `runtime.build_report`
and `FleetSim(pipeline="host")`, each against its JAX counterpart on the
CPU under the JAX draw tape, and the port's reference forms against its
own fast forms.

The reference tick equals the fast tick bit for bit; against JAX,
integer, bool and digest leaves are equal and float32 leaves within
rtol=1e-6 (XLA-jitted float order), as `test_torch_tick.py` holds the
fast tick.  Reports and decisions are held by
`test_torch_runtime.assert_reports_equal`."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import runtime as JRT
from repro.core import state as JSM
from repro.core import step as JST
from repro.core.fleet import FleetSim as JFleet
from repro.core.fleet import MemberSpec as JSpec
from repro.market import synthetic as JMS
from repro_torch.core import runtime as TRT
from repro_torch.core import state as TSM
from repro_torch.core import step as TST
from repro_torch.core.draws import TorchDraws, fleet_epoch, row
from repro_torch.core.fleet import FleetSim as TFleet
from repro_torch.core.fleet import MemberSpec as TSpec
from repro_torch.market import synthetic as TMS

from test_torch_runtime import assert_reports_equal, assert_states_equal
from test_torch_step import JaxSim, _variant
from test_torch_tape import JaxTape, port_config, small_config


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _tick_fleet():
    """Three members of three configs padded to one shape: a leased
    BW-Raft, a Raft with a warning window and the recorder on, and a
    BW-Raft with a 5-slot digest rack and cross-shard writes."""
    cfgs = [port_config(small_config()),
            port_config(small_config("tb", followers=(1, 1, 1))),
            port_config(small_config("tc", followers=(1,), max_log=96))]
    return [TSpec(cfg=cfgs[0], seed=0, phi=0.05, prelease=(2, 3),
                  manage_resources=False),
            TSpec(cfg=cfgs[1], mode="raft", seed=1, trace_on=True,
                  warning_ticks=2, phi=0.05),
            TSpec(cfg=cfgs[2], seed=2, n_observers=5, prelease=(1, 2),
                  manage_resources=False, cross_shard_frac=0.3,
                  two_pc_ticks=4, warning_ticks=3)]


def test_reference_tick_equals_fast_tick():
    """80 ticks of the reference tick equal 80 fast ticks from the
    same state and draws at B = 3, every leaf and metric bit for bit
    (every member's log fills by then, so the window-full rules run
    too).  On
    the CPU the fast tick runs the plain twins of the commit, apply,
    fan-out and anti-entropy kernels, so what differs here is the
    follower's reference form (the gather and masked scatter); the
    kernels are held against the reference tick by the JAX comparison
    below and, on the card, by `chip_smoke.py`'s phase 21(a)."""
    specs = _tick_fleet()
    fleet = TFleet(specs, device="cpu")
    T = 80
    bundle = fleet_epoch([TorchDraws(s.seed, "cpu") for s in specs], T,
                         fleet.state, fleet._cfg_c)
    fast = ref = fleet.state
    for t in range(T):
        r = row(bundle, t)
        fast, m_fast = TST.tick(fast, fleet._bstatic, fleet._cfg_c, r)
        ref, m_ref = TST.tick(ref, fleet._bstatic, fleet._cfg_c, r,
                              reference=True)
        for k in m_fast:
            assert torch.equal(m_fast[k], m_ref[k]), (t, k)
    for k in fast:
        assert torch.equal(fast[k], ref[k]), k
    assert int(fast["commit_len"].max()) == fast["log_term"].shape[2] - 1
    assert int(fast["dobs_applied"][-1].max()) > 0


def test_reference_tick_matches_jax():
    """30 reference ticks of the port under the JAX tape equal 30 JAX
    `tick(reference=True)` ticks from a leased JAX state of the trace
    market with per-node columns, a warning window and the recorder on,
    80 reference ticks into its run (a leader elected, batches in
    flight; one program compiled)."""
    cfg = small_config()
    sim = JaxSim(cfg, seed=0, backend="xla", **_variant("trace_warn", cfg))
    sim._lease(3, 4)
    jtick = jax.jit(lambda s, r: JST.tick(s, sim.static, sim.cfg_c, r,
                                          reference=True))
    rng = jax.random.PRNGKey(42)
    state = sim.state
    for _ in range(80):
        rng, sub = jax.random.split(rng)
        state, _ = jtick(state, sub)
    static_t = TSM.stack_static([sim.static], "cpu")
    cfg_t = TSM.batch1(TSM.from_numpy(_np(sim.cfg_c), "cpu"))
    tape = JaxTape(7)
    rng = jax.random.PRNGKey(7)
    st_t = TSM.from_numpy(_np(state), "cpu")
    for t in range(30):
        rng, sub = jax.random.split(rng)
        state, jm = jtick(state, sub)
        draws = tape.tick(st_t, TSM.member(cfg_t, 0))
        bt, tm = TST.tick(TSM.batch1(st_t), static_t, cfg_t,
                          TSM.batch1(row(draws, 0)), reference=True)
        st_t = TSM.member(bt, 0)
        if t % 15 == 14:
            assert_states_equal(state, st_t, f"reference tick {t}")
    for k in ("has_leader", "leader_term", "n_leaders", "killed",
              "commit_len", "read_queue", "write_queue"):
        assert int(jm[k]) == int(tm[k]), k


def _spot_case(market):
    """A JAX and a port `cfg_c` of the small cluster at phi 0.05 on the
    process market or on an exported walk of seed 4."""
    jc = small_config()
    pc = port_config(jc)
    jkw, tkw = {}, {}
    if market == "trace":
        jkw = dict(market="trace",
                   trace=JMS.export_walk_trace(jc, seed=4, epochs=2))
        tkw = dict(market="trace",
                   trace=TMS.export_walk_trace(pc, seed=4, epochs=2,
                                               draws=JaxTape(4),
                                               device="cpu"))
    j_cfg = JRT.make_cfg_arrays(jc, write_rate=8.0, read_rate=16.0,
                                phi=0.05, **jkw)
    t_cfg = TRT.make_cfg_arrays(pc, "cpu", write_rate=8.0, read_rate=16.0,
                                phi=0.05, **tkw)
    return jc, pc, j_cfg, t_cfg


@pytest.mark.parametrize("market", ["process", "trace"])
def test_spot_step_reference_matches_jax(market):
    """40 ticks of `spot_step_reference` from a leased state equal JAX's
    under the tape (prices, kills, roles), and the port's `spot_step`
    at warn_ticks = 0, no faults and the init-time bid equals the port's
    reference form bit for bit (the W = 0 gate of DESIGN.md §12)."""
    jc, pc, j_cfg, t_cfg = _spot_case(market)
    assert np.array_equal(np.asarray(j_cfg["price_trace"]),
                          t_cfg["price_trace"].numpy())
    j_static = JSM.build_static(jc)
    j_state = JSM.init_state(jc, j_static)
    ctl = JRT.ClusterController(jc, j_static, seed=0)
    wired = ctl.lease(np.asarray(j_state["role"]),
                      np.asarray(j_state["alive"]), 3, 6)
    j_state = dict(j_state, **{k: jax.numpy.asarray(v) for k, v in
                               zip(("role", "alive", "sec_of", "obs_of"),
                                   wired)})
    jstep = jax.jit(lambda s, r: JST.spot_step_reference(
        s, j_static, j_cfg, jax.random.split(r, 4)[0]))
    t_static = TSM.stack_static([TSM.build_static(pc)], "cpu")
    t_cfg_b = TSM.batch1(t_cfg)
    new = ref = TSM.batch1(TSM.from_numpy(_np(j_state), "cpu"))
    tape = JaxTape(9)
    rng = jax.random.PRNGKey(9)
    kills = 0
    for t in range(40):
        rng, sub = jax.random.split(rng)
        j_state, j_killed = jstep(dict(j_state, tick=jax.numpy.int32(t)),
                                  sub)
        tick = torch.full((1,), t, dtype=torch.int32)
        draws = TSM.batch1(row(tape.tick(TSM.member(dict(ref, tick=tick), 0),
                                         t_cfg), 0))
        ref, k_ref = TST.spot_step_reference(dict(ref, tick=tick), t_static,
                                             t_cfg_b, draws)
        new, k_new = TST.spot_step(dict(new, tick=tick), t_static, t_cfg_b,
                                   draws)
        np.testing.assert_allclose(ref["spot_price"][0].numpy(),
                                   np.asarray(j_state["spot_price"]),
                                   rtol=1e-6, err_msg=f"tick {t}")
        for name in ("alive", "role"):
            assert np.array_equal(ref[name][0].numpy(),
                                  np.asarray(j_state[name])), (t, name)
        assert np.array_equal(k_ref[0].numpy(), np.asarray(j_killed)), t
        for name, a, b in (("price", new["spot_price"], ref["spot_price"]),
                           ("killed", k_new, k_ref),
                           ("alive", new["alive"], ref["alive"]),
                           ("role", new["role"], ref["role"])):
            assert torch.equal(a, b), f"tick {t}: {name} diverged"
        kills += int(k_ref.sum())
    assert kills > 0


def _report_inputs(seed, T=12, N=7, L=40, O=3):
    """A post-epoch state and (T,) metric stacks as numpy, with the
    leader elected on the first tick (terms -1 before the epoch)."""
    rng = np.random.default_rng(seed)
    sub = np.where(rng.random(L) < 0.8, rng.integers(0, 50, L), -1)
    com = np.where((sub >= 0) & (rng.random(L) < 0.7),
                   sub + rng.integers(0, 9, L), -1)
    st = {"entry_submit_t": sub.astype(np.int32),
          "entry_commit_t": com.astype(np.int32),
          "reads_served": np.int32(rng.integers(0, 500)),
          "read_lat_hist": rng.integers(0, 9, T + 9).astype(np.int32),
          "obs_stale_hist": rng.integers(0, 3, T + 9).astype(np.int32),
          "alive": rng.random(N) < 0.8,
          "warn_timer": rng.integers(-1, 3, N).astype(np.int32),
          "obs_reads_served": np.int32(rng.integers(0, 50)),
          "obs_rerouted": np.int32(rng.integers(0, 50)),
          "dobs_alive": rng.random(O) < 0.5,
          "reads_arrived": np.int32(600), "writes_arrived": np.int32(90),
          "read_lat_sum": np.float32(rng.random() * 1e3),
          "read_lat_max": np.float32(17.0),
          "cost_accrued": np.float32(3.25 + rng.random()),
          "metrics_ctr": rng.integers(0, 9, 32).astype(np.int32)}
    term = np.repeat([3, 3, 5, 5], T // 4)
    ms = {"leader_term": term.astype(np.int32),
          "n_secretaries": rng.integers(0, 3, T).astype(np.int32),
          "n_observers": rng.integers(0, 4, T).astype(np.int32),
          "has_leader": (rng.random(T) < 0.9).astype(np.int32),
          "killed": rng.integers(0, 2, T).astype(np.int32)}
    return st, ms


@pytest.mark.parametrize("leader_term0", [None, -1, 3])
def test_build_report_matches_jax(leader_term0):
    """`build_report` equals JAX's on the same numpy inputs; with the
    pre-epoch leader term -1 the first tick's election counts as a
    leader change (DESIGN.md §14's first-tick fix)."""
    from repro.trace import metrics as JTM
    st, ms = _report_inputs(3)
    st["metrics_ctr"] = st["metrics_ctr"][:JTM.NCOUNTER]
    a = JRT.build_report(4, st, ms, 1.5, leader_term0=leader_term0)
    b = TRT.build_report(4, st, ms, 1.5, leader_term0=leader_term0)
    assert_reports_equal(a, b, f"leader_term0={leader_term0}")
    assert b.leader_changes == {None: 1, -1: 2, 3: 1}[leader_term0]


def _pipeline_specs(Spec, cfg):
    """A managed BW-Raft with a 6-slot digest rack and a warning window,
    and an unmanaged Raft."""
    return [Spec(cfg=cfg, write_rate=6.0, read_rate=24.0, phi=0.02, seed=0,
                 n_observers=6, staleness_bound=8, ae_interval=3,
                 warning_ticks=2),
            Spec(cfg=cfg, mode="raft", write_rate=12.0, read_rate=12.0,
                 seed=1, manage_resources=False)]


def test_host_pipeline_equals_device_pipeline():
    """The port's two pipelines from fresh draw sources at equal seeds:
    every report and decision equal over 2 epochs (the first epoch's
    decision leased into the second), no single dispatch
    on the host pipeline, and a device-path D2H under a hundredth of
    the host path's (DESIGN.md §7.1)."""
    cfg = port_config(small_config("digest", max_log=1024))
    specs = _pipeline_specs(TSpec, cfg)
    dev = TFleet(specs, device="cpu")
    host = TFleet.from_sweep(cfg, {"seed": [0]}, pipeline="host",
                             device="cpu")
    assert host.pipeline == "host" and not host.single_dispatch_eligible
    host = TFleet(specs, pipeline="host", device="cpu")
    d_reps, h_reps = dev.run(2), host.run(2)
    decisions = 0
    for i in range(len(specs)):
        for e, (a, b) in enumerate(zip(d_reps[i], h_reps[i])):
            assert_reports_equal(a, b, f"member {i} epoch {e}")
            decisions += a.decision is not None
    assert decisions == 2
    assert host.last_digest is None
    assert dev.d2h_bytes < host.d2h_bytes / 100, \
        (dev.d2h_bytes, host.d2h_bytes)
    with pytest.raises(ValueError, match="device pipeline"):
        host.run(2, single_dispatch=True)


def test_host_fleet_matches_jax():
    """Two managed epochs of the host pipeline under per-member tapes
    equal JAX's host pipeline: every report and decision, the d2h bytes
    of the first epoch, and the final batched state."""
    jc = small_config()
    jf = JFleet(_pipeline_specs(JSpec, jc), pipeline="host")
    tf = TFleet(_pipeline_specs(TSpec, port_config(jc)), pipeline="host",
                device="cpu", draws=[JaxTape(0), JaxTape(1)])
    for e in range(2):
        for i, (a, b) in enumerate(zip(jf.run_epoch(), tf.run_epoch())):
            assert_reports_equal(a, b, f"epoch {e} member {i}")
        if e == 0:
            assert tf.d2h_bytes == jf.d2h_bytes
    assert_states_equal(jf.state, tf.state, "host fleet")
    assert tf.reports[0][-1].decision is not None
    assert tf.reports[0][-1].n_obs_digest > 0
    assert dataclasses.asdict(tf.reports[0][0].decision) == \
        dataclasses.asdict(jf.reports[0][0].decision)
