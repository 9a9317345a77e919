"""The port's chaos harness (`repro_torch.market.chaos`), safety checkers
(`core/invariants.py`) and linearizability checker against the JAX
package's on the CPU.

`run_chaos` drives the port's tick one draw row per tick; fed the JAX
draw tape (`JaxTape.tick`, the JAX harness's per-tick key split) it must
reproduce JAX's `run_chaos` exactly: the report, every per-tick
snapshot, the flight-recorder events and the Perfetto file.  A
`BWRaftSim` carrying a fault schedule is held to the JAX sim over two
epochs (ints exact, floats rtol 1e-6)."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from repro.core import invariants as JI
from repro.core import linearizability as JL
from repro.core.runtime import BWRaftSim as JaxSim
from repro.market import chaos as JC
from repro_torch.core import invariants as TI
from repro_torch.core import linearizability as TL
from repro_torch.core.runtime import BWRaftSim as TorchSim
from repro_torch.market import chaos as TC

from test_torch_runtime import assert_reports_equal, assert_states_equal
from test_torch_tape import JaxTape, port_config, small_config

N_SMALL = small_config().max_nodes


def test_fault_builders_equal_jax():
    """The drill builders and the schedule fit rule equal JAX's."""
    built = [
        lambda C: C.kill_nodes([0, 3], 5, n_nodes=9, ticks=30, hold=4),
        lambda C: C.kill_nodes([2], 7, n_nodes=9, ticks=30,
                               warning_ticks=3),
        lambda C: C.kill_mask(np.arange(9) % 3 == 0, 2, ticks=20),
        lambda C: C.mass_kill(10, n_nodes=9, ticks=40, spare=(0, 1, 2),
                              warning_ticks=2),
        lambda C: C.warning_then_reprieve([4], 3, n_nodes=9, ticks=20,
                                          warning_ticks=5),
    ]
    for make in built:
        j, t = make(JC), make(TC)
        assert j.name == t.name and np.array_equal(j.kill, t.kill)
        assert (j.nodes, j.ticks) == (t.nodes, t.ticks)
        for shape in ((4, 10), (12, 50)):
            assert np.array_equal(j.fit_to(*shape), t.fit_to(*shape))
    with pytest.raises(AssertionError):
        TC.warning_then_reprieve([1], 3, n_nodes=9, ticks=20,
                                 warning_ticks=0)


_DRILLS = {
    "leader_kill": (lambda C: C.kill_nodes([0], 20, n_nodes=N_SMALL,
                                           ticks=60), 0),
    "mass_kill_warned": (lambda C: C.mass_kill(
        25, n_nodes=N_SMALL, ticks=60, spare=(0, 1, 2), warning_ticks=3),
        3),
    "warning_then_reprieve": (lambda C: C.warning_then_reprieve(
        [2], 20, n_nodes=N_SMALL, ticks=60, warning_ticks=5), 5),
}


@pytest.mark.parametrize("drill", sorted(_DRILLS))
def test_run_chaos_matches_jax(drill, tmp_path):
    """60 ticks of each canonical drill, market silenced, recorder on:
    the report, the per-tick snapshots, the events and the Perfetto
    file equal JAX's `run_chaos` under the tape; the safety checks pass
    and the trace-replayed leader timeline matches the probe."""
    make, w = _DRILLS[drill]
    cfg = small_config()
    kw = dict(warning_ticks=w, ticks=60, seed=0, spot_bid=10.0,
              trace_on=True, trace_capacity=256)
    j = JC.run_chaos(cfg, make(JC), trace_out=str(tmp_path / "j.json"),
                     **kw)
    t = TC.run_chaos(port_config(cfg), make(TC), device="cpu",
                     draws=JaxTape(0), trace_out=str(tmp_path / "t.json"),
                     **kw)
    dj, dt = dataclasses.asdict(j), dataclasses.asdict(t)
    for k in ("trace", "events", "perfetto_path"):
        dj.pop(k), dt.pop(k)
    assert dj == dt
    assert len(j.trace) == len(t.trace) == 60
    for i, (a, b) in enumerate(zip(j.trace, t.trace)):
        for k in a:
            assert np.array_equal(np.asarray(a[k]), b[k]), (i, k)
    assert [dataclasses.astuple(e) for e in j.events] == \
        [dataclasses.astuple(e) for e in t.events]
    assert json.loads((tmp_path / "j.json").read_text()) == \
        json.loads((tmp_path / "t.json").read_text())
    assert t.safety_error is None and t.trace_leader_match
    if drill == "leader_kill":
        assert t.first_kill_tick == 20 and t.killed_total >= 1
    if drill == "warning_then_reprieve":
        assert all(s["alive"][2] for s in t.trace)


def test_faulted_sim_matches_jax():
    """Two managed epochs with a scripted schedule (a voter and spot
    slots, landing through a 2-tick warning window): every report and
    the final state equal the JAX sim's."""
    cfg = small_config()
    kw = dict(seed=3, warning_ticks=2, fault_ticks=100)
    jsim = JaxSim(cfg, backend="xla",
                  faults=JC.kill_nodes([1, 5, 6], 60, n_nodes=N_SMALL,
                                       ticks=100, hold=5), **kw)
    tsim = TorchSim(port_config(cfg), device="cpu", draws=JaxTape(3),
                    faults=TC.kill_nodes([1, 5, 6], 60, n_nodes=N_SMALL,
                                         ticks=100, hold=5), **kw)
    for e in range(2):
        assert_reports_equal(jsim.run_epoch(), tsim.run_epoch(),
                             f"faulted epoch {e}")
    assert_states_equal(jsim.state, tsim.state, "faulted")
    assert tsim.reports[1].killed >= 1


def test_cpu_draws_equal_torch_draws():
    """`CpuDraws` (the card-vs-CPU source of `chip_smoke.py` phase 14)
    gives the bundles of `TorchDraws` on the CPU from the same seed, an
    epoch and then a tick."""
    import torch
    from repro_torch.core import state as TSM
    from repro_torch.core.draws import CpuDraws, TorchDraws
    from repro_torch.core.runtime import make_cfg_arrays
    cfg = port_config(small_config())
    st = TSM.init_state(cfg, TSM.build_static(cfg, n_obs_digest=3), "cpu")
    c = make_cfg_arrays(cfg, "cpu", write_rate=3.0, read_rate=9.0,
                        n_observers=3)
    a, b = CpuDraws(7, "cpu"), TorchDraws(7, "cpu")
    for x, y in ((a.epoch(5, st, c), b.epoch(5, st, c)),
                 (a.tick(st, c), b.tick(st, c))):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k


# --------------------------------------------------------------------- #
# invariants and linearizability
# --------------------------------------------------------------------- #
def _bad_traces():
    """Snapshot traces that break each property, built from one
    well-formed snapshot."""
    n, L = 3, 6
    base = {"role": np.array([2, 1, 1], np.int32),
            "term": np.array([1, 1, 1], np.int32),
            "alive": np.ones(n, bool),
            "log_term": np.ones((n, L), np.int32),
            "log_key": np.tile(np.arange(L, dtype=np.int32), (n, 1)),
            "log_val": np.tile(np.arange(L, dtype=np.int32), (n, 1)),
            "log_len": np.full(n, 4, np.int32),
            "commit_len": np.array([3, 2, 2], np.int32),
            "applied_len": np.array([3, 2, 2], np.int32)}
    two_leaders = dict(base, role=np.array([2, 2, 1], np.int32))
    mismatch = {k: v.copy() for k, v in base.items()}
    mismatch["log_val"][1, 1] = 99
    changed = {k: v.copy() for k, v in base.items()}
    changed["log_key"][0, 0] = 7
    return {"ok": [base, base], "election": [base, two_leaders],
            "log_matching": [mismatch], "durability": [base, changed]}


def test_invariants_equal_jax():
    """Each check passes or fails on the same traces with the same
    message as JAX's, and `snapshot` takes copies of the tensors."""
    import torch
    for name, trace in _bad_traces().items():
        msgs = []
        for I in (JI, TI):
            try:
                I.check_all(trace)
                msgs.append(None)
            except AssertionError as exc:
                msgs.append(str(exc))
        assert msgs[0] == msgs[1], name
        assert (msgs[1] is None) == (name == "ok"), name
    state = {k: torch.as_tensor(v) for k, v in _bad_traces()["ok"][0]
             .items()}
    snap = TI.snapshot(state)
    state["log_len"] += 1
    assert snap["log_len"].tolist() == [4, 4, 4]


def test_linearizability_equals_jax_on_a_sim_history():
    """The checker's verdict equals JAX's on random small histories, and
    a single-key history of a sim's committed writes plus a read of the
    final state machine is linearizable."""
    rng = np.random.default_rng(0)
    for _ in range(40):
        ops = []
        for _ in range(rng.integers(1, 7)):
            t0 = float(rng.integers(0, 20))
            ops.append((str(rng.choice(["w", "r"])), int(rng.integers(0, 2)),
                        int(rng.integers(0, 3)), t0,
                        t0 + float(rng.integers(0, 6))))
        assert JL.is_linearizable([JL.Op(*o) for o in ops]) == \
            TL.is_linearizable([TL.Op(*o) for o in ops])
    from repro_torch.core.draws import row
    from repro_torch.core.runtime import run_tick
    sim = TorchSim(port_config(small_config()), seed=5, device="cpu")
    for _ in range(150):
        run_tick(sim, row(sim.draws.tick(sim.state, sim.cfg_c), 0))
    st = {k: v.numpy() for k, v in sim.state.items()}
    lid = int(np.argmax(st["commit_len"]))
    applied = int(st["applied_len"][lid])
    assert applied > 0
    key = int(st["log_key"][lid, 0])
    sub, com = st["entry_submit_t"], st["entry_commit_t"]
    writes = [(0, int(st["log_val"][lid, i]), float(sub[i]), float(com[i]))
              for i in range(applied)
              if int(st["log_key"][lid, i]) == key and sub[i] >= 0
              and com[i] >= 0]
    t_end = float(st["tick"]) + 1.0
    reads = [(0, int(st["kv"][lid, key]), t_end)]
    hist = TL.history_from_sim_trace(writes[-8:], reads)
    assert len(hist) >= 2 and TL.is_linearizable(hist)
    assert JL.is_linearizable(JL.history_from_sim_trace(writes[-8:], reads))
