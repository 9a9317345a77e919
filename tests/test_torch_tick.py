"""The port's whole `tick` against JAX's over a 300-tick trajectory,
given the JAX draw tape, from a leased mid-run JAX state (the closed-loop
process market, and a trace market with per-node columns, a warning
window and tracing on).  int32, bool and digest leaves bit-equal, float32
leaves to rtol=1e-6 (XLA-jitted float order; see `test_torch_step.py`)."""
from __future__ import annotations

import jax
import numpy as np
import pytest

from repro_torch.core import state as TSM
from repro_torch.core import step as TST
from repro_torch.core.draws import row

from test_torch_runtime import assert_states_equal
from test_torch_step import jax_run
from test_torch_tape import JaxTape


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("variant", ["closed", "trace_warn"])
def test_tick_trajectory_matches_jax(variant):
    """300 ticks of the port's `tick` under the JAX tape equal 300 JAX
    ticks from the same leased state (the 256-entry log fills on the
    way, so the window-full accept rule is exercised too)."""
    sim, tick, state = jax_run(variant)
    static_t = TSM.stack_static([sim.static], "cpu")
    cfg_t = TSM.from_numpy(_np(sim.cfg_c), "cpu")
    tape = JaxTape(99)
    rng = jax.random.PRNGKey(99)
    st_t = TSM.from_numpy(_np(state), "cpu")
    for t in range(300):
        rng, sub = jax.random.split(rng)
        state, jm = tick(state, sub)
        bt, tm = TST.tick(TSM.batch1(st_t), static_t, TSM.batch1(cfg_t),
                          TSM.batch1(row(tape.tick(st_t, cfg_t), 0)))
        st_t = TSM.member(bt, 0)
        if t % 50 == 49:
            assert_states_equal(state, st_t, f"{variant} tick {t}")
    for k in ("has_leader", "leader_term", "n_leaders", "killed",
              "commit_len", "read_queue", "write_queue"):
        assert int(jm[k]) == int(tm[k]), k
    assert int(np.asarray(state["log_len"]).max()) == \
        int(np.asarray(sim.state["log_term"]).shape[1])   # the log filled
