"""Phase parity: each phase of the port's tick, in tick order, on states
taken from a live JAX run after a lease, with `cfg_c` built by JAX's own
`make_cfg_arrays` — the closed-loop process market, a trace market with
per-node revocation columns and a warning window (tracing on), and an
open-loop Zipf-key plan with a fault schedule and cross-shard writes.
The 300-tick trajectory is in `test_torch_tick.py`.

int32, bool and digest leaves must be bit-equal.  float32 leaves are
held to rtol=1e-6: XLA fuses and reorders float32 arithmetic inside a
jitted program (a jitted JAX price walk already differs from eager
float32 in the last bit), which eager PyTorch does not reproduce."""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest

from repro.core import step as JST
from repro.core.runtime import BWRaftSim as JaxSim
from repro.market import chaos
from repro.market.traces import MarketTrace
from repro.workload.arrivals import DiurnalRate, OpenLoop, ZipfianKeys
from repro_torch.core import state as TSM
from repro_torch.core import step as TST
from repro_torch.core.draws import row

from test_torch_runtime import assert_states_equal
from test_torch_tape import JaxTape, small_config

PHASES = ("spot", "workload", "election", "leader", "follower", "commit",
          "apply", "observer_sync", "read", "cost")


def _variant(name, cfg):
    N = cfg.max_nodes
    if name == "closed":
        return dict(phi=0.02)
    if name == "trace_warn":
        rng = np.random.default_rng(3)
        T = 2 * cfg.period_ticks
        price = (0.0125 * (1 + 0.6 * rng.standard_normal((2, T)))
                 ).astype(np.float32)
        node = rng.random((N, T)) < 0.03
        tr = MarketTrace("test-trace", price, rng.random((2, T)) < 0.05,
                         revoked_node=node)
        return dict(market="trace", trace=tr, warning_ticks=4,
                    trace_on=True, phi=0.01)
    assert name == "open_zipf_faults"
    plan = OpenLoop(write=DiurnalRate(6.0, 0.5, period_ticks=40),
                    read=DiurnalRate(20.0, 0.5, period_ticks=40), ticks=40)
    faults = chaos.kill_nodes([0, 9], 81, n_nodes=N, ticks=200, hold=3)
    return dict(arrivals=plan, keypop=ZipfianKeys(1.2), faults=faults,
                cross_shard_frac=0.2, two_pc_ticks=3, trace_on=True)


@functools.lru_cache(maxsize=None)
def jax_run(variant):
    """(sim, jitted tick, state): a JAX sim whose spot slots were leased
    by the control plane (3 secretaries, 4 observers), then run 80 ticks
    so a leader is elected and batches are in flight; cached per
    variant."""
    cfg = small_config()
    sim = JaxSim(cfg, seed=0, backend="xla", **_variant(variant, cfg))
    sim._lease(3, 4)
    tick = jax.jit(lambda s, r: JST.tick(s, sim.static, sim.cfg_c, r))
    rng = jax.random.PRNGKey(42)
    state = sim.state
    for _ in range(80):
        rng, sub = jax.random.split(rng)
        state, _ = tick(state, sub)
    return sim, tick, state


def _jax_phase_chain(static, cfg_c):
    @jax.jit
    def run(state, key):
        r_spot, r_work, r_lead, r_elec = jax.random.split(key, 4)
        out = []
        state, _ = JST.spot_step(state, static, cfg_c, r_spot)
        out.append(state)
        state, _ = JST.workload_step(state, static, cfg_c, r_work)
        out.append(state)
        state = JST.election_step(state, static, cfg_c, r_elec)
        out.append(state)
        state = JST.leader_step(state, static, cfg_c, r_lead)
        out.append(state)
        for f in (JST.follower_step, JST.commit_step, JST.apply_step,
                  JST.observer_sync_step):
            state = f(state, static, cfg_c)
            out.append(state)
        state, _ = JST.read_step(state, static, cfg_c)
        out.append(state)
        out.append(JST.cost_step(state, static, cfg_c))
        return out
    return run


def _port_phase(name, state, static, cfg_c, draws):
    if name == "spot":
        return TST.spot_step(state, static, cfg_c, draws)[0]
    if name in ("workload", "election", "leader"):
        return getattr(TST, f"{name}_step")(state, static, cfg_c, draws)
    if name == "read":
        return TST.read_step(state, static, cfg_c)[0]
    return getattr(TST, f"{name}_step")(state, static, cfg_c)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("variant",
                         ["closed", "trace_warn", "open_zipf_faults"])
def test_each_phase_matches_jax(variant):
    """Ten phases on each of 4 consecutive ticks: the port's phase,
    applied to the JAX state before it, equals the JAX state after it."""
    sim, _, state = jax_run(variant)
    chain = _jax_phase_chain(sim.static, sim.cfg_c)
    static_t = TSM.from_numpy(sim.static, "cpu")
    cfg_t = TSM.from_numpy(_np(sim.cfg_c), "cpu")
    rng = jax.random.PRNGKey(7)
    for t in range(4):
        rng, key = jax.random.split(rng)
        outs = chain(state, key)
        before = state
        st_t = TSM.from_numpy(_np(before), "cpu")
        tape = JaxTape(0)
        draws = row(tape._bundle(key[None], st_t, cfg_t,
                                 np.asarray(outs[0]["spot_price"])[None]), 0)
        for name, after in zip(PHASES, outs):
            got = _port_phase(name, TSM.from_numpy(_np(before), "cpu"),
                              static_t, cfg_t, draws)
            assert_states_equal(after, got, f"{variant} tick {t} {name}")
            before = after
        state = outs[-1]
        state = dict(state, tick=state["tick"] + 1)
