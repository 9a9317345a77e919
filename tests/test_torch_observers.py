"""The digest tier (DESIGN.md §13) of the port against live JAX runs on
the CPU: `BWRaftSim(n_observers > 0)` — the O > 0 branches of the spot,
workload, read and cost phases and the anti-entropy round on the
`ae_sync` op — fed the JAX draw tape, and the KV client's bounded-
staleness `get_stale`.  Integer, bool and uint32 digest leaves must be
equal, float leaves within rtol=1e-6 (XLA's jitted float32 order)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.kvstore.service import BWKVService as JaxKV
from repro_torch.kvstore.service import BWKVService as TorchKV

from test_torch_runtime import (assert_reports_equal, assert_states_equal,
                                sim_pair)
from test_torch_tape import small_config


@pytest.mark.parametrize("recipe", ["managed_warned", "fixed_padded"])
def test_digest_tier_matches_jax(recipe):
    """Three epochs with an 8-slot digest rack: every EpochReport field
    (the obs_* census included) and the final state (every dobs_* leaf
    included) equal the JAX run's.  `managed_warned` leases every epoch
    under kills, a warning window and a tight staleness bound;
    `fixed_padded` pads the rack, shifts the sync phases and traces the
    anti-entropy events."""
    cfg = small_config()
    if recipe == "managed_warned":
        kw = dict(seed=0, phi=0.03, n_observers=8, staleness_bound=6,
                  ae_interval=3, warning_ticks=2)
    else:
        kw = dict(seed=3, phi=0.01, manage_resources=False,
                  prelease=(2, 2), n_observers=8, pad_observers=3,
                  ae_interval=5, ae_phase=np.arange(11) * 2 % 5,
                  staleness_bound=10, trace_on=True, trace_capacity=256)
    jsim, tsim = sim_pair(cfg, **kw)
    for e in range(3):
        a, b = jsim.run_epoch(), tsim.run_epoch()
        assert_reports_equal(a, b, f"{recipe} epoch {e}")
    assert b.obs_reads_served > 0 and b.n_obs_digest > 0
    assert b.metrics["ae_rounds"] > 0
    assert_states_equal(jsim.state, tsim.state, recipe)
    assert [dataclasses.astuple(e) for e in jsim.trace_events] == \
        [dataclasses.astuple(e) for e in tsim.trace_events]


def test_get_stale_matches_jax():
    """The bounded-staleness client read: after an election, a lease
    and some puts, `get_stale` serves from the freshest in-bound digest
    observer by prefix replay, honours the session floor, and reroutes
    to the fenced `get` when the tier cannot serve — with the same
    values, revisions, latencies and annotations as the JAX client."""
    cfg = small_config("tstale", followers=(2, 2, 1))
    jsim, tsim = sim_pair(cfg, write_rate=2.0, read_rate=8.0, seed=1,
                          n_observers=6, staleness_bound=12, ae_interval=2)
    jkv, tkv = JaxKV(jsim), TorchKV(tsim)

    def script(kv, sim):
        kv._step(60)
        sim._lease(2, 2)
        out = [kv.put("k/a", 11), kv.put("k/b", 22)]
        kv._step(6)
        out += [kv.get_stale("k/a"), kv.get_stale("k/b"),
                kv.get_stale("k/never")]
        out += [kv.put("k/a", 33), kv.get_stale("k/a")]
        kv._step(30)
        out += [kv.get_stale("k/a"), kv.get("k/b")]
        return out, list(kv.read_latencies), kv.session_floor

    flat = lambda xs: [dataclasses.astuple(x) if dataclasses.is_dataclass(x)
                       else x for x in xs]
    jout, tout = script(jkv, jsim), script(tkv, tsim)
    assert flat(jout[0]) == flat(tout[0])
    assert jout[1:] == tout[1:]
    assert jkv.annotations == tkv.annotations
    assert any(a["name"].startswith("read.stale") for a in tkv.annotations)
    # a served stale read never goes below the session's acked writes
    assert tout[0][2][1] >= tout[0][1].revision + 1
    assert_states_equal(jsim.state, tsim.state, "get_stale")
