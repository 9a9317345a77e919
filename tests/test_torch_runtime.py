"""The whole slice on the CPU: the PyTorch port's `BWRaftSim`, fed the
JAX draw tape, against live JAX runs of the same recipe in the same
process (the KV client is in `test_torch_kvstore.py`).

Integer, bool and digest results must be equal.  Float results (the
cost, the read-latency sum and what derives from them) may differ in the
last bits: XLA fuses and reorders float32 sums inside its jitted epoch,
which eager PyTorch does not reproduce, so they are held to rtol=1e-6."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

from repro.core.runtime import BWRaftSim as JaxSim
from repro_torch.core import state as TSM
from repro_torch.core.runtime import BWRaftSim as TorchSim

from test_torch_tape import JaxTape, port_config, small_config

FLOAT_RTOL = 1e-6      # XLA-jitted float32 order vs eager (see docstring)


def assert_reports_equal(a, b, ctx=""):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "decision":
            assert (x is None) == (y is None), ctx
            if x is not None:
                assert dataclasses.asdict(x) == dataclasses.asdict(y), ctx
            continue
        if isinstance(x, float):
            if math.isnan(x):
                assert math.isnan(y), (ctx, f.name, x, y)
            else:
                assert y == pytest.approx(x, rel=FLOAT_RTOL, abs=1e-12), \
                    (ctx, f.name, x, y)
        else:
            assert x == y, (ctx, f.name, x, y)


def assert_states_equal(jax_state, torch_state, ctx=""):
    j = {k: np.asarray(v) for k, v in jax_state.items()}
    t = TSM.to_numpy(torch_state)
    assert set(j) == set(t), set(j) ^ set(t)
    for k in j:
        assert j[k].dtype == t[k].dtype and j[k].shape == t[k].shape, \
            (ctx, k, j[k].dtype, t[k].dtype, j[k].shape, t[k].shape)
        if j[k].dtype == np.float32:
            np.testing.assert_allclose(t[k], j[k], rtol=FLOAT_RTOL,
                                       err_msg=f"{ctx}: {k}")
        else:
            assert np.array_equal(j[k], t[k]), (ctx, k)


def sim_pair(cfg, **kw):
    jsim = JaxSim(cfg, backend="xla", **kw)
    tsim = TorchSim(port_config(cfg), device="cpu",
                    draws=JaxTape(kw.get("seed", 0)), **kw)
    return jsim, tsim


@pytest.mark.parametrize("recipe", ["managed", "prelease", "traced"])
def test_sim_matches_jax(recipe):
    """3 epochs, managed (Algorithm 1 + MCSA leases every epoch), with a
    fixed (2, 3) complement, or managed with the flight recorder on and a
    warning window: every EpochReport field, the drained trace events and
    the final state agree with the live JAX run."""
    cfg = small_config()
    kw = dict(seed=0, phi=0.02)
    if recipe == "prelease":
        kw.update(manage_resources=False, prelease=(2, 3))
    if recipe == "traced":
        kw.update(trace_on=True, warning_ticks=2, trace_capacity=64)
    jsim, tsim = sim_pair(cfg, **kw)
    for e in range(3):
        assert_reports_equal(jsim.run_epoch(), tsim.run_epoch(),
                             f"{recipe} epoch {e}")
    assert_states_equal(jsim.state, tsim.state, recipe)
    assert [dataclasses.astuple(e) for e in jsim.trace_events] == \
        [dataclasses.astuple(e) for e in tsim.trace_events]
    assert jsim.events_dropped == tsim.events_dropped
    if recipe == "traced":
        assert tsim.trace_events
