"""The port's flight-recorder export (`trace/export.py`: the leader
timeline and spans, the Perfetto dict and file; `trace/timeline.py`:
the ASCII render) against the JAX package's on the CPU, over the events
of a traced sim run by both (the port fed the JAX draw tape).  For the
same events every output must be equal."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from repro import trace as JT
from repro.core.runtime import BWRaftSim as JaxSim
from repro_torch import trace as TT
from repro_torch.core.runtime import BWRaftSim as TorchSim

from test_torch_tape import JaxTape, port_config, small_config


@pytest.fixture(scope="module")
def runs():
    """Two traced epochs of a managed sim with a digest rack, i.i.d.
    kills and a warning window, on both packages."""
    cfg = small_config()
    kw = dict(seed=4, phi=0.05, warning_ticks=2, trace_on=True,
              trace_capacity=512, n_observers=4, ae_interval=3)
    jsim = JaxSim(cfg, backend="xla", **kw)
    tsim = TorchSim(port_config(cfg), device="cpu", draws=JaxTape(4), **kw)
    jsim.run(2)
    tsim.run(2)
    return jsim, tsim


def _as_member(events, m):
    return [dataclasses.replace(e, member=m) for e in events]


def test_events_and_leader_timeline_equal_jax(runs):
    jsim, tsim = runs
    je, te = jsim.trace_events, tsim.trace_events
    assert [dataclasses.astuple(e) for e in je] == \
        [dataclasses.astuple(e) for e in te]
    assert {e.code for e in te} >= {JT.EV_ELECT, JT.EV_KILL}
    for ticks in (1, 37, 100, 150):
        assert np.array_equal(JT.leader_timeline(je, ticks),
                              TT.leader_timeline(te, ticks))
        assert JT.leader_spans(je, ticks) == TT.leader_spans(te, ticks)
    assert TT.leader_timeline(te, 100).any()


@pytest.mark.parametrize("width", [1, 40, 72, 200])
def test_render_equals_jax(runs, width):
    jsim, tsim = runs
    for ticks in (None, 100):
        assert JT.render(jsim.trace_events, ticks=ticks, width=width) == \
            TT.render(tsim.trace_events, ticks=ticks, width=width)
    assert TT.render([]) == JT.render([]) == "(no events)"


def test_perfetto_equals_jax(runs, tmp_path):
    """Two members (the run's events as member 0 and 2), the site and
    observer-site maps and client annotations: the Perfetto dict and the
    written file equal JAX's."""
    jsim, tsim = runs
    je = jsim.trace_events + _as_member(jsim.trace_events, 2)
    te = tsim.trace_events + _as_member(tsim.trace_events, 2)
    sites = {0: np.asarray(jsim.static["site"]),
             2: np.asarray(jsim.static["site"])[:5]}
    obs = {0: np.asarray(jsim.static["dobs_site"])}
    notes = [{"name": "read_index", "start_tick": 3, "end_tick": 9,
              "member": 2, "key": "k"}, {"start_tick": 40}]
    kw = dict(ticks=120, sites=sites, obs_site=obs, annotations=notes)
    assert JT.to_perfetto(je, **kw) == TT.to_perfetto(te, **kw)
    assert JT.to_perfetto([]) == TT.to_perfetto([])
    JT.write_perfetto(je, str(tmp_path / "j.json"), **kw)
    out = TT.write_perfetto(te, str(tmp_path / "t.json"), **kw)
    assert (tmp_path / "j.json").read_text() == \
        (tmp_path / "t.json").read_text()
    assert json.loads((tmp_path / "t.json").read_text()) == out
