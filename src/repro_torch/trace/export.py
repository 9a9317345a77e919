"""Host-side flight-recorder drain + Chrome/Perfetto export
(DESIGN.md §14), a copy of `repro.trace.export`.

`DrainCursor` turns the three trace leaves into typed `TraceEvent`
records with exact per-class `events_dropped`: the ring cursor is
monotone, so the decodable window is `[max(seen, pos - CAP), pos)` and
anything the per-class gated-emit counters advanced beyond the decoded
events was overwritten before this drain.

`write_perfetto` emits Chrome trace-event JSON (`chrome://tracing`,
https://ui.perfetto.dev): fleet member = process, node = thread, one
extra thread per site for anti-entropy rounds, and a synthetic
"leader" thread of complete (`"X"`) tenure spans — leaderless windows
are the GAPS on that track, which `market/chaos.py` pins against
`ChaosReport.max_leaderless_span`.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.trace.ring import (CLASS_NAMES, EVENT_CLASS, EVENT_NAMES,
                                    EV_AE_FALLBACK, EV_AE_SYNC, EV_ELECT,
                                    EV_KILL, EV_STEPDOWN, NCLASS)

TICK_US = 10_000.0            # 1 tick = 10 ms, the repo-wide clock


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One decoded ring slot (see `trace.ring` lane layout)."""
    code: int
    tick: int
    node: int
    term: int
    aux: int
    member: int = 0

    @property
    def name(self) -> str:
        return EVENT_NAMES[self.code]

    @property
    def cls(self) -> int:
        return int(EVENT_CLASS[self.code])


class DrainCursor:
    """Incremental ring reader for one cluster: `drain(state)` returns
    the events appended since the previous drain, in emission order, and
    accumulates exact per-class overwrite counts in `dropped`."""

    def __init__(self, member: int = 0):
        self.member = member
        self.pos = 0
        self.emit_seen = np.zeros(NCLASS, np.int64)
        self.dropped = np.zeros(NCLASS, np.int64)

    def drain(self, state: Dict) -> List[TraceEvent]:
        ev = _np(state["trace_ev"])
        pos = int(_np(state["trace_pos"]))
        emit = _np(state["trace_emit"]).astype(np.int64)
        cap = ev.shape[0]
        start = max(self.pos, pos - cap)
        events = [TraceEvent(int(ev[i % cap, 0]), int(ev[i % cap, 1]),
                             int(ev[i % cap, 2]), int(ev[i % cap, 3]),
                             int(ev[i % cap, 4]), self.member)
                  for i in range(start, pos)]
        decoded = np.zeros(NCLASS, np.int64)
        for e in events:
            decoded[e.cls] += 1
        self.dropped += (emit - self.emit_seen) - decoded
        self.pos, self.emit_seen = pos, emit
        return events

    def dropped_by_class(self) -> Dict[str, int]:
        return {name: int(self.dropped[i])
                for i, name in enumerate(CLASS_NAMES)}


def leader_timeline(events: Sequence[TraceEvent],
                    ticks: int) -> np.ndarray:
    """Replay the event stream (in ring order — in-tick ordering is the
    emission order inside `step.tick`) into a per-tick `(ticks,)` bool
    leader-present vector, the trace-side twin of the chaos harness's
    per-tick `has_leader` probe."""
    up = np.zeros(ticks, bool)
    leader = -1
    # events are already tick-ordered by construction; walk tick by tick
    evs = list(events)
    j = 0
    for t in range(ticks):
        while j < len(evs) and evs[j].tick <= t:
            e = evs[j]
            if e.code == EV_ELECT:
                leader = e.node
            elif e.code in (EV_STEPDOWN, EV_KILL) and e.node == leader:
                leader = -1
            j += 1
        up[t] = leader >= 0
    return up


def leader_spans(events: Sequence[TraceEvent],
                 ticks: int) -> List[Dict]:
    """Leader tenure spans `{node, start, end}` (end exclusive) derived
    from elect/stepdown/kill events — the "leader" Perfetto track."""
    spans: List[Dict] = []
    leader, start = -1, 0
    for e in events:
        if e.code == EV_ELECT:
            if leader >= 0 and e.tick > start:
                spans.append({"node": leader, "start": start,
                              "end": e.tick})
            leader, start = e.node, e.tick
        elif e.code in (EV_STEPDOWN, EV_KILL) and e.node == leader:
            if e.tick + 1 > start:
                spans.append({"node": leader, "start": start,
                              "end": e.tick + 1})
            leader = -1
    if leader >= 0 and ticks > start:
        spans.append({"node": leader, "start": start, "end": ticks})
    return spans


_LEADER_TID = 9_999
_SITE_TID0 = 100_000


def to_perfetto(events: Sequence[TraceEvent], *, ticks: int = 0,
                sites: Optional[Dict[int, Sequence[int]]] = None,
                obs_site: Optional[Dict[int, Sequence[int]]] = None,
                annotations: Optional[Sequence[Dict]] = None) -> Dict:
    """Build the Chrome trace-event JSON dict (DESIGN.md §14 track
    mapping): pid = fleet member, tid = node (election/commit/spot/
    handoff/2PC instants), tid = site track for anti-entropy rounds
    (via `obs_site[member][slot]`, the static `dobs_site` wiring), and
    a per-member "leader" thread of `"X"` tenure spans whose gaps are
    the leaderless windows.  `annotations` (from
    `kvstore/service.py`) land on a "client" thread as spans."""
    tev: List[Dict] = []
    members = sorted({e.member for e in events}) or [0]
    horizon = max([ticks] + [e.tick + 1 for e in events])
    for m in members:
        tev.append({"ph": "M", "pid": m, "name": "process_name",
                    "args": {"name": f"member {m}"}})
        tev.append({"ph": "M", "pid": m, "tid": _LEADER_TID,
                    "name": "thread_name", "args": {"name": "leader"}})
        mev = [e for e in events if e.member == m]
        for span in leader_spans(mev, horizon):
            tev.append({
                "ph": "X", "pid": m, "tid": _LEADER_TID,
                "name": f"leader n{span['node']}",
                "ts": span["start"] * TICK_US,
                "dur": (span["end"] - span["start"]) * TICK_US})
        named_nodes, named_sites = set(), set()
        for e in mev:
            if e.code in (EV_AE_SYNC, EV_AE_FALLBACK):
                site = -1
                if obs_site and m in obs_site \
                        and e.node < len(obs_site[m]):
                    site = int(obs_site[m][e.node])
                tid = _SITE_TID0 + (site if site >= 0 else e.node)
                if tid not in named_sites:
                    named_sites.add(tid)
                    label = (f"site {site} ae" if site >= 0
                             else f"obs {e.node} ae")
                    tev.append({"ph": "M", "pid": m, "tid": tid,
                                "name": "thread_name",
                                "args": {"name": label}})
            else:
                tid = e.node
                if tid not in named_nodes:
                    named_nodes.add(tid)
                    label = f"node {e.node}"
                    if sites and m in sites and e.node < len(sites[m]):
                        label += f" @ site {int(sites[m][e.node])}"
                    tev.append({"ph": "M", "pid": m, "tid": tid,
                                "name": "thread_name",
                                "args": {"name": label}})
            tev.append({"ph": "i", "pid": m, "tid": tid, "s": "t",
                        "name": e.name, "ts": e.tick * TICK_US,
                        "args": {"term": e.term, "aux": e.aux}})
    for a in annotations or ():
        m = int(a.get("member", 0))
        tev.append({"ph": "X", "pid": m, "tid": _SITE_TID0 - 1,
                    "name": a.get("name", "read_index"),
                    "ts": float(a["start_tick"]) * TICK_US,
                    "dur": max(float(a.get("end_tick", a["start_tick"]))
                               - float(a["start_tick"]), 0.5) * TICK_US,
                    "args": {k: v for k, v in a.items()
                             if k not in ("name", "start_tick",
                                          "end_tick", "member")}})
        tev.append({"ph": "M", "pid": m, "tid": _SITE_TID0 - 1,
                    "name": "thread_name", "args": {"name": "client"}})
    return {"traceEvents": tev, "displayTimeUnit": "ms"}


def write_perfetto(events: Sequence[TraceEvent], path: str, **kw) -> Dict:
    """`to_perfetto` + JSON dump; returns the trace dict."""
    trace = to_perfetto(events, **kw)
    with open(path, "w") as f:
        json.dump(trace, f)
        f.write("\n")
    return trace
