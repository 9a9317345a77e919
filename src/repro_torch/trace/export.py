"""Host-side flight-recorder drain (DESIGN.md §14): the part of
`repro.trace.export` that `BWRaftSim` drains through, kept as a copy.

`DrainCursor` turns the three trace leaves into typed `TraceEvent`
records with exact per-class `events_dropped`: the ring cursor is
monotone, so the decodable window is `[max(seen, pos - CAP), pos)` and
anything the per-class gated-emit counters advanced beyond the decoded
events was overwritten before this drain.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.trace.ring import (CLASS_NAMES, EVENT_CLASS, EVENT_NAMES,
                                    NCLASS)


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
