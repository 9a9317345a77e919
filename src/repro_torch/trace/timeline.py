"""ASCII timeline rendering for flight-recorder events (DESIGN.md §14)
— the terminal twin of `trace.export`'s Perfetto writer, for chaos
drills and notebook-free debugging.  A copy of `repro.trace.timeline`."""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.trace.export import TraceEvent, leader_timeline
from repro_torch.trace.ring import EVENT_NAMES

_MARKS = "123456789"


def render(events: Sequence[TraceEvent], *, ticks: Optional[int] = None,
           width: int = 72) -> str:
    """One row per event code that fired plus a leader-presence row;
    columns are tick buckets, the glyph is the event count in the
    bucket (capped at 9, '#' beyond)."""
    if not events:
        return "(no events)"
    horizon = ticks or (max(e.tick for e in events) + 1)
    width = max(1, min(width, horizon))
    per = max(1, -(-horizon // width))      # ticks per column
    cols = -(-horizon // per)
    rows = {}
    for e in events:
        rows.setdefault(e.code, [0] * cols)[min(e.tick // per,
                                                cols - 1)] += 1
    label_w = max(len(EVENT_NAMES[c]) for c in rows) + 2
    lines = [f"{'tick':>{label_w}} 0{'.' * (cols - 2)}{horizon - 1}"]
    up = leader_timeline(events, horizon)
    lead = "".join(
        "#" if up[c * per:(c + 1) * per].all()
        else ("." if not up[c * per:(c + 1) * per].any() else "/")
        for c in range(cols))
    lines.append(f"{'leader':>{label_w}} {lead}")
    for code in sorted(rows):
        cells = "".join(
            "." if n == 0 else (_MARKS[n - 1] if n <= 9 else "#")
            for n in rows[code])
        lines.append(f"{EVENT_NAMES[code]:>{label_w}} {cells}")
    return "\n".join(lines)
