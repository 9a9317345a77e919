"""Device-resident flight recorder (DESIGN.md §14), PyTorch port of
`repro.trace`: in-tick control-plane event capture into fixed-capacity
ring buffers, a named metrics registry reduced through the epoch digest,
host-side decode with exact per-class `events_dropped`, and
Chrome/Perfetto + ASCII timeline export."""
from repro_torch.trace.ring import (CLASS_NAMES, CLS_AE, CLS_COMMIT,
                                    CLS_ELECTION, CLS_HANDOFF, CLS_SPOT,
                                    CLS_TWOPC, DEFAULT_CAPACITY,
                                    EVENT_CLASS, EVENT_NAMES, EV_2PC_COMMIT,
                                    EV_2PC_PREPARE, EV_AE_FALLBACK,
                                    EV_AE_SYNC, EV_CANDIDACY, EV_COMMIT,
                                    EV_ELECT, EV_GRANT, EV_KILL,
                                    EV_OBS_DRAIN, EV_REPRIEVE,
                                    EV_SEC_HANDOFF, EV_SEC_STOP,
                                    EV_STEPDOWN, EV_WARN, LANES, NCLASS,
                                    NEVENT, default_mask, emit, record,
                                    trace_leaves)
from repro_torch.trace.metrics import COUNTERS, NCOUNTER, as_dict, bump
from repro_torch.trace.export import (DrainCursor, TraceEvent,
                                      leader_spans, leader_timeline,
                                      to_perfetto, write_perfetto)
from repro_torch.trace.timeline import render

__all__ = [
    "CLASS_NAMES", "CLS_AE", "CLS_COMMIT", "CLS_ELECTION",
    "CLS_HANDOFF", "CLS_SPOT", "CLS_TWOPC", "DEFAULT_CAPACITY",
    "EVENT_CLASS", "EVENT_NAMES", "EV_2PC_COMMIT", "EV_2PC_PREPARE",
    "EV_AE_FALLBACK", "EV_AE_SYNC", "EV_CANDIDACY", "EV_COMMIT",
    "EV_ELECT", "EV_GRANT", "EV_KILL", "EV_OBS_DRAIN", "EV_REPRIEVE",
    "EV_SEC_HANDOFF", "EV_SEC_STOP", "EV_STEPDOWN", "EV_WARN",
    "LANES", "NCLASS", "NEVENT",
    "COUNTERS", "NCOUNTER", "DrainCursor", "TraceEvent", "as_dict",
    "bump", "default_mask", "emit", "leader_spans", "leader_timeline",
    "record", "render", "to_perfetto", "trace_leaves", "write_perfetto",
]
