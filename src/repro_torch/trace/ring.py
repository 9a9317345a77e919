"""Device-resident flight-recorder ring (DESIGN.md §14), PyTorch port of
`repro.trace.ring`.

Control-plane events are appended inside the tick into one
fixed-capacity `(CAP, LANES)` int32 ring per member whose lanes are
`(code, tick, node, term, aux)`, plus a monotone int32 write cursor and
a per-class gated-emit counter.  The tick's state carries a leading
member axis B, so the leaves are `(B, CAP, LANES)`, `(B,)` and
`(B, NCLASS)` there, and every member records into its own ring.  Capture is gated by `trace_on` and the
per-class `trace_mask` in `cfg_c` — tensors, so the gate is computed on
the device and the tick never reads it on the host.  With the gate down
nothing is written and the cursor adds zero.

Overflow: the cursor always advances by the number of gated events, but
only the newest `CAP` of one batch land (`rank + CAP > total`), which
keeps the scatter indices unique and matches what a wrapping ring keeps.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.trace import metrics as _metrics

# event classes (mask lanes) — `cfg_c["trace_mask"]` is (NCLASS,) bool
CLS_ELECTION, CLS_COMMIT, CLS_SPOT, CLS_HANDOFF, CLS_AE, CLS_TWOPC = \
    range(6)
NCLASS = 6
CLASS_NAMES = ("election", "commit", "spot", "handoff", "ae", "twopc")

# event codes (the ring's `code` lane)
EV_CANDIDACY = 0
EV_GRANT = 1
EV_ELECT = 2
EV_STEPDOWN = 3
EV_SEC_STOP = 4
EV_COMMIT = 5
EV_WARN = 6
EV_KILL = 7
EV_REPRIEVE = 8
EV_SEC_HANDOFF = 9
EV_OBS_DRAIN = 10
EV_AE_SYNC = 11
EV_AE_FALLBACK = 12
EV_2PC_PREPARE = 13
EV_2PC_COMMIT = 14
NEVENT = 15

EVENT_NAMES = (
    "candidacy", "grant", "elect", "stepdown", "sec_stop", "commit",
    "warn", "kill", "reprieve", "sec_handoff", "obs_drain", "ae_sync",
    "ae_fallback", "2pc_prepare", "2pc_commit")

EVENT_CLASS = np.array([
    CLS_ELECTION, CLS_ELECTION, CLS_ELECTION, CLS_ELECTION, CLS_ELECTION,
    CLS_COMMIT,
    CLS_SPOT, CLS_SPOT, CLS_SPOT,
    CLS_HANDOFF, CLS_HANDOFF,
    CLS_AE, CLS_AE,
    CLS_TWOPC, CLS_TWOPC], np.int32)

LANES = 5                     # (code, tick, node, term, aux)
DEFAULT_CAPACITY = 128


def trace_leaves(capacity: int, device) -> Dict[str, torch.Tensor]:
    """Fresh flight-recorder leaves for `state.init_state`: the ring,
    its monotone cursor, the per-class gated-emit counters and the
    metrics registry."""
    z = lambda *sh: torch.zeros(sh, dtype=torch.int32, device=device)
    return {
        "trace_ev": z(int(capacity), LANES),
        "trace_pos": z(),
        "trace_emit": z(NCLASS),
        "metrics_ctr": z(_metrics.NCOUNTER),
    }


def _lane(x, shape, device) -> torch.Tensor:
    """One (B, n) int32 lane from a python int (filled on the device: no
    host-to-device copy, which would wait for the stream), a per-member
    (B,) tensor, or a (B, n) / (1, n) tensor."""
    if isinstance(x, int):
        return torch.full(shape, x, dtype=torch.int32, device=device)
    x = x.to(torch.int32)
    if x.dim() == 1:
        x = x[:, None]
    return torch.broadcast_to(x, shape)


def _per_member(valid) -> torch.Tensor:
    """`valid` as (B, n): a (B,) mask is one lane per member."""
    return valid[:, None] if valid.dim() == 1 else valid


def emit(state: Dict, cfg_c: Dict, code: int, *, valid, node,
         term=0, aux=0) -> Dict:
    """Append up to `valid.sum(-1)` events of one code into each
    member's ring.

    `valid` is a bool tensor, (B,) or (B, n); `node`/`term`/`aux`
    broadcast against it: python ints, per-member (B,) tensors, or
    (B, n) / (1, n) tensors.  States without trace leaves pass through
    untouched."""
    if "trace_ev" not in state:
        return state
    ring = state["trace_ev"]
    dev = ring.device
    B, cap = ring.shape[0], ring.shape[1]
    cls = int(EVENT_CLASS[code])
    gate = cfg_c["trace_on"] & cfg_c["trace_mask"][:, cls]
    valid = _per_member(valid)
    shape = (B, valid.shape[1])
    v = valid & gate[:, None]
    vi = v.to(torch.int32)
    total = vi.sum(1, dtype=torch.int32)
    rank = torch.cumsum(vi, 1, dtype=torch.int32)
    keep = v & (rank + cap > total[:, None])
    slot = torch.where(keep, (state["trace_pos"][:, None] + rank - 1) % cap,
                       cap)
    row = torch.stack([
        _lane(code, shape, dev),
        _lane(state["tick"], shape, dev),
        _lane(node, shape, dev),
        _lane(term, shape, dev),
        _lane(aux, shape, dev)], dim=2)
    # one spare row per member takes every dropped lane; kept slots are
    # unique within a member
    ext = torch.cat([ring, ring.new_zeros((B, 1, LANES))], dim=1)
    base = torch.arange(B, device=dev)[:, None] * (cap + 1)
    ext.view(-1, LANES).index_put_(((base + slot).reshape(-1),),
                                   row.reshape(-1, LANES))
    return dict(state, trace_ev=ext[:, :cap],
                trace_pos=state["trace_pos"] + total,
                trace_emit=_metrics.add_at(state["trace_emit"], cls, total))


def record(state: Dict, cfg_c: Dict, code: int, *, valid, node,
           term=0, aux=0, counter: Optional[str] = None,
           count=None) -> Dict:
    """`emit` + metrics bump in one call: each member's counter (always
    on) adds `count` when given, else its number of valid lanes."""
    state = emit(state, cfg_c, code, valid=valid, node=node, term=term,
                 aux=aux)
    if counter is not None and "metrics_ctr" in state:
        amt = (_per_member(valid).sum(1, dtype=torch.int32)
               if count is None else count)
        state = _metrics.bump(state, counter, amt)
    return state


def default_mask(**overrides: bool) -> Tuple[bool, ...]:
    """The (NCLASS,) capture mask: all classes on, with keyword
    overrides by class name (`ae=False`, ...)."""
    mask = [True] * NCLASS
    for name, on in overrides.items():
        mask[CLASS_NAMES.index(name)] = bool(on)
    return tuple(mask)
