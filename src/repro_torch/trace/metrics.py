"""Unified control-plane metrics registry (DESIGN.md §14), PyTorch port
of `repro.trace.metrics`.

Named counters accumulated in the `(NCOUNTER,)` int32 `metrics_ctr`
state leaf (`(B, NCOUNTER)` in the tick's batched state), reduced through the epoch digest and surfaced as
`EpochReport.metrics`.  Counters are always on (not gated by
`trace_on`) and reset at compaction.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

COUNTERS = (
    # election seam (step.election_step)
    "elections_started", "votes_granted", "leader_elected",
    "leader_stepdowns", "sec_stops",
    # commit seam (step.commit_step)
    "commit_advances", "entries_committed",
    # revocation seam (step.spot_step, §12)
    "warns_armed", "reprieves", "kills",
    # handoff seam (§6/§13)
    "sec_handoffs", "obs_drains",
    # anti-entropy seam (§13)
    "ae_rounds", "ae_fallbacks",
    # Multi-Raft 2PC seam (§9)
    "twopc_prepared", "twopc_committed",
)
NCOUNTER = len(COUNTERS)
INDEX = {name: i for i, name in enumerate(COUNTERS)}


def add_at(vec: torch.Tensor, i: int, amount: torch.Tensor) -> torch.Tensor:
    """`vec` (B, C) with the per-member (B,) `amount` added at the
    static column `i`, as a new tensor; nothing is read on or copied
    from the host."""
    out = vec.clone()
    out[:, i] += amount.to(vec.dtype)
    return out


def bump(state: Dict, name: str, amount) -> Dict:
    """Add the per-member `amount` to one named counter; a passthrough
    on minimal states without the registry leaf."""
    if "metrics_ctr" not in state:
        return state
    return dict(state, metrics_ctr=add_at(state["metrics_ctr"],
                                          INDEX[name], amount))


def as_dict(vec) -> Dict[str, int]:
    """Decode a digest's `(NCOUNTER,)` counter vector into
    `{name: int}` — the `EpochReport.metrics` payload."""
    arr = np.asarray(vec).reshape(-1)
    if arr.shape[0] != NCOUNTER:
        raise ValueError(f"expected {NCOUNTER} counters, got {arr.shape}")
    return {name: int(arr[i]) for i, name in enumerate(COUNTERS)}
