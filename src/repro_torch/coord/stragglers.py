"""Straggler detection + elastic data-parallel reassignment (a copy of
`repro.coord.stragglers`, numpy only: the port imports nothing of the
JAX package).

Pods report per-step heartbeats (step durations).  A pod is a straggler
when its EWMA duration exceeds `threshold` x the fleet median for
`patience` consecutive steps; its batch range is reassigned (committed
through the consensus log as a STRAGGLER record + new MEMBERSHIP view) and
the data pipeline's pure `batch_at(step, shard, num_shards)` makes the
re-sharding exact — no data loss or duplication across the transition.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class PodStats:
    ewma: float = 0.0
    strikes: int = 0
    active: bool = True


class StragglerMitigator:
    def __init__(self, num_pods: int, *, threshold: float = 1.8,
                 patience: int = 3, alpha: float = 0.5):
        self.pods: List[PodStats] = [PodStats() for _ in range(num_pods)]
        self.threshold = threshold
        self.patience = patience
        self.alpha = alpha
        self.reassignments: List[int] = []

    def heartbeat(self, durations: Dict[int, float]) -> List[int]:
        """Feed per-pod step durations; returns pods newly marked out."""
        for pid, d in durations.items():
            p = self.pods[pid]
            p.ewma = d if p.ewma == 0 else \
                (1 - self.alpha) * p.ewma + self.alpha * d
        active = [p for p in self.pods if p.active and p.ewma > 0]
        if len(active) < 2:
            return []
        med = float(np.median([p.ewma for p in active]))
        newly = []
        for pid, p in enumerate(self.pods):
            if not p.active or p.ewma == 0:
                continue
            if p.ewma > self.threshold * med:
                p.strikes += 1
                if p.strikes >= self.patience:
                    p.active = False
                    newly.append(pid)
                    self.reassignments.append(pid)
            else:
                p.strikes = 0
        return newly

    def mark_failed(self, pid: int) -> None:
        self.pods[pid].active = False
        self.reassignments.append(pid)

    @property
    def active_pods(self) -> List[int]:
        return [i for i, p in enumerate(self.pods) if p.active]

    def shard_assignment(self) -> Dict[int, int]:
        """pod id -> shard index among active pods (contiguous)."""
        return {pid: i for i, pid in enumerate(self.active_pods)}

    def membership_bitmap(self) -> int:
        bm = 0
        for pid in self.active_pods:
            bm |= 1 << pid
        return bm
