"""Elastic observer pool: serving replicas on preemptible capacity.

The serving analogue of the paper's observers: stateless replicas answer
read (inference) requests against the last *committed* checkpoint; any
number may be revoked at any time (Property 3.4 — state irrelevancy), so
requests re-route to surviving replicas/followers.  The pool scales with
Algorithm 1's observer decision.  A copy of `repro.coord.elastic` on the
port's copies of `core/manager` and `core/cluster_config`: host code,
numpy only, with the same random stream for the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core import manager as mgr
from repro_torch.core.cluster_config import ClusterConfig


@dataclasses.dataclass
class Replica:
    rid: int
    site: int
    ckpt_step: int                      # checkpoint it serves (readindex)
    alive: bool = True
    queue: int = 0


class ElasticObserverPool:
    """Routes batched requests across replicas; scales via Algorithm 1."""

    def __init__(self, cfg: ClusterConfig, *, capacity_per_replica: int = 8,
                 seed: int = 0):
        self.cfg = cfg
        self.capacity = capacity_per_replica
        self.replicas: List[Replica] = []
        self.rng = np.random.default_rng(seed)
        self._next_id = 0
        self.reads_prev = 0
        self.committed_step = -1
        self.dropped = 0
        self.served = 0
        self.rerouted = 0

    # ------------------------------------------------------------------ #
    def set_committed(self, step: int) -> None:
        self.committed_step = step

    def add_replicas(self, n: int) -> None:
        for _ in range(n):
            self.replicas.append(Replica(
                rid=self._next_id,
                site=int(self.rng.integers(0, self.cfg.num_sites)),
                ckpt_step=self.committed_step))
            self._next_id += 1

    def remove_replicas(self, n: int) -> None:
        for r in sorted((r for r in self.replicas if r.alive),
                        key=lambda r: r.queue)[:n]:
            r.alive = False

    def revoke_random(self, p: float) -> int:
        killed = 0
        for r in self.replicas:
            if r.alive and self.rng.uniform() < p:
                r.alive = False
                killed += 1
        return killed

    @property
    def alive(self) -> List[Replica]:
        # a replica can only serve if it has caught up to the committed
        # checkpoint (the readindex rule)
        return [r for r in self.replicas if r.alive]

    # ------------------------------------------------------------------ #
    def route(self, n_requests: int) -> Dict[int, int]:
        """Assign a batch of requests across fresh replicas; returns
        {rid: count}.  Requests overflowing total capacity stay queued at
        the followers (counted as rerouted)."""
        fresh = [r for r in self.alive if r.ckpt_step >= self.committed_step]
        for r in self.alive:
            if r.ckpt_step < self.committed_step:
                r.ckpt_step = self.committed_step   # catch-up next round
        if not fresh:
            self.rerouted += n_requests
            return {}
        out: Dict[int, int] = {}
        per = n_requests // len(fresh)
        rem = n_requests - per * len(fresh)
        for i, r in enumerate(fresh):
            take = per + (1 if i < rem else 0)
            cap = self.capacity * 4 - r.queue
            take2 = max(min(take, cap), 0)
            self.rerouted += take - take2
            r.queue += take2
            out[r.rid] = take2
        return out

    def serve_tick(self) -> int:
        done = 0
        for r in self.alive:
            s = min(r.queue, self.capacity)
            r.queue -= s
            done += s
        self.served += done
        return done

    # ------------------------------------------------------------------ #
    def autoscale(self, reads_now: int, writes_now: int,
                  budget: float, spot_price: float,
                  on_demand_price: float) -> mgr.PeekDecision:
        """Run the paper's Algorithm 1 on serving-load statistics."""
        stats = mgr.PeekStats(
            reads_prev=self.reads_prev, reads_now=reads_now,
            writes_now=writes_now,
            followers_per_site=[s.followers for s in self.cfg.sites],
            k_s=0, k_o=len(self.alive),
            budget=budget, spot_price=spot_price,
            on_demand_price=on_demand_price)
        dec = mgr.algorithm1(self.cfg, stats)
        if dec.dk_o > 0:
            self.add_replicas(dec.dk_o)
        elif dec.dk_o < 0:
            self.remove_replicas(-dec.dk_o)
        self.reads_prev = reads_now
        return dec
