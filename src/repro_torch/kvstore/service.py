"""BW-KV: the paper's key-value client over the port's consensus core
(PyTorch port of `repro.kvstore.service`, DESIGN.md §6.4, §11).

Listing 1's client surface:
    revision_id <- put(key, value)
    (value, revision_id) <- get(key)
    (value, revision_id) <- get_stale(key)     # the digest tier

String keys hash into the bounded integer key space.  `put` appends at
the leader and returns once the entry commits; `get` runs an explicit
read-index round: fence on the leader's commit index (floored at the
session's floor), pick a caught-up replica (observer preferred), wait
until its apply index reaches the fence, then read.  The service steps
the cluster one tick at a time, each tick with a one-tick draw bundle
from the simulator's draw source, and reads the state on the host
between ticks — it is the interactive client, not the throughput path.
`get_stale` is the digest tier's bounded-staleness read (DESIGN.md §13).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import state as SM
from repro_torch.core.draws import row
from repro_torch.core.runtime import BWRaftSim, run_tick


class NotLeader(Exception):
    pass


class Timeout(Exception):
    pass


@dataclasses.dataclass
class PutResult:
    revision: int
    latency_ticks: int


class BWKVService:
    """Synchronous client over an in-process BW-Raft cluster."""

    def __init__(self, sim: BWRaftSim, *, timeout_ticks: int = 400):
        self.sim = sim
        self.timeout = timeout_ticks
        # per-request read latencies (ticks), in completion order
        self.read_latencies: list = []
        # one span dict per completed put / read-index round
        self.annotations: list = []
        # the highest log length acked (writes) or served (reads) to this
        # session; a read fences at max(leader commit, floor)
        self.session_floor: int = 0

    def _key_id(self, key: str) -> int:
        K = self.sim.cfg.key_space
        return int(hashlib.sha1(key.encode()).hexdigest(), 16) % K

    def _leader(self) -> int:
        return int(SM.leader_id(self.sim.state))

    def _tick_now(self) -> int:
        return int(self.sim.state["tick"])

    def _step(self, n: int = 1) -> None:
        sim = self.sim
        for _ in range(n):
            run_tick(sim, row(sim.draws.tick(sim.state, sim.cfg_c), 0))

    def put(self, key: str, value: int) -> PutResult:
        """Submit a write through the leader; block until committed."""
        kid = self._key_id(key)
        lid = self._leader()
        waited = 0
        while lid < 0:
            self._step(5)
            waited += 5
            if waited > self.timeout:
                raise Timeout("no leader elected")
            lid = self._leader()
        st = self.sim.state
        pos = int(st["log_len"][lid])
        if pos >= self.sim.cfg.max_log:
            raise Timeout("log window full; run an epoch to compact")
        new = {k: st[k].clone() for k in ("log_term", "log_key", "log_val",
                                           "log_len", "entry_submit_t")}
        new["log_term"][lid, pos] = st["term"][lid]
        new["log_key"][lid, pos] = kid
        new["log_val"][lid, pos] = value
        new["log_len"][lid] = pos + 1
        new["entry_submit_t"][pos] = st["tick"]
        self.sim.state = dict(st, **new)
        t0 = self._tick_now()
        while True:
            self._step(1)
            st = self.sim.state
            lid_now = self._leader()
            if lid_now >= 0 and int(st["commit_len"][lid_now]) > pos:
                now = self._tick_now()
                self.session_floor = max(self.session_floor, pos + 1)
                self.annotations.append({
                    "name": f"put {key}", "start_tick": t0,
                    "end_tick": now, "revision": pos, "leader": lid_now})
                return PutResult(revision=pos, latency_ticks=now - t0)
            if self._tick_now() - t0 > self.timeout:
                raise Timeout(f"put({key}) not committed "
                              f"after {self.timeout} ticks")

    def _record_read(self, latency_ticks: int) -> None:
        """Fold one completed read into the service's record and the
        cluster's unit-bin read histogram (DESIGN.md §11)."""
        self.read_latencies.append(int(latency_ticks))
        st = self.sim.state
        H = st["read_lat_hist"].shape[0]
        b = min(max(int(latency_ticks), 0), H - 1)
        hist = st["read_lat_hist"].clone()
        hist[b] += 1
        self.sim.state = dict(
            st,
            reads_served=st["reads_served"] + 1,
            read_lat_sum=st["read_lat_sum"] + float(latency_ticks),
            read_lat_max=torch.clamp(st["read_lat_max"],
                                     min=float(latency_ticks)),
            read_lat_hist=hist)

    def get(self, key: str, *, allow_observer: bool = True,
            wait_for_leader: bool = False) -> Tuple[int, int]:
        """One explicit read-index round: leader fence, replica pick,
        apply-index wait.  Returns `(value, revision)` with `revision =
        readindex`; raises `NotLeader` without a leader unless
        `wait_for_leader`, and `Timeout` past the timeout."""
        kid = self._key_id(key)
        t0 = self._tick_now()
        lid = self._leader()
        if lid < 0 and not wait_for_leader:
            raise NotLeader("no leader for readindex")
        waited = 0
        while lid < 0:
            self._step(5)
            waited += 5
            if waited > self.timeout:
                raise Timeout("read: no leader elected")
            lid = self._leader()
        st = self.sim.state
        role = st["role"].cpu().numpy()
        alive = st["alive"].cpu().numpy()
        applied = st["applied_len"].cpu().numpy()
        readindex = max(int(st["commit_len"][lid]), self.session_floor)
        node = None
        if allow_observer:
            obs = np.where((role == SM.OBSERVER) & alive &
                           (applied >= readindex))[0]
            if obs.size:
                node = int(obs[0])
        if node is None:
            fol = np.where(((role == SM.FOLLOWER) | (role == SM.LEADER)) &
                           alive & (applied >= readindex))[0]
            node = int(fol[0]) if fol.size else lid
        waited = 0
        while int(self.sim.state["applied_len"][node]) < readindex:
            self._step(1)
            waited += 1
            if waited > self.timeout:
                raise Timeout("read: node never reached readindex")
        value = int(self.sim.state["kv"][node, kid])
        self.session_floor = max(self.session_floor, readindex)
        now = self._tick_now()
        self.annotations.append({
            "name": f"read {key}", "start_tick": t0, "end_tick": now,
            "fence": readindex, "node": node})
        self._record_read(now - t0)
        return value, readindex

    def get_stale(self, key: str) -> Tuple[int, int]:
        """Bounded-staleness read through the digest tier (DESIGN.md
        §13): no read-index fence.  A live digest observer serves when it
        is within the staleness bound (`tick - dobs_synced_t <=
        staleness_bound`) and not behind this session's floor
        (`dobs_applied >= session_floor`); the freshest such observer
        serves.  It holds no log, so the value is the last-wins replay of
        its source's applied prefix `log[:dobs_applied]`, the state its
        digest certifies.  Returns `(value, revision)` with `revision =
        dobs_applied` (value -1 for a key never written) and raises the
        session floor to it.  With no qualifying observer (tier off, all
        stale, or all behind the floor) the read reroutes to the fenced
        `get`."""
        if int(self.sim.static.get("O", 0)) == 0:
            return self.get(key)
        st = self.sim.state
        kid = self._key_id(key)
        t0 = self._tick_now()
        alive = st["dobs_alive"].cpu().numpy()
        applied = st["dobs_applied"].cpu().numpy()
        synced = st["dobs_synced_t"].cpu().numpy()
        bound = int(self.sim.cfg_c["staleness_bound"])
        ok = alive & (t0 - synced <= bound) & (applied >= self.session_floor)
        cand = np.where(ok)[0]
        if not cand.size:
            return self.get(key)
        o = int(cand[np.argmax(applied[cand])])
        revision = int(applied[o])
        fol = int(st["dobs_fol"][o])
        keys = st["log_key"][fol][:revision].cpu().numpy()
        vals = st["log_val"][fol][:revision].cpu().numpy()
        hits = np.where(keys == kid)[0]
        value = int(vals[hits[-1]]) if hits.size else -1
        self.session_floor = max(self.session_floor, revision)
        now = self._tick_now()
        self.annotations.append({
            "name": f"read.stale {key}", "start_tick": t0, "end_tick": now,
            "revision": revision, "observer": o})
        self._record_read(now - t0)
        return value, revision
