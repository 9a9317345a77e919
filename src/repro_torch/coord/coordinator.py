"""ConsensusCoordinator: the BW-Raft control plane for multi-pod training
(the port of `repro.coord.coordinator`, over the port's `BWRaftSim` and
`BWKVService`).

Each training pod is a voter; checkpoint commits, membership views and
scale decisions flow through the replicated log, so every pod derives the
same view after any failure (restart = read the last committed
CKPT_COMMIT from the replicated state machine, never from local disk).
Every tick the coordinator drives runs the four per-tick consensus
kernels (`log_match_append`, `commit_majority`, `apply_last_wins`,
`leader_fanout`) on the sim's device; a CKPT_COMMIT lands in the state
machine's `kv` through `apply_last_wins`.

In this process the cluster is the simulator; on real hardware each
pod would run one node with the same record schema.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core import state as SM
from repro_torch.core.cluster_config import ClusterConfig
from repro_torch.core.runtime import BWRaftSim
from repro_torch.coord import log_records as rec
from repro_torch.kvstore.service import BWKVService, Timeout

COMMIT_TICKS = 400          # a typed record's commit wait, as in JAX


@dataclasses.dataclass
class CommittedCheckpoint:
    step: int
    digest_tag: int
    revision: int


class ConsensusCoordinator:
    """`sim` (a `BWRaftSim`) lets a caller hand in a prepared cluster, as
    the tests hand in one under the JAX draw tape; by default a BW-Raft
    sim with no client load and no resource management, on `device`
    (None: the card, as every entry point)."""

    def __init__(self, cfg: ClusterConfig, *, seed: int = 0,
                 sim: Optional[BWRaftSim] = None, device=None):
        self.cfg = cfg
        self.sim = sim or BWRaftSim(cfg, mode="bwraft", write_rate=0.0,
                                    read_rate=0.0, seed=seed,
                                    manage_resources=False, device=device)
        self.kv = BWKVService(self.sim)
        self._tick0 = int(self.sim.state["tick"])

    @property
    def ticks(self) -> int:
        """Ticks the cluster has run since this coordinator was built."""
        return int(self.sim.state["tick"]) - self._tick0

    def _record_key(self, rtype: rec.RecordType) -> int:
        return rec.record_base(self.cfg.key_space) + int(rtype)

    def _leader(self) -> int:
        return int(SM.leader_id(self.sim.state))

    # -- checkpoint commit protocol ------------------------------------ #
    def commit_checkpoint(self, step: int, digest_hex: str
                          ) -> CommittedCheckpoint:
        """Propose CKPT_COMMIT(step, digest); returns once majority-
        replicated.  Raises Timeout if consensus can't be reached."""
        value = rec.pack_ckpt(step, digest_hex)
        res = self.kv.put("__ckpt__", value)
        # __ckpt__ hashes arbitrarily; also store under the typed key for
        # crash recovery via state-machine read
        self._put_typed(rec.RecordType.CKPT_COMMIT, value)
        return CommittedCheckpoint(step, value % 4096, res.revision)

    def _put_typed(self, rtype: rec.RecordType, value: int) -> None:
        """Append (typed key, value) at the leader's log end, in place,
        and tick until some node's commit index passes it (at most
        COMMIT_TICKS ticks, then return as JAX does).  With no leader
        after 50 ticks the entry goes to the last node's log, as the JAX
        form's index -1 does."""
        kid = self._record_key(rtype)
        lid = self._leader()
        if lid < 0:
            self.kv._step(50)
            lid = self._leader()
        st = self.sim.state
        pos = int(st["log_len"][lid])
        if pos >= self.cfg.max_log:
            raise Timeout("log window full; run an epoch to compact")
        st["log_term"][lid, pos] = st["term"][lid]
        st["log_key"][lid, pos] = kid
        st["log_val"][lid, pos] = value
        st["log_len"][lid] = pos + 1
        st["entry_submit_t"][pos] = st["tick"]
        t = 0
        while int(self.sim.state["commit_len"].max()) <= pos and \
                t < COMMIT_TICKS:
            self.kv._step(1)
            t += 1

    def _read(self, rtype: rec.RecordType) -> int:
        """The record's value in the leader's state machine (node 0's
        without a leader)."""
        return int(self.sim.state["kv"][max(self._leader(), 0),
                                        self._record_key(rtype)])

    def last_committed_checkpoint(self) -> Optional[Tuple[int, int]]:
        """(step, digest_tag) from the replicated state machine — the
        restart path reads this, never local disk state."""
        value = self._read(rec.RecordType.CKPT_COMMIT)
        if value == 0:
            return None
        return rec.unpack_ckpt(value)

    # -- membership / elasticity ---------------------------------------- #
    def commit_membership(self, alive_bitmap: int) -> None:
        self._put_typed(rec.RecordType.MEMBERSHIP,
                        rec.pack_membership(alive_bitmap))

    def membership(self) -> int:
        return self._read(rec.RecordType.MEMBERSHIP)

    def commit_scale(self, k_s: int, k_o: int) -> None:
        self._put_typed(rec.RecordType.SCALE, rec.pack_scale(k_s, k_o))

    # -- pod failure ----------------------------------------------------- #
    def kill_pod(self, pod: int) -> None:
        """Simulate a voter-pod failure (e.g. the coordinator/leader)."""
        self.sim.state["alive"][pod] = False

    def revive_pod(self, pod: int) -> None:
        self.sim.state["alive"][pod] = True
        self.sim.state["role"][pod] = SM.FOLLOWER

    def wait_for_leader(self, max_ticks: int = 600) -> int:
        t = 0
        while t < max_ticks:
            lid = self._leader()
            if lid >= 0:
                # classic Raft: a new leader commits a no-op of its own term
                # so prior-term entries (e.g. CKPT_COMMIT) become committed
                # and applied under the new leadership (§5.4.2)
                self._put_typed(rec.RecordType.EPOCH_MARK,
                                int(self.sim.state["tick"]))
                return lid
            self.kv._step(5)
            t += 5
        raise Timeout("no leader")
