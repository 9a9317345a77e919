"""Safety-property checkers (paper Properties 3.1–3.4) over sim traces,
a copy of `repro.core.invariants` whose `snapshot` takes the port's
tensors.

These run on host-side numpy snapshots of cluster state (taken every tick
or every few ticks) and raise AssertionError with a diagnostic when a
property is violated.  Used by the hypothesis property tests.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from repro_torch.core.state import LEADER


def snapshot(state) -> Dict[str, np.ndarray]:
    """Host copies (never views) of the leaves the checks read."""
    keep = ("role", "term", "alive", "log_term", "log_key", "log_val",
            "log_len", "commit_len", "applied_len")
    return {k: state[k].cpu().numpy().copy() if hasattr(state[k], "cpu")
            else np.array(state[k]) for k in keep}


def check_election_safety(trace: Sequence[Dict[str, np.ndarray]]) -> None:
    """Property 3.1: at most one leader per term, ever."""
    leader_of_term: Dict[int, int] = {}
    for t, snap in enumerate(trace):
        leaders = np.where((snap["role"] == LEADER) & snap["alive"])[0]
        terms = snap["term"][leaders]
        # no two simultaneous leaders with the same term
        assert len(set(terms)) == len(terms), \
            f"tick {t}: two leaders share a term: {list(zip(leaders, terms))}"
        for lid, term in zip(leaders, terms):
            prev = leader_of_term.get(int(term))
            assert prev is None or prev == int(lid), \
                f"tick {t}: term {term} had leader {prev}, now {lid}"
            leader_of_term[int(term)] = int(lid)


def check_log_matching(snap: Dict[str, np.ndarray]) -> None:
    """Property 3.3: if two logs share (index, term), they are identical
    up to that index."""
    n = snap["log_term"].shape[0]
    lens = snap["log_len"]
    for i in range(n):
        for j in range(i + 1, n):
            m = int(min(lens[i], lens[j]))
            if m == 0:
                continue
            ti = snap["log_term"][i, :m]
            tj = snap["log_term"][j, :m]
            same = ti == tj
            # find the last shared (index,term); everything before must match
            shared = np.where(same)[0]
            if shared.size == 0:
                continue
            last = shared[-1]
            if not same[:last + 1].all():
                continue  # diverged-then-reconverged impossible; skip holes
            assert (snap["log_key"][i, :last + 1] ==
                    snap["log_key"][j, :last + 1]).all() and \
                   (snap["log_val"][i, :last + 1] ==
                    snap["log_val"][j, :last + 1]).all(), \
                f"log matching violated between nodes {i},{j} " \
                f"at <= {last}"


def check_state_machine_safety(snap: Dict[str, np.ndarray]) -> None:
    """Property 3.2: every replica applies the same commands in the same
    order — applied prefixes agree (keys and values)."""
    n = snap["log_term"].shape[0]
    ap = snap["applied_len"]
    for i in range(n):
        for j in range(i + 1, n):
            m = int(min(ap[i], ap[j]))
            if m == 0:
                continue
            assert (snap["log_key"][i, :m] == snap["log_key"][j, :m]).all() \
                and (snap["log_val"][i, :m] ==
                     snap["log_val"][j, :m]).all() \
                and (snap["log_term"][i, :m] ==
                     snap["log_term"][j, :m]).all(), \
                f"state machine safety violated between {i},{j} upto {m}"


def check_commit_durability(trace: Sequence[Dict[str, np.ndarray]]) -> None:
    """Once committed at length c with content X, no later snapshot may show
    different content below c (within one log window/epoch)."""
    best: Dict[int, tuple] = {}
    for t, snap in enumerate(trace):
        c = int(snap["commit_len"].max())
        if c == 0:
            continue
        lid = int(np.argmax(snap["commit_len"]))
        key = snap["log_key"][lid, :c].copy()
        val = snap["log_val"][lid, :c].copy()
        for idx in range(c):
            k = (int(key[idx]), int(val[idx]))
            if idx in best:
                assert best[idx] == k, \
                    f"tick {t}: committed entry {idx} changed " \
                    f"{best[idx]} -> {k}"
            else:
                best[idx] = k


def check_all(trace: Sequence[Dict[str, np.ndarray]]) -> None:
    check_election_safety(trace)
    for snap in trace[:: max(len(trace) // 8, 1)]:
        check_log_matching(snap)
        check_state_machine_safety(snap)
    check_commit_durability(trace)
