"""Wing & Gong linearizability checker for single-key KV histories (a
copy of `repro.core.linearizability`).

An operation is `Op(kind, key, value, invoke_t, respond_t)`.  The checker
searches for a total order of operations that (1) respects real-time
precedence (op A precedes op B iff A.respond_t < B.invoke_t) and (2) is a
legal sequential KV history (each read returns the latest preceding write,
or the initial value).  Exponential in the worst case — meant for the
small histories the tests generate (<= ~15 concurrent ops).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Op:
    kind: str              # "w" | "r"
    key: int
    value: int
    invoke_t: float
    respond_t: float

    def __repr__(self):
        return (f"{self.kind}(k{self.key}={self.value})"
                f"@[{self.invoke_t},{self.respond_t}]")


def is_linearizable(history: Sequence[Op], initial: int = 0) -> bool:
    ops = list(history)
    n = len(ops)
    if n == 0:
        return True

    precedes = [[ops[a].respond_t < ops[b].invoke_t for b in range(n)]
                for a in range(n)]

    used = [False] * n
    order: List[int] = []

    def candidates():
        # minimal ops: not used, no unused predecessor
        out = []
        for i in range(n):
            if used[i]:
                continue
            if any(not used[j] and precedes[j][i] for j in range(n)):
                continue
            out.append(i)
        return out

    def legal(i: int, value_now: dict) -> bool:
        op = ops[i]
        if op.kind == "w":
            return True
        return value_now.get(op.key, initial) == op.value

    def search(value_now: dict) -> bool:
        if len(order) == n:
            return True
        for i in candidates():
            if not legal(i, value_now):
                continue
            op = ops[i]
            used[i] = True
            order.append(i)
            old = value_now.get(op.key, initial)
            if op.kind == "w":
                value_now[op.key] = op.value
            if search(value_now):
                return True
            if op.kind == "w":
                value_now[op.key] = old
            order.pop()
            used[i] = False
        return False

    return search({})


def history_from_sim_trace(write_log, probe_reads) -> List[Op]:
    """Build a checkable single-key history from sim artifacts.

    write_log: iterable of (key, value, submit_t, commit_t) for committed
    writes; probe_reads: iterable of (key, value, t) instantaneous reads.
    """
    ops: List[Op] = []
    for k, v, s, c in write_log:
        ops.append(Op("w", int(k), int(v), float(s), float(c)))
    for k, v, t in probe_reads:
        ops.append(Op("r", int(k), int(v), float(t), float(t)))
    return ops
