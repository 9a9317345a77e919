"""ctypes launchers for the raft_tick CUDA kernels (`csrc/raft_tick.cu`).

They replace the Pallas kernels of `repro.kernels.raft_tick.kernel`
(`log_match_append_kernel`, `commit_majority_kernel`,
`apply_last_wins_kernel`).  Each takes batched, contiguous CUDA tensors
that `ops.py` has checked, launches on its operands' device and that
device's current stream, and raises if the launch was refused.  At the
paper's config all three move well under 1 MB, so each is bound by its
launch and the chain of round trips inside it, not by memory or
arithmetic.  `log_match_append` gives each (member, row) a block of 128
threads with no shared memory and no barrier: a row that is not due
makes one round trip, a due row one more, which loads the prev terms and
the leader window into registers together.  The design notes are in the
CUDA source.
"""
from __future__ import annotations

from repro_torch import kernels as tk
from repro_torch.kernels import build

_FNS = {}


def _fn(name: str, n_ptr: int, n_int: int):
    if name not in _FNS:
        _FNS[name] = build.bind(build.load("raft_tick"), name, n_ptr, n_int)
    return _FNS[name]


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def log_match_append(term, key, val, lterm, lkey, lval, log_len, frm, upto,
                     due, new_len, accept, *, w: int) -> None:
    """term/key/val (B, N, L) updated in place; leader rows (B, L);
    vectors (B, N); new_len (B, N) int32 and accept (B, N) bool out."""
    B, N, L = term.shape
    f = _fn("raft_log_match_append", 12, 4)
    with tk.device_stream(term) as stream:
        rc = f(*(t.data_ptr() for t in (term, key, val, lterm, lkey, lval,
                                        log_len, frm, upto, due, new_len,
                                        accept)), B, N, L, w, stream)
    _check(rc, "log_match_append")


def commit_majority(match, voter_alive, lterm, cur_term, majority,
                    out) -> None:
    """match/voter_alive (B, N); lterm (B, L); cur_term and majority
    (B,) int32; the commit lengths land in out (B,) int32."""
    B, N = match.shape
    L = lterm.shape[1]
    f = _fn("raft_commit_majority", 6, 3)
    with tk.device_stream(match) as stream:
        rc = f(*(t.data_ptr() for t in (match, voter_alive, lterm, cur_term,
                                        majority, out)), B, N, L, stream)
    _check(rc, "commit_majority")


def apply_last_wins(kv, keys, vals, valid) -> None:
    """kv (B, N, K) updated in place from keys/vals/valid (B, N, A)."""
    B, N, K = kv.shape
    A = keys.shape[2]
    f = _fn("raft_apply_last_wins", 4, 4)
    with tk.device_stream(kv) as stream:
        rc = f(*(t.data_ptr() for t in (kv, keys, vals, valid)), B, N, K, A,
               stream)
    _check(rc, "apply_last_wins")
