"""Public ops of the raft_tick family (DESIGN.md §8): what
`core/step.py`'s follower, commit and apply phases call.

Each op has the unbatched signature of `repro.kernels.raft_tick.ops`.
A CPU tensor runs the plain twin in `ref.py`; a CUDA tensor launches the
kernel in `csrc/raft_tick.cu` (batch axis B = 1) after the operands are
checked, else the op raises.  On the card `log_match_append` and
`apply_last_wins` update the log rows and the KV rows IN PLACE and
return those same tensors — the JAX ops return new arrays, but at the
paper's config the three (N, L) logs alone are 4.3 MB that only a
256-entry window of changes.  Callers that need the old rows clone them.
Every launch adds one to the op's `launches` attribute.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import check, on_cpu
from repro_torch.kernels.raft_tick import kernel as K
from repro_torch.kernels.raft_tick import ref

_I32, _BOOL = torch.int32, torch.bool


def log_match_append(log_term, log_key, log_val, ldr_term, ldr_key, ldr_val,
                     log_len, app_from_len, app_upto, due, *, w: int):
    """Fused follower log-match + window append.

    log_* (N, L) int32; ldr_* (L,) — the leader's rows, separate copies;
    log_len / app_from_len / app_upto (N,) int32; due (N,) bool.
    Returns (log_term, log_key, log_val, new_len, accept)."""
    if on_cpu(log_term, "log_match_append"):
        return ref.log_match_append_ref(
            log_term, log_key, log_val, ldr_term, ldr_key, ldr_val,
            log_len, app_from_len, app_upto, due, w=w)
    N, L = log_term.shape
    dev = log_term.device
    for name, t, dt, sh in (
            ("log_term", log_term, _I32, (N, L)),
            ("log_key", log_key, _I32, (N, L)),
            ("log_val", log_val, _I32, (N, L)),
            ("ldr_term", ldr_term, _I32, (L,)),
            ("ldr_key", ldr_key, _I32, (L,)),
            ("ldr_val", ldr_val, _I32, (L,)),
            ("log_len", log_len, _I32, (N,)),
            ("app_from_len", app_from_len, _I32, (N,)),
            ("app_upto", app_upto, _I32, (N,)),
            ("due", due, _BOOL, (N,))):
        check("log_match_append", name, t, dt, sh, dev)
    for a, b in ((ldr_term, log_term), (ldr_key, log_key),
                 (ldr_val, log_val)):
        if a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr():
            raise ValueError("log_match_append: leader rows must be copies, "
                             "not views of the logs updated in place")
    new_len = torch.empty((N,), dtype=_I32, device=dev)
    accept = torch.empty((N,), dtype=_BOOL, device=dev)
    b = lambda t: t.unsqueeze(0)
    K.log_match_append(b(log_term), b(log_key), b(log_val), b(ldr_term),
                       b(ldr_key), b(ldr_val), b(log_len), b(app_from_len),
                       b(app_upto), b(due), b(new_len), b(accept), w=int(w))
    log_match_append.launches += 1
    return log_term, log_key, log_val, new_len, accept


log_match_append.launches = 0


def commit_majority(match_len, voter_alive, ldr_term, ldr_cur_term,
                    majority: int):
    """Majority-replicated commit length of the current term.

    match_len (N,) int32; voter_alive (N,) bool; ldr_term (L,) int32;
    ldr_cur_term a 0-d int32 tensor; majority a python int.  Returns a
    0-d int32 tensor on the operands' device (never read on the host)."""
    if on_cpu(match_len, "commit_majority"):
        return ref.commit_majority_ref(match_len, voter_alive, ldr_term,
                                       ldr_cur_term, majority)
    N, L = match_len.shape[0], ldr_term.shape[0]
    dev = match_len.device
    if N > 1024:
        raise ValueError(f"commit_majority: N={N} exceeds one block (1024)")
    for name, t, dt, sh in (("match_len", match_len, _I32, (N,)),
                            ("voter_alive", voter_alive, _BOOL, (N,)),
                            ("ldr_term", ldr_term, _I32, (L,)),
                            ("ldr_cur_term", ldr_cur_term, _I32, ())):
        check("commit_majority", name, t, dt, sh, dev)
    out = torch.empty((1,), dtype=_I32, device=dev)
    K.commit_majority(match_len.unsqueeze(0), voter_alive.unsqueeze(0),
                      ldr_term.unsqueeze(0), ldr_cur_term.reshape(1), out,
                      majority=int(majority))
    commit_majority.launches += 1
    return out[0]


commit_majority.launches = 0


def apply_last_wins(kv, keys, vals, valid):
    """Last-wins state-machine apply: kv (N, K) int32; keys/vals (N, A)
    int32; valid (N, A) bool.  Returns the updated (N, K) kv."""
    if on_cpu(kv, "apply_last_wins"):
        return ref.apply_last_wins_ref(kv, keys, vals, valid)
    N, Kk = kv.shape
    A = keys.shape[1]
    dev = kv.device
    for name, t, dt, sh in (("kv", kv, _I32, (N, Kk)),
                            ("keys", keys, _I32, (N, A)),
                            ("vals", vals, _I32, (N, A)),
                            ("valid", valid, _BOOL, (N, A))):
        check("apply_last_wins", name, t, dt, sh, dev)
    K.apply_last_wins(kv.unsqueeze(0), keys.unsqueeze(0), vals.unsqueeze(0),
                      valid.unsqueeze(0))
    apply_last_wins.launches += 1
    return kv


apply_last_wins.launches = 0
