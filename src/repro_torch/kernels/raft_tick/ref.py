"""Plain PyTorch twins of the raft_tick kernels, lifted from the XLA
fast forms of `repro.core.step` (the follower window select, the
count-threshold commit, the sequential last-wins apply).

Each twin has the unbatched op signature of `ops.py` and is bit-equal to
the JAX `ops.py` (Pallas, interpret mode) and `ref.py` on the same int32
inputs (`tests/test_torch_kernels.py`).  They are what a CPU tensor runs
and what `chip_smoke.py` holds each CUDA kernel against on the card.
"""
from __future__ import annotations

import torch


def log_match_append_ref(log_term, log_key, log_val, ldr_term, ldr_key,
                         ldr_val, log_len, app_from_len, app_upto, due, *,
                         w: int):
    """Follower log-match at prev = from-1 and the window adopt
    [from, min(upto, from + w)) of the leader's row.

    log_* (N, L) int32; ldr_* (L,); per-node vectors (N,) int32; due (N,)
    bool.  Returns new (log_term, log_key, log_val), new_len (N,) int32
    and accept (N,) bool."""
    N, L = log_term.shape
    prev = app_from_len - 1
    prev_c = prev.clamp(0, L - 1).long()
    my_prev = torch.gather(log_term, 1, prev_c[:, None])[:, 0]
    ldr_prev = ldr_term[prev_c]
    same = my_prev == ldr_prev
    accept = due & ((prev < 0) | same)
    hi = torch.minimum(app_upto, app_from_len + w)
    pos = torch.arange(L, device=log_term.device)[None, :]
    sel = accept[:, None] & (pos >= app_from_len[:, None]) & \
        (pos < hi[:, None])
    out = tuple(torch.where(sel, row[None, :], dst) for dst, row in
                ((log_term, ldr_term), (log_key, ldr_key),
                 (log_val, ldr_val)))
    new_len = torch.where(accept, hi, log_len)
    new_len = torch.where(accept & (log_len > new_len) & same,
                          torch.maximum(log_len, new_len), new_len)
    return (*out, new_len, accept)


def commit_majority_ref(match_len, voter_alive, ldr_term, ldr_cur_term,
                        majority: int):
    """Largest l <= L with count(alive voters at match_len >= l) >=
    majority and ldr_term[l-1] == ldr_cur_term (Raft §5.4.2), as a 0-d
    int32 tensor; 0 when none qualifies."""
    L = ldr_term.shape[0]
    lens = torch.arange(1, L + 1, dtype=torch.int32, device=ldr_term.device)
    counts = ((match_len[None, :] >= lens[:, None]) &
              voter_alive[None, :]).sum(1)
    ok = (counts >= majority) & (ldr_term == ldr_cur_term)
    return torch.where(ok, lens, 0).max().to(torch.int32)


def apply_last_wins_ref(kv, keys, vals, valid):
    """Entry a of row i writes kv[i, keys[i, a]] = vals[i, a] iff valid,
    in ascending a, so the last committed entry per key wins; negative
    keys wrap once, keys still outside [0, K) are dropped.  Returns the
    new (N, K) kv."""
    N, K = kv.shape
    keys = torch.where(keys < 0, keys + K, keys)
    ok = valid & (keys >= 0) & (keys < K)
    out = torch.cat([kv, kv.new_zeros((N, 1))], dim=1)   # spare drop column
    for a in range(keys.shape[1]):
        col = torch.where(ok[:, a], keys[:, a], K).long()[:, None]
        out.scatter_(1, col, vals[:, a:a + 1])
    return out[:, :K].contiguous()
