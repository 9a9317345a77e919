"""Plain PyTorch twins of the raft_tick kernels, lifted from the XLA
fast forms of `repro.core.step` (the follower window select, the
count-threshold commit, the sequential last-wins apply).

Each twin has the batched op signature of `ops.py` (a leading member
axis B) and equals, member for member, the JAX `ops.py` (Pallas,
interpret mode) and `ref.py` on the same int32 inputs
(`tests/test_torch_kernels.py`).  They are what a CPU tensor runs and
what `chip_smoke.py` holds each CUDA kernel against on the card.
"""
from __future__ import annotations

import torch


def log_match_append_ref(log_term, log_key, log_val, ldr_term, ldr_key,
                         ldr_val, log_len, app_from_len, app_upto, due, *,
                         w: int):
    """Follower log-match at prev = from-1 and the window adopt
    [from, min(upto, from + w)) of the member's leader row.

    log_* (B, N, L) int32; ldr_* (B, L); per-node rows (B, N) int32; due
    (B, N) bool.  Returns new (log_term, log_key, log_val), new_len
    (B, N) int32 and accept (B, N) bool."""
    L = log_term.shape[2]
    prev = app_from_len - 1
    prev_c = prev.clamp(0, L - 1).long()
    my_prev = torch.gather(log_term, 2, prev_c[..., None])[..., 0]
    ldr_prev = torch.gather(ldr_term, 1, prev_c)
    same = my_prev == ldr_prev
    accept = due & ((prev < 0) | same)
    hi = torch.minimum(app_upto, app_from_len + w)
    pos = torch.arange(L, device=log_term.device)
    sel = accept[..., None] & (pos >= app_from_len[..., None]) & \
        (pos < hi[..., None])
    out = tuple(torch.where(sel, row[:, None, :], dst) for dst, row in
                ((log_term, ldr_term), (log_key, ldr_key),
                 (log_val, ldr_val)))
    new_len = torch.where(accept, hi, log_len)
    new_len = torch.where(accept & (log_len > new_len) & same,
                          torch.maximum(log_len, new_len), new_len)
    return (*out, new_len, accept)


def commit_majority_ref(match_len, voter_alive, ldr_term, ldr_cur_term,
                        majority):
    """Per member: the largest l <= L with count(alive voters at
    match_len >= l) >= majority and ldr_term[l-1] == ldr_cur_term (Raft
    §5.4.2), as a (B,) int32 tensor; 0 when none qualifies."""
    L = ldr_term.shape[1]
    lens = torch.arange(1, L + 1, dtype=torch.int32, device=ldr_term.device)
    counts = ((match_len[:, None, :] >= lens[None, :, None]) &
              voter_alive[:, None, :]).sum(2)
    ok = (counts >= majority[:, None]) & \
        (ldr_term == ldr_cur_term[:, None])
    return torch.where(ok, lens, 0).max(1).values.to(torch.int32)


def apply_last_wins_ref(kv, keys, vals, valid):
    """Entry a of row (b, i) writes kv[b, i, keys[b, i, a]] = vals[b, i,
    a] iff valid, in ascending a, so the last committed entry per key
    wins; negative keys wrap once, keys still outside [0, K) are
    dropped.  Returns the new (B, N, K) kv."""
    B, N, K = kv.shape
    keys = torch.where(keys < 0, keys + K, keys)
    ok = valid & (keys >= 0) & (keys < K)
    out = torch.cat([kv, kv.new_zeros((B, N, 1))], dim=2)  # spare column
    for a in range(keys.shape[2]):
        col = torch.where(ok[..., a], keys[..., a], K).long()[..., None]
        out.scatter_(2, col, vals[..., a:a + 1])
    return out[..., :K].contiguous()
