"""Plain PyTorch twin of the leader fan-out kernel, lifted from the XLA
cumsum/gather form of `repro.core.step.leader_step` (the same body as
`repro.kernels.leader_fanout.ref`).  Bit-equal to the JAX op and ref on
the same int32 inputs (`tests/test_torch_kernels.py`).
"""
from __future__ import annotations

import torch

FOLLOWER, CANDIDATE, SECRETARY = 0, 1, 3


def leader_fanout_ref(role, alive, warn_timer, sec_of, match_len,
                      app_arrive_t, app_from_len, app_upto, app_term,
                      app_commit, rtt, lid_c, has_leader, tick,
                      ldr_len, ldr_term, ldr_commit, *,
                      msg_budget: int, max_ship: int, entries_per_msg: int):
    """Budgeted AppendEntries fan-out.

    Per-node vectors (N,); rtt (N, N) int32; 0-d tensors lid_c (clamped
    leader id), has_leader (bool), tick, and the leader's log length,
    term and commit length.  Returns (app_arrive_t, app_from_len,
    app_upto, app_term, app_commit, work), `work` the 0-d leader-work
    delta."""
    N = role.shape[0]
    ids = torch.arange(N, device=role.device)
    secc = sec_of.clamp(0, N - 1).long()     # clamped, as a JAX gather is
    sec_alive = (sec_of >= 0) & alive[secc] & (role[secc] == SECRETARY) & \
        (warn_timer[secc] < 0)
    relay = torch.where(sec_alive, secc, lid_c.long())
    to_sec = relay != lid_c
    is_target = ((role == FOLLOWER) | (role == CANDIDATE)) & alive & \
        (ids != lid_c)
    lat = rtt[lid_c.long(), relay] * to_sec.to(torch.int32) + \
        rtt[relay, ids]
    arrive = tick + lat
    want = has_leader & is_target & (app_arrive_t < 0)
    direct = want & ~to_sec
    relayed = want & to_sec
    q = (role == SECRETARY) & alive & (warn_timer < 0)
    n_sec = torch.where(relayed.any(), q.sum(dtype=torch.int32), 0)
    budget = torch.clamp(msg_budget - n_sec, min=0)
    pending = torch.clamp(ldr_len - match_len, min=0)
    cost = 1 + torch.clamp(pending, max=max_ship) // entries_per_msg
    rank = torch.cumsum(torch.where(direct, cost, 0), 0, dtype=torch.int32)
    ship = relayed | (direct & (rank <= budget))
    out_arrive = torch.where(ship, arrive, app_arrive_t)
    out_from = torch.where(ship, match_len, app_from_len)
    out_upto = torch.where(ship, torch.minimum(match_len + max_ship,
                                               ldr_len), app_upto)
    out_term = torch.where(ship, ldr_term, app_term)
    out_commit = torch.where(ship, ldr_commit, app_commit)
    work = (ship & direct).sum(dtype=torch.int32) + n_sec
    return (out_arrive.to(torch.int32), out_from, out_upto.to(torch.int32),
            out_term.to(torch.int32), out_commit.to(torch.int32),
            work.to(torch.int32))
