"""Plain PyTorch twin of the leader fan-out kernel, lifted from the XLA
cumsum/gather form of `repro.core.step.leader_step` (the same body as
`repro.kernels.leader_fanout.ref`) with the member axis B written out.
Equal, member for member, to the JAX op and ref on the same int32
inputs (`tests/test_torch_kernels.py`).
"""
from __future__ import annotations

import torch

FOLLOWER, CANDIDATE, SECRETARY = 0, 1, 3


def leader_fanout_ref(role, alive, warn_timer, sec_of, match_len,
                      app_arrive_t, app_from_len, app_upto, app_term,
                      app_commit, rtt, lid_c, has_leader, tick,
                      ldr_len, ldr_term, ldr_commit, *,
                      msg_budget: int, max_ship: int, entries_per_msg: int):
    """Budgeted AppendEntries fan-out of every member.

    Per-node rows (B, N); rtt (B, N, N) int32; (B,) tensors lid_c
    (clamped leader id), has_leader (bool), tick, and each leader's log
    length, term and commit length.  Returns (app_arrive_t,
    app_from_len, app_upto, app_term, app_commit) rows and `work`, the
    (B,) leader-work delta."""
    N = role.shape[1]
    ids = torch.arange(N, device=role.device)
    col = lambda x: x[:, None]
    secc = sec_of.clamp(0, N - 1).long()     # clamped, as a JAX gather is
    at = lambda row: torch.gather(row, 1, secc)
    sec_alive = (sec_of >= 0) & at(alive) & (at(role) == SECRETARY) & \
        (at(warn_timer) < 0)
    lid = col(lid_c.long())
    relay = torch.where(sec_alive, secc, lid)
    to_sec = relay != lid
    is_target = ((role == FOLLOWER) | (role == CANDIDATE)) & alive & \
        (ids != lid)
    rtt_lid = torch.gather(rtt, 1, lid[..., None].expand(-1, 1, N))[:, 0]
    lat = torch.gather(rtt_lid, 1, relay) * to_sec.to(torch.int32) + \
        _rtt_from(rtt, relay)
    arrive = col(tick) + lat
    want = col(has_leader) & is_target & (app_arrive_t < 0)
    direct = want & ~to_sec
    relayed = want & to_sec
    q = (role == SECRETARY) & alive & (warn_timer < 0)
    n_sec = torch.where(relayed.any(1), q.sum(1, dtype=torch.int32), 0)
    budget = torch.clamp(msg_budget - n_sec, min=0)
    pending = torch.clamp(col(ldr_len) - match_len, min=0)
    cost = 1 + torch.clamp(pending, max=max_ship) // entries_per_msg
    rank = torch.cumsum(torch.where(direct, cost, 0), 1, dtype=torch.int32)
    ship = relayed | (direct & (rank <= col(budget)))
    out_arrive = torch.where(ship, arrive, app_arrive_t)
    out_from = torch.where(ship, match_len, app_from_len)
    out_upto = torch.where(ship, torch.minimum(match_len + max_ship,
                                               col(ldr_len)), app_upto)
    out_term = torch.where(ship, col(ldr_term), app_term)
    out_commit = torch.where(ship, col(ldr_commit), app_commit)
    work = (ship & direct).sum(1, dtype=torch.int32) + n_sec
    return (out_arrive.to(torch.int32), out_from, out_upto.to(torch.int32),
            out_term.to(torch.int32), out_commit.to(torch.int32),
            work.to(torch.int32))


def _rtt_from(rtt, relay):
    """rtt[b, relay[b, i], i] for every member b and node i."""
    N = relay.shape[1]
    flat = relay.long() * N + torch.arange(N, device=relay.device)
    return torch.gather(rtt.reshape(rtt.shape[0], -1), 1, flat)
