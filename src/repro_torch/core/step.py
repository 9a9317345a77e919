"""One BW-Raft protocol tick on tensors (PyTorch port of
`repro.core.step`, its fast non-reference forms).

Phases in tick order: spot market, client arrivals, elections, the
leader's accept and fan-out, follower log-matching, the commit, the
apply, observer mirroring, the digest tier's anti-entropy round, reads,
cost (DESIGN.md §2, §6, §13).  Every rule is masked tensor math on the
state dict.  Five hot ops go through the kernel families (DESIGN.md §8):
`leader_fanout` in `leader_step`, the `raft_tick` trio in
`follower_step`, `commit_step` and `apply_step`, and `ae_sync` in
`anti_entropy_step`; on CUDA tensors they launch the hand-written
kernels.

The tick has ONE implementation, over a leading member axis B: the JAX
fleet `vmap`s its one-cluster body, here the axis is written out
(`state.stack`, `state.stack_static`), so a fleet of B clusters runs the
same number of ops per tick as one cluster and each kernel launches once
per tick for the whole fleet.  One cluster is B = 1 (`state.batch1`).
Members never couple: every reduction runs over the node axis (`dim=-1`
or 1), every gather and scatter stays inside its member's row.

Differences from the JAX tick, all of form and none of result:

* randomness comes in as one row of the epoch's draw bundle
  (`core/draws.py`) instead of a PRNG key — every draw of the tick
  depends only on the key schedule, `cfg_c` and the tick number;
* the tick never reads a tensor on the host (no `.item()`, no Python
  branch on a value): per-member scalars stay (B,) device tensors and
  gathers at the leaders go through `torch.gather` with (B,) indices;
* `static` is `state.stack_static(...)`: its tables are (B, ...)
  tensors on the state's device, its capacities shared python ints.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.draws import N_WINDOW
from repro_torch.core.state import (CANDIDATE, DEAD, FOLLOWER, LEADER,
                                    OBSERVER, SECRETARY, entry_mix,
                                    leader_id)
from repro_torch.kernels.ae_sync import ops as ae_ops
from repro_torch.kernels.leader_fanout import ops as lf_ops
from repro_torch.kernels.raft_tick import ops as rt_ops
from repro_torch.trace import metrics as trace_metrics
from repro_torch.trace import ring as trace_ring

_I32 = torch.int32


# --------------------------------------------------------------------- #
# small sync-free helpers over the member axis
# --------------------------------------------------------------------- #
def _i32(x) -> torch.Tensor:
    return x.to(_I32)


def _c(x) -> torch.Tensor:
    """A per-member (B,) tensor as a (B, 1) column, to broadcast over
    the node axis."""
    return x[:, None]


def _count(mask) -> torch.Tensor:
    """Per-member count of a (B, n) mask, (B,) int32."""
    return mask.sum(-1, dtype=_I32)


def _at(t, i) -> torch.Tensor:
    """t[b, i[b]] for every member b: (B,) from (B, n), a (B, L) row
    from (B, n, L)."""
    idx = i.long().reshape(-1, *([1] * (t.dim() - 1)))
    return torch.gather(t, 1, idx.expand(-1, 1, *t.shape[2:]))[:, 0]


def _at2(mat, i, j) -> torch.Tensor:
    """mat[b, i[b], j[b]] for a (B, n, m) tensor, as (B,)."""
    flat = (i.long() * mat.shape[2] + j.long())[:, None]
    return torch.gather(mat.reshape(mat.shape[0], -1), 1, flat)[:, 0]


def _col(mat, j) -> torch.Tensor:
    """mat[b, :, j[b]] for a (B, n, m) tensor, as (B, n)."""
    idx = j.long().reshape(-1, 1, 1).expand(-1, mat.shape[1], 1)
    return torch.gather(mat, 2, idx)[..., 0]


def _take(row, idx) -> torch.Tensor:
    """row[b, idx[b, k]] for (B, n) rows and (B, k) indices."""
    return torch.gather(row, 1, idx.long())


def _set_at(vec, i, val) -> torch.Tensor:
    """A copy of (B, n) `vec` with vec[b, i[b]] = val[b]."""
    return vec.scatter(1, i.long()[:, None], val.to(vec.dtype)[:, None])


def _add_at(vec, i, amt) -> torch.Tensor:
    """A copy of (B, n) `vec` with amt[b] added at vec[b, i[b]]."""
    return vec.scatter_add(1, i.long()[:, None], amt.to(vec.dtype)[:, None])


def _scatter_add_drop(vec, idx, src) -> torch.Tensor:
    """vec.at[idx].add(src, mode="drop") per member, for (B, n) `vec`
    and (B, k) idx in [0, n]: lanes at idx == n land in a spare slot
    that is cut off."""
    ext = torch.cat([vec, vec.new_zeros((vec.shape[0], 1))], dim=1)
    return ext.scatter_add(1, idx.long(), src.to(vec.dtype))[:, :-1]


def _ids(n, like) -> torch.Tensor:
    """Node ids as a (1, n) int32 row, broadcasting over members."""
    return torch.arange(n, dtype=_I32, device=like.device)[None, :]


def _relay_of(state, lid_c) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sec_alive, relay): a follower's batch goes via its secretary iff
    that node is an alive, unwarned SECRETARY (DESIGN.md §12), else
    directly from the leader."""
    sec = state["sec_of"]
    secc = sec.clamp(min=0)
    sec_alive = (sec >= 0) & _take(state["alive"], secc) & \
        (_take(state["role"], secc) == SECRETARY) & \
        (_take(state["warn_timer"], secc) < 0)
    return sec_alive, torch.where(sec_alive, sec, _c(lid_c))


def _ae_source(state, static) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(fol_ok, any_voter, eff): a digest observer's sync source is its
    wired voter when that is an alive voter, else its member's first
    alive voter (DESIGN.md §13)."""
    N = state["role"].shape[1]
    is_voter = static["is_voter"]
    fol = state["dobs_fol"]
    fol_c = fol.clamp(0, N - 1)
    fol_ok = (fol >= 0) & _take(state["alive"], fol_c) & \
        _take(is_voter, fol_c)
    alive_voter = is_voter & state["alive"]
    any_voter = alive_voter.any(1)
    fallback = _i32(torch.argmax(_i32(alive_voter), 1))
    return fol_ok, any_voter, torch.where(fol_ok, fol_c, _c(fallback))


def cross_shard_mark(idx, frac) -> torch.Tensor:
    """Entry `idx` is a cross-shard 2PC coordinator iff
    floor((idx+1)*frac) > floor(idx*frac) (DESIGN.md §9)."""
    i = idx.to(torch.float32)
    return torch.floor((i + 1) * frac) > torch.floor(i * frac)


# --------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------- #
def spot_step(state, static, cfg_c, draws):
    """Site prices and revocation of spot nodes (DESIGN.md §10, §12).

    The process-market price of this tick is `draws["price"]`, the walk
    run ahead for the epoch; a trace market replays `cfg_c`'s columns.
    The advance-warning timer, per-node columns, chaos schedules and the
    i.i.d. `phi` kills follow the JAX rules exactly.  Digest-tier slots
    (DESIGN.md §13) take the site signal, the warning window and the
    `phi` kills through their own draws."""
    use_trace = cfg_c["market_trace"]
    t = state["tick"] % cfg_c["trace_len"]
    price = torch.where(_c(use_trace), _col(cfg_c["price_trace"], t),
                        draws["price"])
    over_bid = price > cfg_c["spot_bid"]
    revoked_site = torch.where(_c(use_trace & ~cfg_c["bid_on_trace"]),
                               _col(cfg_c["revoke_trace"], t), over_bid)
    site = static["site"]
    is_spot = ~static["is_voter"]
    market_sig = torch.where(_c(cfg_c["node_trace"] & use_trace),
                             _col(cfg_c["revoke_node_trace"], t),
                             _take(revoked_site, site))
    tf = state["tick"] % cfg_c["fault_len"]
    fault_sig = _c(cfg_c["fault_on"]) & _col(cfg_c["fault_trace"], tf)
    alive0 = state["alive"]
    sig = alive0 & ((is_spot & market_sig) | fault_sig)
    warn = _c(cfg_c["warn_ticks"])

    timer0 = state["warn_timer"]
    newly = sig & (timer0 < 0)
    timer = torch.where(sig, torch.where(newly, warn,
                                         (timer0 - 1).clamp(min=0)), -1)
    due = sig & (timer <= 0)
    iid_fail = draws["fail_u"] < _c(cfg_c["phi"])
    killed = alive0 & (due | (is_spot & iid_fail))
    timer = _i32(torch.where(killed, -1, timer))

    prev_role = state["role"]
    reprieve = (timer0 >= 0) & ~sig & alive0
    warn_live = _c(cfg_c["warn_ticks"] > 0)
    state = dict(state, spot_price=price, alive=alive0 & ~killed,
                 role=_i32(torch.where(killed, DEAD, prev_role)),
                 warn_timer=timer)

    nid = _ids(killed.shape[1], killed)
    term = state["term"]
    rec = trace_ring.record
    state = rec(state, cfg_c, trace_ring.EV_WARN, valid=newly & warn_live,
                node=nid, term=term, aux=cfg_c["warn_ticks"],
                counter="warns_armed")
    state = rec(state, cfg_c, trace_ring.EV_KILL, valid=killed, node=nid,
                term=term, aux=prev_role, counter="kills")
    state = rec(state, cfg_c, trace_ring.EV_REPRIEVE, valid=reprieve,
                node=nid, term=term, counter="reprieves")
    state = rec(state, cfg_c, trace_ring.EV_SEC_HANDOFF,
                valid=newly & warn_live & (prev_role == SECRETARY),
                node=nid, term=term, counter="sec_handoffs")
    state = rec(state, cfg_c, trace_ring.EV_OBS_DRAIN,
                valid=newly & warn_live & (prev_role == OBSERVER),
                node=nid, term=term, counter="obs_drains")

    if state["dobs_alive"].shape[1]:
        d_alive = state["dobs_alive"]
        sig_d = d_alive & _take(revoked_site, static["dobs_site"])
        timer_d = state["dobs_warn"]
        newly_d = sig_d & (timer_d < 0)
        timer_d = torch.where(sig_d, torch.where(
            newly_d, warn, (timer_d - 1).clamp(min=0)), -1)
        due_d = sig_d & (timer_d <= 0)
        killed_d = d_alive & (due_d |
                              (draws["dobs_fail_u"] < _c(cfg_c["phi"])))
        state = dict(state, dobs_alive=d_alive & ~killed_d,
                     dobs_warn=_i32(torch.where(killed_d, -1, timer_d)))
    return state, killed


def workload_step(state, static, cfg_c, draws):
    """Client arrivals: writes to the leader's queue, reads spread over
    alive unwarned observers — dense slots and digest-tier slots alike
    (up to 90%, capacity-bounded) — and the rest over followers; the
    cross-shard split is deterministic (§9).  The digest tier takes the
    floored remainder that the dense split drops, by rank (§13)."""
    n_writes, n_reads = draws["n_writes"], draws["n_reads"]
    chi = cfg_c["cross_frac"]
    wa = state["writes_arrived"]
    n_cross = _i32(torch.floor((wa + n_writes).to(torch.float32) * chi) -
                   torch.floor(wa.to(torch.float32) * chi))
    role, alive = state["role"], state["alive"]
    is_obs = (role == OBSERVER) & alive & (state["warn_timer"] < 0)
    is_fol = ((role == FOLLOWER) | (role == LEADER)) & alive
    pool = _count(is_obs)
    extra = {}
    if state["dobs_alive"].shape[1]:
        is_dobs = state["dobs_alive"] & (state["dobs_warn"] < 0)
        pool = pool + _count(is_dobs)
    n_fol = _count(is_fol).clamp(min=1)
    cap = static["work_capacity"]
    obs_share = torch.where(pool > 0,
                            torch.minimum((n_reads * 9) // 10, pool * cap), 0)
    fol_share = n_reads - obs_share
    pool1 = pool.clamp(min=1)
    base = obs_share // pool1
    per_obs = torch.where(is_obs, _c(base), 0)
    if state["dobs_alive"].shape[1]:
        rem = obs_share - base * pool1
        r_dobs = torch.cumsum(_i32(is_dobs), 1, dtype=_I32) - 1
        extra["dobs_read_queue"] = _i32(
            state["dobs_read_queue"] +
            torch.where(is_dobs, _c(base) + _i32(r_dobs < _c(rem)), 0))
    per_fol = torch.where(is_fol, _c(fol_share // n_fol), 0)
    return dict(state, **extra,
                read_queue=_i32(state["read_queue"] + per_obs + per_fol),
                write_pending=state["write_pending"] + n_writes,
                reads_arrived=state["reads_arrived"] + n_reads,
                writes_arrived=wa + n_writes,
                cross_arrived=state["cross_arrived"] + n_cross)


def election_step(state, static, cfg_c, draws):
    """Timeouts -> candidacy; RequestVote with the log-up-to-date
    restriction; a majority of voters -> leader (Property 3.1); a new
    leader stops the secretaries (paper Step 1)."""
    N = state["role"].shape[1]
    L = state["log_term"].shape[2]
    tick = state["tick"]
    rtt = static["rtt"]
    is_voter = static["is_voter"]
    alive = state["alive"]
    role0 = state["role"]
    ids = _ids(N, tick)

    et = state["election_timer"] - 1
    timed_out = (et <= 0) & is_voter & alive & \
        ((role0 == FOLLOWER) | (role0 == CANDIDATE))
    term = torch.where(timed_out, state["term"] + 1, state["term"])
    role = torch.where(timed_out, CANDIDATE, role0)
    voted_for = torch.where(timed_out, ids, state["voted_for"])
    new_timeout = draws["timeouts"]
    et = torch.where(timed_out | (et <= 0), new_timeout, et)

    is_cand = (role == CANDIDATE) & alive
    cand_term = torch.where(is_cand, term, -1)
    best = _i32(torch.argmax(cand_term, 1))
    have_cand = cand_term.max(1).values >= 0
    last_len = _at(state["log_len"], best)
    last_term = _at2(state["log_term"], best, (last_len - 1).clamp(0, L - 1))
    best_term = _at(term, best)
    place = _c(have_cand) & is_voter & (_c(best_term) > state["vreq_term"]) \
        & alive
    vreq_t = torch.where(place, _c(tick) + _at(rtt, best), state["vreq_t"])
    vreq_from = torch.where(place, _c(best), state["vreq_from"])
    vreq_term = torch.where(place, _c(best_term), state["vreq_term"])
    vreq_lastterm = torch.where(place, _c(last_term),
                                state["vreq_lastterm"])
    vreq_lastlen = torch.where(place, _c(last_len), state["vreq_lastlen"])

    due = (vreq_t >= 0) & (vreq_t <= _c(tick)) & alive & is_voter
    req_term = vreq_term
    higher = due & (req_term > term)
    dem_higher = higher & (role == LEADER)
    term = torch.where(higher, req_term, term)
    role = torch.where(higher & ((role == LEADER) | (role == CANDIDATE)),
                       FOLLOWER, role)
    voted_for = torch.where(higher, -1, voted_for)
    my_len = state["log_len"]
    my_last = torch.gather(state["log_term"], 2,
                           (my_len - 1).clamp(0, L - 1).long()[..., None]
                           )[..., 0]
    log_ok = (vreq_lastterm > my_last) | \
        ((vreq_lastterm == my_last) & (vreq_lastlen >= my_len))
    can_grant = due & (req_term >= term) & log_ok & \
        ((voted_for == -1) | (voted_for == vreq_from))
    voted_for = torch.where(can_grant, vreq_from, voted_for)
    et = torch.where(can_grant, new_timeout, et)
    rtt_back = torch.gather(rtt, 2, vreq_from.clamp(min=0).long()[..., None]
                            )[..., 0]
    grant_t = torch.where(can_grant, _c(tick) + rtt_back, state["grant_t"])
    grant_to = torch.where(can_grant, vreq_from, state["grant_to"])
    grant_term = torch.where(can_grant, req_term, state["grant_term"])
    vreq_t = torch.where(due, -1, vreq_t)

    g_due = (grant_t >= 0) & (grant_t <= _c(tick))
    tgt = grant_to.clamp(min=0)
    hit = g_due & (grant_term == _take(term, tgt))
    arrivals = _scatter_add_drop(torch.zeros_like(role0),
                                 torch.where(hit, tgt, N),
                                 torch.ones_like(role0))
    vr = torch.where(timed_out, 0, state["votes_received"])
    vr = torch.where(role == CANDIDATE, vr + arrivals, 0)
    votes = vr + 1
    win = (role == CANDIDATE) & alive & (votes >= _c(static["majority"]))
    role = torch.where(win, LEADER, role)
    grant_t = torch.where(g_due, -1, grant_t)
    max_leader_term = torch.where((role == LEADER) & alive, term,
                                  -1).max(1).values
    dem_older = (role == LEADER) & (term < _c(max_leader_term))
    role = torch.where(dem_older, FOLLOWER, role)
    any_new = _c(win.any(1))
    match_len = torch.where(any_new, 0, state["match_len"])
    sec_stop = any_new & (role == SECRETARY) & alive
    role = torch.where(any_new & (role == SECRETARY), DEAD, role)
    alive = alive & ~(any_new & (role0 == SECRETARY))
    heartbeat_timer = torch.where(win, 0, state["heartbeat_timer"])

    state = dict(state, alive=alive, term=_i32(term), role=_i32(role),
                 voted_for=_i32(voted_for), votes_received=_i32(vr),
                 election_timer=_i32(et), vreq_t=_i32(vreq_t),
                 vreq_from=_i32(vreq_from), vreq_term=_i32(vreq_term),
                 vreq_lastterm=_i32(vreq_lastterm),
                 vreq_lastlen=_i32(vreq_lastlen), grant_t=_i32(grant_t),
                 grant_to=_i32(grant_to), grant_term=_i32(grant_term),
                 match_len=_i32(match_len),
                 heartbeat_timer=_i32(heartbeat_timer))
    rec = trace_ring.record
    state = rec(state, cfg_c, trace_ring.EV_CANDIDACY, valid=timed_out,
                node=ids, term=term, counter="elections_started")
    state = rec(state, cfg_c, trace_ring.EV_GRANT, valid=can_grant,
                node=ids, term=req_term, aux=vreq_from,
                counter="votes_granted")
    state = rec(state, cfg_c, trace_ring.EV_ELECT, valid=win, node=ids,
                term=term, aux=votes, counter="leader_elected")
    state = rec(state, cfg_c, trace_ring.EV_STEPDOWN,
                valid=dem_higher | dem_older, node=ids, term=term,
                counter="leader_stepdowns")
    return rec(state, cfg_c, trace_ring.EV_SEC_STOP, valid=sec_stop,
               node=ids, term=term, counter="sec_stops")


def leader_step(state, static, cfg_c, draws):
    """Each member's leader accepts queued writes into its log
    (capacity- and space-bounded) and ships budgeted AppendEntries
    batches through the `leader_fanout` kernel (DESIGN.md §8)."""
    B, N, L = state["log_term"].shape
    K = state["kv"].shape[2]
    lid = leader_id(state)
    has_leader = lid >= 0
    lid_c = lid.clamp(min=0)
    tick = state["tick"]
    if static["work_capacity"] >= N_WINDOW:
        raise ValueError(f"leader_step accepts at most {N_WINDOW - 1} "
                         f"writes a tick")

    start = _at(state["log_len"], lid_c)
    space = L - start
    n_accept = torch.where(
        has_leader, torch.minimum(state["write_pending"].clamp(
            max=static["work_capacity"]), space), 0)
    j = _ids(N_WINDOW, start)
    idxs = _c(start) + j
    take = j < _c(n_accept)
    keys_zipf = torch.searchsorted(cfg_c["key_cdf"], draws["zipf_u"])
    keys_zipf = _i32(keys_zipf.clamp(0, K - 1))
    keys = torch.where(_c(cfg_c["key_zipf"]), keys_zipf,
                       draws["keys_uniform"])
    vals = draws["vals"]
    # JAX scatters the N_WINDOW-slot window with untaken slots clamped to
    # L-1 and applies duplicate updates in order, so the trailing untaken
    # slots restore position L-1's old value: a write accepted at L-1
    # never lands.  `put` reproduces that; untaken lanes rewrite L-1 with
    # its own value, so their duplicate order cannot matter.  The flat
    # index carries each member's b*N*L offset.
    put = take & (idxs < L - 1)
    pos = torch.where(put, idxs, L - 1)
    members = torch.arange(B, device=lid.device)[:, None]
    flat_idx = ((members * N + _c(lid_c)) * L + pos).long().reshape(-1)
    last = torch.full_like(lid_c, L - 1)

    def row_put(mat, new):
        old_last = _at2(mat, lid_c, last)
        out = mat.clone()
        out.view(-1).index_put_(
            (flat_idx,), _i32(torch.where(put, new, _c(old_last))).reshape(-1))
        return out

    lterm = _at(state["term"], lid_c)
    log_term = row_put(state["log_term"], _c(lterm).expand(B, N_WINDOW))
    log_key = row_put(state["log_key"], keys)
    log_val = row_put(state["log_val"], vals)
    sub = state["entry_submit_t"]
    entry_submit = sub.clone()
    entry_submit.view(-1).index_put_(
        ((members * L + pos).long().reshape(-1),),
        _i32(torch.where(put & _c(has_leader), _c(tick),
                         sub[:, L - 1:L])).reshape(-1))
    new_len = torch.where(has_leader, start + n_accept, start)
    log_len = _set_at(state["log_len"], lid_c, new_len)
    state = dict(state, log_term=log_term, log_key=log_key, log_val=log_val,
                 log_len=log_len,
                 write_pending=state["write_pending"] - n_accept,
                 entry_submit_t=entry_submit)

    # Multi-Raft 2PC prepare seam (DESIGN.md §9/§14)
    n_prep = _count(take & cross_shard_mark(idxs, _c(cfg_c["cross_frac"])))
    state = trace_ring.record(
        state, cfg_c, trace_ring.EV_2PC_PREPARE, valid=n_prep > 0,
        node=lid_c, term=lterm, aux=n_prep, counter="twopc_prepared",
        count=n_prep)

    (app_arrive_t, app_from_len, app_upto, app_term, app_commit,
     work) = lf_ops.leader_fanout(
        state["role"], state["alive"], state["warn_timer"],
        state["sec_of"], state["match_len"], state["app_arrive_t"],
        state["app_from_len"], state["app_upto"], state["app_term"],
        state["app_commit"], static["rtt"], lid_c, has_leader, tick,
        _at(log_len, lid_c), lterm, _at(state["commit_len"], lid_c),
        msg_budget=static["msg_budget"], max_ship=static["max_ship"],
        entries_per_msg=static["entries_per_msg"])
    return dict(state, app_arrive_t=app_arrive_t, app_from_len=app_from_len,
                app_upto=app_upto, app_term=app_term, app_commit=app_commit,
                leader_work=_add_at(state["leader_work"], lid_c, work))


def follower_step(state, static, cfg_c):
    """Deliver due append batches through the `log_match_append` kernel
    (log-matching check, conflict truncation, window adopt), adopt the
    term, learn the commit, reset the election timer, schedule acks.  On
    CUDA the three logs are updated in place."""
    N = state["role"].shape[1]
    tick = state["tick"]
    lid = leader_id(state)
    lid_c = lid.clamp(min=0)
    rtt = static["rtt"]
    delivered = (state["app_arrive_t"] >= 0) & \
        (state["app_arrive_t"] <= _c(tick)) & state["alive"]
    due = delivered & (state["app_term"] >= state["term"]) & _c(lid >= 0)
    # the leaders' rows as separate copies (the kernel writes in place)
    ldr = [_at(state[k], lid_c) for k in ("log_term", "log_key", "log_val")]
    log_term, log_key, log_val, new_len, accept = rt_ops.log_match_append(
        state["log_term"], state["log_key"], state["log_val"], *ldr,
        state["log_len"], state["app_from_len"], state["app_upto"], due,
        w=static["max_ship"])
    nack = due & ~accept
    term = torch.where(due, torch.maximum(state["term"], state["app_term"]),
                       state["term"])
    role = _i32(torch.where(due & (state["role"] == CANDIDATE), FOLLOWER,
                            state["role"]))
    commit_len = torch.where(
        accept, torch.maximum(state["commit_len"],
                              torch.minimum(state["app_commit"], new_len)),
        state["commit_len"])
    lo, hi = cfg_c["election_timeout_min"], cfg_c["election_timeout_max"]
    jitter = (_c(tick) + _ids(N, tick) * 7) % _c(hi - lo + 1)
    election_timer = torch.where(due, _c(lo) + jitter,
                                 state["election_timer"])
    _, relay = _relay_of(state, lid_c)
    lat = torch.gather(rtt, 2, relay.long()[..., None])[..., 0] + \
        _take(_col(rtt, lid_c), relay) * (relay != _c(lid_c))
    ack_arrive_t = torch.where(accept | nack, _c(tick) + lat,
                               state["ack_arrive_t"])
    ack_upto = torch.where(accept, new_len,
                           torch.where(nack, state["app_from_len"] // 2,
                                       state["ack_upto"]))
    app_arrive_t = torch.where(delivered, -1, state["app_arrive_t"])
    return dict(state, log_term=log_term, log_key=log_key, log_val=log_val,
                log_len=new_len, term=term, role=role, commit_len=commit_len,
                election_timer=_i32(election_timer),
                ack_arrive_t=_i32(ack_arrive_t), ack_upto=_i32(ack_upto),
                app_arrive_t=_i32(app_arrive_t))


def commit_step(state, static, cfg_c):
    """Each leader ingests due acks (budgeted like the fan-out) into
    match_len and commits the majority-replicated current-term prefix
    through the `commit_majority` kernel, with its member's own
    majority; commit times carry the 2PC charge of cross-shard entries
    (DESIGN.md §9)."""
    L = state["log_term"].shape[2]
    tick = state["tick"]
    lid = leader_id(state)
    lid_c = lid.clamp(min=0)
    has_leader = lid >= 0

    ack_due = (state["ack_arrive_t"] >= 0) & \
        (state["ack_arrive_t"] <= _c(tick))
    sec_alive, _ = _relay_of(state, lid_c)
    direct_ack = ack_due & ~sec_alive
    rank = torch.cumsum(_i32(direct_ack), 1, dtype=_I32)
    ingest = (ack_due & sec_alive) | \
        (direct_ack & (rank <= static["msg_budget"]))
    m0 = state["match_len"]
    match_len = torch.where(ingest, torch.maximum(m0, state["ack_upto"]), m0)
    match_len = torch.where(ingest & (state["ack_upto"] < m0),
                            state["ack_upto"], match_len)
    ack_arrive_t = _i32(torch.where(ingest, -1, state["ack_arrive_t"]))
    match_len = _set_at(match_len, lid_c, torch.where(
        has_leader, _at(state["log_len"], lid_c), _at(match_len, lid_c)))

    lterm = _at(state["term"], lid_c)
    commit = rt_ops.commit_majority(
        match_len, static["is_voter"] & state["alive"],
        _at(state["log_term"], lid_c), lterm, static["majority"])
    c0 = _at(state["commit_len"], lid_c)
    new_commit = torch.where(has_leader, torch.maximum(c0, commit), 0)
    ar = _ids(L, c0)
    newly = (ar >= _c(c0)) & (ar < _c(new_commit)) & _c(has_leader)
    cross = cross_shard_mark(ar, _c(cfg_c["cross_frac"]))
    seen_t = _c(tick) + torch.where(cross, _c(cfg_c["two_pc_ticks"]), 0)
    entry_commit_t = _i32(torch.where(
        newly & (state["entry_commit_t"] < 0), seen_t,
        state["entry_commit_t"]))
    commit_len = _set_at(state["commit_len"], lid_c,
                         torch.where(has_leader, new_commit, c0))
    n_new = _i32(torch.where(has_leader, new_commit - c0, 0))
    state = dict(state, match_len=match_len, ack_arrive_t=ack_arrive_t,
                 commit_len=commit_len, entry_commit_t=entry_commit_t,
                 writes_committed=state["writes_committed"] + n_new)
    n_cross = _count(newly & cross)
    state = trace_ring.record(
        state, cfg_c, trace_ring.EV_COMMIT, valid=n_new > 0, node=lid_c,
        term=lterm, aux=new_commit, counter="commit_advances")
    state = trace_ring.record(
        state, cfg_c, trace_ring.EV_2PC_COMMIT, valid=n_cross > 0,
        node=lid_c, term=lterm, aux=n_cross, counter="twopc_committed",
        count=n_cross)
    return trace_metrics.bump(state, "entries_committed", n_new)


def apply_step(state, static, cfg_c):
    """Every alive node applies up to `max_apply` committed entries, in
    log order, through the `apply_last_wins` kernel (in place on CUDA),
    and folds their mixes into its rolling applied-prefix digest
    (DESIGN.md §13)."""
    L = state["log_term"].shape[2]
    A = static["max_apply"]
    base = state["applied_len"]
    todo = torch.minimum(state["commit_len"] - base,
                         torch.full_like(base, A))
    offs = torch.arange(A, dtype=_I32, device=base.device)
    idx = base[..., None] + offs
    valid = (offs < todo[..., None]) & (idx < L) & state["alive"][..., None]
    idx_c = idx.clamp(0, L - 1)
    gi = idx_c.long()
    keys = torch.gather(state["log_key"], 2, gi)
    vals = torch.gather(state["log_val"], 2, gi)
    kv = rt_ops.apply_last_wins(state["kv"], keys, vals, valid)
    contrib = torch.where(valid, entry_mix(idx_c, keys, vals), 0)
    digest = state["applied_digest"]
    for a in range(A):
        digest = digest ^ contrib[..., a]
    return dict(state, kv=kv, applied_len=base + todo.clamp(min=0),
                applied_digest=digest)


def observer_sync_step(state, static, cfg_c):
    """Followers eagerly forward to their observers (paper Fig. 5): an
    observer mirrors its follower's applied state, log and digest."""
    is_obs = (state["role"] == OBSERVER) & state["alive"]
    fol = state["obs_of"].clamp(min=0).long()
    sync = is_obs & (state["obs_of"] >= 0) & _take(state["alive"], fol)
    out = {}
    for k in ("applied_len", "commit_len", "log_len", "applied_digest"):
        out[k] = torch.where(sync, _take(state[k], fol), state[k])
    for k in ("kv", "log_term", "log_key", "log_val"):
        x = state[k]
        rows = torch.gather(x, 1, fol[..., None].expand(-1, -1, x.shape[2]))
        out[k] = torch.where(sync[..., None], rows, x)
    return dict(state, **out)


def anti_entropy_step(state, static, cfg_c):
    """The digest tier's anti-entropy round (DESIGN.md §13) through the
    `ae_sync` kernel: a due slot adopts its source's (applied, term,
    digest) monotonically and ages by the sync hop.  The due rule and
    the source are computed here too, as in the JAX phase, for the
    `ae_sync`/`ae_fallback` events and counters.  A python no-op when the
    tier has no slot."""
    if state["dobs_alive"].shape[1] == 0:
        return state
    tick = state["tick"]
    fol_ok, any_voter, eff = _ae_source(state, static)
    interval = _c(cfg_c["ae_interval"].clamp(min=1))
    due = state["dobs_alive"] & (fol_ok | _c(any_voter)) & \
        ((_c(tick) + cfg_c["ae_phase"]) % interval == 0)
    src_applied = _take(state["applied_len"], eff)
    applied, term, digest, synced = ae_ops.ae_sync(
        state["dobs_alive"], state["dobs_fol"], state["dobs_applied"],
        state["dobs_term"], state["dobs_digest"], state["dobs_synced_t"],
        cfg_c["ae_phase"], static["dobs_site"], state["alive"],
        static["is_voter"], state["applied_len"], state["term"],
        state["applied_digest"], static["site"], static["site_rtt"], tick,
        cfg_c["ae_interval"])
    state = dict(state, dobs_applied=applied, dobs_term=term,
                 dobs_digest=digest, dobs_synced_t=synced)
    o_ids = _ids(due.shape[1], due)
    state = trace_ring.record(
        state, cfg_c, trace_ring.EV_AE_SYNC, valid=due, node=o_ids,
        term=eff, aux=src_applied, counter="ae_rounds")
    return trace_ring.record(
        state, cfg_c, trace_ring.EV_AE_FALLBACK, valid=due & ~fol_ok,
        node=o_ids, term=eff, aux=src_applied, counter="ae_fallbacks")


def read_step(state, static, cfg_c):
    """Serve queued reads through the read-index round (DESIGN.md §11):
    observers serve when applied >= the leader's commit, else reroute to
    their follower; latency = queue wait + the read-index fence, sampled
    per request into the unit-bin `read_lat_hist`.  Digest-tier slots
    serve under the staleness bound, without a per-read fence, and
    reroute to their source voter when behind it (DESIGN.md §13).
    Returns `(state, (served, lat, obs_served, obs_stale))` like the JAX
    phase."""
    N = state["role"].shape[1]
    tick = state["tick"]
    lid_c = leader_id(state).clamp(min=0)
    rtt = static["rtt"]
    cap = static["work_capacity"]
    role, alive = state["role"], state["alive"]
    is_obs = (role == OBSERVER) & alive
    is_srv = ((role == FOLLOWER) | (role == LEADER)) & alive
    fresh = state["applied_len"] >= _c(_at(state["commit_len"], lid_c))
    can_serve = (is_obs & fresh) | is_srv
    q0 = state["read_queue"]
    served = torch.where(can_serve, q0.clamp(max=cap), 0)
    fol = state["obs_of"].clamp(min=0)
    stale_obs = is_obs & ~fresh
    reroute = torch.where(stale_obs, q0, 0)
    read_queue = (q0 - served - reroute).scatter_add(1, fol.long(), reroute)

    any_sec = ((role == SECRETARY) & alive).any(1)
    to_lid = _col(rtt, lid_c)
    ri_rtt = to_lid * _c(torch.where(any_sec, 1, 2))
    lat = _i32(q0 // max(cap, 1) + 1 + torch.where(is_obs, ri_rtt, to_lid))
    hit = served > 0
    latf = lat.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=lat.device)
    lat_sum = torch.where(hit, latf * served, zero).sum(1)
    lat_max = torch.where(hit, latf, zero).max(1).values
    H = state["read_lat_hist"].shape[1]
    read_hist = _scatter_add_drop(
        state["read_lat_hist"], torch.where(hit, lat.clamp(0, H - 1), H),
        served)
    total_served = _count(served)
    extra = {}
    O = state["dobs_alive"].shape[1]
    obs_served = obs_stale = torch.zeros((lat.shape[0], O), dtype=_I32,
                                         device=lat.device)
    if O:
        q = state["dobs_read_queue"]
        stale = _c(tick) - state["dobs_synced_t"]
        can_d = state["dobs_alive"] & \
            (stale <= _c(cfg_c["staleness_bound"]))
        obs_served = torch.where(can_d, q.clamp(max=cap), 0)
        reroute_d = torch.where(~can_d, q, 0)
        _, _, eff = _ae_source(state, static)
        read_queue = _scatter_add_drop(
            read_queue, torch.where(reroute_d > 0, eff, N), reroute_d)
        lat_d = q // max(cap, 1) + 1
        hit_d = obs_served > 0
        lat_df = lat_d.to(torch.float32)
        lat_sum = lat_sum + torch.where(hit_d, lat_df * obs_served,
                                        zero).sum(1)
        lat_max = torch.maximum(lat_max,
                                torch.where(hit_d, lat_df, zero).max(1).values)
        read_hist = _scatter_add_drop(
            read_hist, torch.where(hit_d, lat_d.clamp(0, H - 1), H),
            obs_served)
        obs_stale = _i32(torch.where(hit_d, stale, 0))
        extra = dict(
            dobs_read_queue=_i32(q - obs_served - reroute_d),
            obs_stale_hist=_scatter_add_drop(
                state["obs_stale_hist"],
                torch.where(hit_d, stale.clamp(0, H - 1), H), obs_served),
            obs_reads_served=state["obs_reads_served"] + _count(obs_served),
            obs_rerouted=state["obs_rerouted"] + _count(reroute_d))
        total_served = total_served + _count(obs_served)
    state = dict(state, **extra, read_queue=_i32(read_queue),
                 reads_served=state["reads_served"] + total_served,
                 read_lat_sum=state["read_lat_sum"] + lat_sum,
                 read_lat_max=torch.maximum(state["read_lat_max"], lat_max),
                 read_lat_hist=read_hist)
    return state, (_i32(served), lat, _i32(obs_served), obs_stale)


def cost_step(state, static, cfg_c):
    """Accrue $ cost: on-demand voters + alive spot nodes (eq. 1), plus
    the linear network term in the number of alive instances.  Digest
    slots bill as spot instances at their site's price (DESIGN.md §13)."""
    site = static["site"]
    is_voter = static["is_voter"]
    alive = state["alive"]
    zero = torch.zeros((), dtype=torch.float32, device=alive.device)
    spot_sum = torch.where(~is_voter & alive,
                           _take(state["spot_price"], site), zero).sum(1)
    n_alive = _count(alive)
    if state["dobs_alive"].shape[1]:
        d_price = _take(state["spot_price"], static["dobs_site"])
        spot_sum = spot_sum + torch.where(state["dobs_alive"], d_price,
                                          zero).sum(1)
        n_alive = n_alive + _count(state["dobs_alive"])
    per_tick = torch.where(is_voter & alive,
                           _take(cfg_c["on_demand_price"], site),
                           zero).sum(1) + spot_sum
    per_tick = per_tick / cfg_c["ticks_per_hour"]
    per_tick = per_tick * (1.0 + cfg_c["network_cost_coef"] * n_alive)
    return dict(state, cost_accrued=state["cost_accrued"] + per_tick)


def tick(state, static, cfg_c, draws) -> Tuple[Dict, Dict]:
    """One full protocol tick of every member, given this tick's
    (B, ...) row of the draw bundle.  Returns (state, per-tick metrics)
    with the JAX tick's metric names, each with the leading member
    axis."""
    state, killed = spot_step(state, static, cfg_c, draws)
    state = workload_step(state, static, cfg_c, draws)
    state = election_step(state, static, cfg_c, draws)
    state = leader_step(state, static, cfg_c, draws)
    state = follower_step(state, static, cfg_c)
    state = commit_step(state, static, cfg_c)
    state = apply_step(state, static, cfg_c)
    state = observer_sync_step(state, static, cfg_c)
    state = anti_entropy_step(state, static, cfg_c)
    state, (read_served, read_lat, obs_served, obs_stale) = \
        read_step(state, static, cfg_c)
    state = cost_step(state, static, cfg_c)
    state = dict(state, tick=state["tick"] + 1)

    lid = leader_id(state)
    role, alive = state["role"], state["alive"]
    metrics = {
        "has_leader": _i32(lid >= 0),
        "leader_term": _i32(torch.where(
            lid >= 0, _at(state["term"], lid.clamp(min=0)), -1)),
        "n_leaders": _count((role == LEADER) & alive),
        "n_secretaries": _count((role == SECRETARY) & alive),
        "n_observers": _count((role == OBSERVER) & alive),
        "commit_len": state["commit_len"].max(1).values,
        "write_queue": state["write_pending"],
        "read_queue": _count(state["read_queue"]),
        "killed": _count(killed),
        "cost": state["cost_accrued"],
        "read_served_tick": read_served,
        "read_lat_tick": read_lat,
        "obs_served_tick": obs_served,
        "obs_stale_tick": obs_stale,
        "n_obs_digest": _count(state["dobs_alive"]),
    }
    return state, metrics
