"""One BW-Raft protocol tick on tensors (PyTorch port of
`repro.core.step`, its fast non-reference forms).

Phases in tick order: spot market, client arrivals, elections, the
leader's accept and fan-out, follower log-matching, the commit, the
apply, observer mirroring, reads, cost (DESIGN.md §2, §6).  Every rule is
masked tensor math on the state dict.  Four hot ops go through the
kernel families (DESIGN.md §8): `leader_fanout` in `leader_step`, and
the `raft_tick` trio in `follower_step`, `commit_step` and
`apply_step`; on CUDA tensors they launch the hand-written kernels.

Differences from the JAX tick, all of form and none of result:

* randomness comes in as one row of the epoch's draw bundle
  (`core/draws.py`) instead of a PRNG key — every draw of the tick
  depends only on the key schedule, `cfg_c` and the tick number;
* the tick never reads a tensor on the host (no `.item()`, no Python
  branch on a value): scalars stay 0-d device tensors and gathers at the
  leader go through `index_select`;
* `static` is `state.from_numpy(build_static(...))`: its tables are
  tensors on the state's device, its sizes python ints;
* the digest tier (`n_observers > 0`, DESIGN.md §13) is not ported yet.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.draws import N_WINDOW
from repro_torch.core.state import (CANDIDATE, DEAD, FOLLOWER, LEADER,
                                    OBSERVER, SECRETARY, entry_mix,
                                    leader_id)
from repro_torch.kernels.leader_fanout import ops as lf_ops
from repro_torch.kernels.raft_tick import ops as rt_ops
from repro_torch.trace import metrics as trace_metrics
from repro_torch.trace import ring as trace_ring

_I32 = torch.int32
DIGEST_TIER_TODO = ("the digest-tier observers (n_observers > 0) are not "
                    "ported yet: ROADMAP.md, 'Modules to port', the "
                    "digest-tier slice with the ae_sync kernel")


# --------------------------------------------------------------------- #
# small sync-free helpers
# --------------------------------------------------------------------- #
def _i32(x) -> torch.Tensor:
    return x.to(_I32)


def _count(mask) -> torch.Tensor:
    return mask.sum(dtype=_I32)


def _at(vec, i) -> torch.Tensor:
    """vec[i] for a 0-d index tensor, as a 0-d tensor (row for 2-D)."""
    return vec.index_select(0, i.reshape(1))[0]


def _at2(mat, i, j) -> torch.Tensor:
    """mat[i, j] for 0-d index tensors."""
    return _at(mat.reshape(-1), i * mat.shape[1] + j)


def _col(mat, j) -> torch.Tensor:
    """mat[:, j] for a 0-d index tensor."""
    return mat.index_select(1, j.reshape(1))[:, 0]


def _set_at(vec, i, val) -> torch.Tensor:
    """A copy of vec with vec[i] = val (0-d index and value tensors)."""
    return vec.index_copy(0, i.reshape(1).long(),
                          val.reshape(1).to(vec.dtype))


def _add_at(vec, i, amt) -> torch.Tensor:
    """A copy of vec with amt added at vec[i] (0-d index tensor)."""
    return vec.index_add(0, i.reshape(1), amt.reshape(1).to(vec.dtype))


def _scatter_add_drop(vec, idx, src) -> torch.Tensor:
    """vec.at[idx].add(src, mode="drop") for idx in [0, len(vec)]: lanes
    at idx == len(vec) land in a spare slot that is cut off."""
    n = vec.shape[0]
    ext = torch.cat([vec, vec.new_zeros((1,))])
    return ext.index_add(0, idx, src.to(vec.dtype))[:n]


def _arange(n, like) -> torch.Tensor:
    return torch.arange(n, dtype=_I32, device=like.device)


def _relay_of(state, lid_c) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sec_alive, relay): a follower's batch goes via its secretary iff
    that node is an alive, unwarned SECRETARY (DESIGN.md §12), else
    directly from the leader."""
    sec = state["sec_of"]
    secc = sec.clamp(min=0)
    sec_alive = (sec >= 0) & state["alive"][secc] & \
        (state["role"][secc] == SECRETARY) & (state["warn_timer"][secc] < 0)
    return sec_alive, torch.where(sec_alive, sec, lid_c)


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
    i.i.d. `phi` kills follow the JAX rules exactly."""
    use_trace = cfg_c["market_trace"]
    t = state["tick"] % cfg_c["trace_len"]
    price = torch.where(use_trace, _col(cfg_c["price_trace"], t),
                        draws["price"])
    over_bid = price > cfg_c["spot_bid"]
    revoked_site = torch.where(use_trace & ~cfg_c["bid_on_trace"],
                               _col(cfg_c["revoke_trace"], t), over_bid)
    site = static["site"]
    is_spot = ~static["is_voter"]
    market_sig = torch.where(cfg_c["node_trace"] & use_trace,
                             _col(cfg_c["revoke_node_trace"], t),
                             revoked_site[site])
    tf = state["tick"] % cfg_c["fault_len"]
    fault_sig = cfg_c["fault_on"] & _col(cfg_c["fault_trace"], tf)
    alive0 = state["alive"]
    sig = alive0 & ((is_spot & market_sig) | fault_sig)

    timer0 = state["warn_timer"]
    newly = sig & (timer0 < 0)
    timer = torch.where(sig, torch.where(newly, cfg_c["warn_ticks"],
                                         (timer0 - 1).clamp(min=0)), -1)
    due = sig & (timer <= 0)
    iid_fail = draws["fail_u"] < cfg_c["phi"]
    killed = alive0 & (due | (is_spot & iid_fail))
    timer = _i32(torch.where(killed, -1, timer))

    prev_role = state["role"]
    reprieve = (timer0 >= 0) & ~sig & alive0
    warn_live = cfg_c["warn_ticks"] > 0
    state = dict(state, spot_price=price, alive=alive0 & ~killed,
                 role=_i32(torch.where(killed, DEAD, prev_role)),
                 warn_timer=timer)

    nid = _arange(killed.shape[0], killed)
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
    return state, killed


def workload_step(state, static, cfg_c, draws):
    """Client arrivals: writes to the leader's queue, reads spread over
    alive unwarned observers (up to 90%, capacity-bounded) and the rest
    over followers; the cross-shard split is deterministic (§9)."""
    n_writes, n_reads = draws["n_writes"], draws["n_reads"]
    chi = cfg_c["cross_frac"]
    wa = state["writes_arrived"]
    n_cross = _i32(torch.floor((wa + n_writes).to(torch.float32) * chi) -
                   torch.floor(wa.to(torch.float32) * chi))
    role, alive = state["role"], state["alive"]
    is_obs = (role == OBSERVER) & alive & (state["warn_timer"] < 0)
    is_fol = ((role == FOLLOWER) | (role == LEADER)) & alive
    pool = _count(is_obs)
    n_fol = _count(is_fol).clamp(min=1)
    cap = static["work_capacity"]
    obs_share = torch.where(pool > 0,
                            torch.minimum((n_reads * 9) // 10, pool * cap), 0)
    fol_share = n_reads - obs_share
    per_obs = torch.where(is_obs, obs_share // pool.clamp(min=1), 0)
    per_fol = torch.where(is_fol, fol_share // n_fol, 0)
    return dict(state,
                read_queue=_i32(state["read_queue"] + per_obs + per_fol),
                write_pending=state["write_pending"] + n_writes,
                reads_arrived=state["reads_arrived"] + n_reads,
                writes_arrived=wa + n_writes,
                cross_arrived=state["cross_arrived"] + n_cross)


def election_step(state, static, cfg_c, draws):
    """Timeouts -> candidacy; RequestVote with the log-up-to-date
    restriction; a majority of voters -> leader (Property 3.1); a new
    leader stops the secretaries (paper Step 1)."""
    N = state["role"].shape[0]
    L = state["log_term"].shape[1]
    tick = state["tick"]
    rtt = static["rtt"]
    is_voter = static["is_voter"]
    alive = state["alive"]
    role0 = state["role"]
    ids = _arange(N, tick)

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
    best = _i32(torch.argmax(cand_term))
    have_cand = cand_term.max() >= 0
    last_len = _at(state["log_len"], best)
    last_term = _at2(state["log_term"], best, (last_len - 1).clamp(0, L - 1))
    best_term = _at(term, best)
    place = have_cand & is_voter & (best_term > state["vreq_term"]) & alive
    vreq_t = torch.where(place, tick + _at(rtt, best), state["vreq_t"])
    vreq_from = torch.where(place, best, state["vreq_from"])
    vreq_term = torch.where(place, best_term, state["vreq_term"])
    vreq_lastterm = torch.where(place, last_term, state["vreq_lastterm"])
    vreq_lastlen = torch.where(place, last_len, state["vreq_lastlen"])

    due = (vreq_t >= 0) & (vreq_t <= tick) & alive & is_voter
    req_term = vreq_term
    higher = due & (req_term > term)
    dem_higher = higher & (role == LEADER)
    term = torch.where(higher, req_term, term)
    role = torch.where(higher & ((role == LEADER) | (role == CANDIDATE)),
                       FOLLOWER, role)
    voted_for = torch.where(higher, -1, voted_for)
    my_len = state["log_len"]
    my_last = torch.gather(state["log_term"], 1,
                           (my_len - 1).clamp(0, L - 1).long()[:, None])[:, 0]
    log_ok = (vreq_lastterm > my_last) | \
        ((vreq_lastterm == my_last) & (vreq_lastlen >= my_len))
    can_grant = due & (req_term >= term) & log_ok & \
        ((voted_for == -1) | (voted_for == vreq_from))
    voted_for = torch.where(can_grant, vreq_from, voted_for)
    et = torch.where(can_grant, new_timeout, et)
    grant_t = torch.where(can_grant,
                          tick + rtt[ids, vreq_from.clamp(min=0)],
                          state["grant_t"])
    grant_to = torch.where(can_grant, vreq_from, state["grant_to"])
    grant_term = torch.where(can_grant, req_term, state["grant_term"])
    vreq_t = torch.where(due, -1, vreq_t)

    g_due = (grant_t >= 0) & (grant_t <= tick)
    tgt = grant_to.clamp(min=0)
    hit = g_due & (grant_term == term[tgt])
    arrivals = _scatter_add_drop(torch.zeros_like(ids),
                                 torch.where(hit, tgt, N),
                                 torch.ones_like(ids))
    vr = torch.where(timed_out, 0, state["votes_received"])
    vr = torch.where(role == CANDIDATE, vr + arrivals, 0)
    votes = vr + 1
    win = (role == CANDIDATE) & alive & (votes >= static["majority"])
    role = torch.where(win, LEADER, role)
    grant_t = torch.where(g_due, -1, grant_t)
    max_leader_term = torch.where((role == LEADER) & alive, term, -1).max()
    dem_older = (role == LEADER) & (term < max_leader_term)
    role = torch.where(dem_older, FOLLOWER, role)
    any_new = win.any()
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
    """The leader accepts queued writes into its log (capacity- and
    space-bounded) and ships budgeted AppendEntries batches through the
    `leader_fanout` kernel (DESIGN.md §8)."""
    L = state["log_term"].shape[1]
    K = state["kv"].shape[1]
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
    j = _arange(N_WINDOW, start)
    idxs = start + j
    take = j < n_accept
    keys_zipf = torch.searchsorted(cfg_c["key_cdf"], draws["zipf_u"])
    keys_zipf = _i32(keys_zipf.clamp(0, K - 1))
    keys = torch.where(cfg_c["key_zipf"], keys_zipf, draws["keys_uniform"])
    vals = draws["vals"]
    # JAX scatters the N_WINDOW-slot window with untaken slots clamped to
    # L-1 and applies duplicate updates in order, so the trailing untaken
    # slots restore position L-1's old value: a write accepted at L-1
    # never lands.  `put` reproduces that; untaken lanes rewrite L-1 with
    # its own value, so their duplicate order cannot matter.
    put = take & (idxs < L - 1)
    last = torch.full_like(idxs, L - 1)
    flat_idx = (lid_c * L + torch.where(put, idxs, last)).long()

    def row_put(mat, new):
        old_last = _at2(mat, lid_c, last[0])
        out = mat.clone()
        out.view(-1).index_put_((flat_idx,),
                                _i32(torch.where(put, new, old_last)))
        return out

    lterm = _at(state["term"], lid_c)
    log_term = row_put(state["log_term"], lterm.expand(N_WINDOW))
    log_key = row_put(state["log_key"], keys)
    log_val = row_put(state["log_val"], vals)
    sub = state["entry_submit_t"]
    entry_submit = sub.clone()
    entry_submit.index_put_(
        (torch.where(put, idxs, last).long(),),
        _i32(torch.where(put & has_leader, tick, sub[L - 1])))
    new_len = torch.where(has_leader, start + n_accept, start)
    log_len = _set_at(state["log_len"], lid_c, new_len)
    state = dict(state, log_term=log_term, log_key=log_key, log_val=log_val,
                 log_len=log_len,
                 write_pending=state["write_pending"] - n_accept,
                 entry_submit_t=entry_submit)

    # Multi-Raft 2PC prepare seam (DESIGN.md §9/§14)
    n_prep = _count(take & cross_shard_mark(idxs, cfg_c["cross_frac"]))
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
    N = state["role"].shape[0]
    tick = state["tick"]
    lid = leader_id(state)
    lid_c = lid.clamp(min=0)
    rtt = static["rtt"]
    delivered = (state["app_arrive_t"] >= 0) & \
        (state["app_arrive_t"] <= tick) & state["alive"]
    due = delivered & (state["app_term"] >= state["term"]) & (lid >= 0)
    # the leader's rows as separate copies (the kernel writes in place)
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
    ids = _arange(N, tick)
    jitter = (tick + ids * 7) % (hi - lo + 1)
    election_timer = torch.where(due, lo + jitter, state["election_timer"])
    _, relay = _relay_of(state, lid_c)
    lat = rtt[ids, relay] + _col(rtt, lid_c)[relay] * (relay != lid_c)
    ack_arrive_t = torch.where(accept | nack, tick + lat,
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
    """The leader ingests due acks (budgeted like the fan-out) into
    match_len and commits the majority-replicated current-term prefix
    through the `commit_majority` kernel; commit times carry the 2PC
    charge of cross-shard entries (DESIGN.md §9)."""
    L = state["log_term"].shape[1]
    tick = state["tick"]
    lid = leader_id(state)
    lid_c = lid.clamp(min=0)
    has_leader = lid >= 0

    ack_due = (state["ack_arrive_t"] >= 0) & (state["ack_arrive_t"] <= tick)
    sec_alive, _ = _relay_of(state, lid_c)
    direct_ack = ack_due & ~sec_alive
    rank = torch.cumsum(_i32(direct_ack), 0, dtype=_I32)
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
    ar = _arange(L, c0)
    newly = (ar >= c0) & (ar < new_commit) & has_leader
    cross = cross_shard_mark(ar, cfg_c["cross_frac"])
    seen_t = tick + torch.where(cross, cfg_c["two_pc_ticks"], 0)
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
    L = state["log_term"].shape[1]
    A = static["max_apply"]
    base = state["applied_len"]
    todo = torch.minimum(state["commit_len"] - base,
                         torch.full_like(base, A))
    offs = _arange(A, base)[None, :]
    idx = base[:, None] + offs
    valid = (offs < todo[:, None]) & (idx < L) & state["alive"][:, None]
    idx_c = idx.clamp(0, L - 1)
    gi = idx_c.long()
    keys = torch.gather(state["log_key"], 1, gi)
    vals = torch.gather(state["log_val"], 1, gi)
    kv = rt_ops.apply_last_wins(state["kv"], keys, vals, valid)
    contrib = torch.where(valid, entry_mix(idx_c, keys, vals), 0)
    digest = state["applied_digest"]
    for a in range(A):
        digest = digest ^ contrib[:, a]
    return dict(state, kv=kv, applied_len=base + todo.clamp(min=0),
                applied_digest=digest)


def observer_sync_step(state, static, cfg_c):
    """Followers eagerly forward to their observers (paper Fig. 5): an
    observer mirrors its follower's applied state, log and digest."""
    is_obs = (state["role"] == OBSERVER) & state["alive"]
    fol = state["obs_of"].clamp(min=0)
    sync = is_obs & (state["obs_of"] >= 0) & state["alive"][fol]
    out = {}
    for k in ("applied_len", "commit_len", "log_len", "applied_digest"):
        out[k] = torch.where(sync, state[k][fol], state[k])
    for k in ("kv", "log_term", "log_key", "log_val"):
        out[k] = torch.where(sync[:, None], state[k][fol], state[k])
    return dict(state, **out)


def read_step(state, static, cfg_c):
    """Serve queued reads through the read-index round (DESIGN.md §11):
    observers serve when applied >= the leader's commit, else reroute to
    their follower; latency = queue wait + the read-index fence, sampled
    per request into the unit-bin `read_lat_hist`.  Returns `(state,
    (served, lat, obs_served, obs_stale))` like the JAX phase."""
    N = state["role"].shape[0]
    tick = state["tick"]
    lid_c = leader_id(state).clamp(min=0)
    rtt = static["rtt"]
    cap = static["work_capacity"]
    role, alive = state["role"], state["alive"]
    is_obs = (role == OBSERVER) & alive
    is_srv = ((role == FOLLOWER) | (role == LEADER)) & alive
    fresh = state["applied_len"] >= _at(state["commit_len"], lid_c)
    can_serve = (is_obs & fresh) | is_srv
    q0 = state["read_queue"]
    served = torch.where(can_serve, q0.clamp(max=cap), 0)
    fol = state["obs_of"].clamp(min=0)
    stale_obs = is_obs & ~fresh
    reroute = torch.where(stale_obs, q0, 0)
    read_queue = (q0 - served - reroute).index_add(0, fol, reroute)

    any_sec = ((role == SECRETARY) & alive).any()
    to_lid = _col(rtt, lid_c)
    ri_rtt = to_lid * torch.where(any_sec, 1, 2)
    lat = _i32(q0 // max(cap, 1) + 1 + torch.where(is_obs, ri_rtt, to_lid))
    hit = served > 0
    latf = lat.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=lat.device)
    lat_sum = torch.where(hit, latf * served, zero).sum()
    lat_max = torch.where(hit, latf, zero).max()
    H = state["read_lat_hist"].shape[0]
    read_hist = _scatter_add_drop(
        state["read_lat_hist"], torch.where(hit, lat.clamp(0, H - 1), H),
        served)
    empty = torch.zeros((0,), dtype=_I32, device=lat.device)
    state = dict(state, read_queue=_i32(read_queue),
                 reads_served=state["reads_served"] + _count(served),
                 read_lat_sum=state["read_lat_sum"] + lat_sum,
                 read_lat_max=torch.maximum(state["read_lat_max"], lat_max),
                 read_lat_hist=read_hist)
    return state, (_i32(served), lat, empty, empty)


def cost_step(state, static, cfg_c):
    """Accrue $ cost: on-demand voters + alive spot nodes (eq. 1), plus
    the linear network term in the number of alive instances."""
    site = static["site"]
    is_voter = static["is_voter"]
    alive = state["alive"]
    zero = torch.zeros((), dtype=torch.float32, device=alive.device)
    spot_sum = torch.where(~is_voter & alive, state["spot_price"][site],
                           zero).sum()
    n_alive = _count(alive)
    per_tick = torch.where(is_voter & alive, cfg_c["on_demand_price"][site],
                           zero).sum() + spot_sum
    per_tick = per_tick / cfg_c["ticks_per_hour"]
    per_tick = per_tick * (1.0 + cfg_c["network_cost_coef"] * n_alive)
    return dict(state, cost_accrued=state["cost_accrued"] + per_tick)


def tick(state, static, cfg_c, draws) -> Tuple[Dict, Dict]:
    """One full protocol tick given this tick's row of the draw bundle.
    Returns (state, per-tick metrics) with the JAX tick's metric names."""
    if state["dobs_alive"].shape[0]:
        raise NotImplementedError(DIGEST_TIER_TODO)
    state, killed = spot_step(state, static, cfg_c, draws)
    state = workload_step(state, static, cfg_c, draws)
    state = election_step(state, static, cfg_c, draws)
    state = leader_step(state, static, cfg_c, draws)
    state = follower_step(state, static, cfg_c)
    state = commit_step(state, static, cfg_c)
    state = apply_step(state, static, cfg_c)
    state = observer_sync_step(state, static, cfg_c)
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
        "commit_len": state["commit_len"].max(),
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
