"""BW-Raft runtime on PyTorch: T-tick epochs + the host control plane
(port of `repro.core.runtime`, the solo managed and `prelease` paths).

One epoch = `cfg.period_ticks` ticks (DESIGN.md §2), after which the
control plane runs: collect stats ("peek", Algorithm 1), score the
spot-offer pool and select instances (MCSA, "peak"), lease them into dead
spot slots, wire secretaries/observers (DESIGN.md §6.2).  The epoch loop
keeps the JAX contract of DESIGN.md §7.1: per-tick metrics are reduced
on the device as the ticks run, the log is compacted on the device, and
only the few-KB digest crosses to the host, once per epoch.

`host_epoch` and `build_report` are the frozen host path of
`FleetSim(pipeline="host")` (DESIGN.md §7.1): reference ticks with the
per-tick metrics stacked, the report built on the host from the full
state.

The epoch's randomness is one draw bundle made before its first tick
(`core/draws.py`); the tick loop never reads a tensor on the host, so it
can later be captured as a CUDA graph.  `device_epoch` runs on trees
with a leading member axis B: `BWRaftSim` runs it at B = 1 and
`core/fleet.FleetSim` at the fleet's B, through the same tick.

The host services ride in `cfg_c` as data: a market trace
(`market="trace"`, DESIGN.md §10), an open-loop plan and Zipfian keys
(§11), a fault schedule and per-epoch bid policies (§12).  A
trace-calibrated `predictor` seeds the control plane.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import manager as mgr
from repro_torch.core import mcsa
from repro_torch.core import state as state_mod
from repro_torch.core import step as step_mod
from repro_torch.core.cluster_config import ClusterConfig
from repro_torch.core.draws import TorchDraws, row
from repro_torch.core.state import (DEAD, FOLLOWER, HIST_TAIL, LEADER,
                                    OBSERVER, SECRETARY)
from repro_torch.trace import export as trace_export
from repro_torch.trace import metrics as trace_metrics
from repro_torch.trace import ring as trace_ring
from repro_torch.workload.arrivals import uniform_key_cdf


def make_cfg_arrays(cfg: ClusterConfig, device, *, write_rate: float,
                    read_rate: float, phi: float = 0.0,
                    pad_nodes: int = 0, pad_sites: int = 0,
                    pad_keys: int = 0,
                    spot_price_vol: Optional[float] = None,
                    cross_shard_frac: float = 0.0, two_pc_ticks: int = 0,
                    market: str = "process",
                    trace=None, trace_ticks: Optional[int] = None,
                    arrivals=None, arrival_ticks: Optional[int] = None,
                    keypop=None,
                    warning_ticks: int = 0, spot_bid=None,
                    bid_on_trace: bool = False,
                    faults=None, fault_ticks: Optional[int] = None,
                    n_observers: int = 0, pad_observers: int = 0,
                    staleness_bound: int = 16, ae_interval: int = 4,
                    ae_phase=None, trace_on: bool = False,
                    trace_mask=None) -> Dict[str, torch.Tensor]:
    """The per-epoch knobs as tensors on `device`, equal leaf for leaf to
    `repro.core.runtime.make_cfg_arrays`.  Every knob is data: swapping
    a trace, a plan, a schedule or a bid changes leaves, never the
    tick's code.

    `market="trace"` replays `trace` (a `market.MarketTrace`), fitted to
    the padded sites and widened to a shared `trace_ticks` (time wrap);
    the in-step lookup wraps at the member's own `trace_len`.  A trace
    with per-node columns enters as `revoke_node_trace` (DESIGN.md §10,
    §12).  `arrivals` (a `workload.OpenLoop`) enters as the
    `write_curve`/`read_curve` arrays, widened to `arrival_ticks`;
    `keypop` (a `workload.ZipfianKeys`) as the (K,) `key_cdf`
    (DESIGN.md §11).  `faults` (a `market.chaos.FaultSchedule`) enters
    as the (N, Tf) `fault_trace`, widened to `fault_ticks` with inert
    False padding (DESIGN.md §12).  Members without one of these carry
    the inert leaf at the shared width, so mixed fleets stack.

    The digest tier (DESIGN.md §13): `staleness_bound` is the read
    freshness contract in ticks, `ae_interval` the anti-entropy period,
    and `ae_phase` the (O,) per-slot phase, O = n_observers +
    pad_observers; by default slot o syncs at phase o."""
    if not 0.0 <= cross_shard_frac <= 1.0:
        raise ValueError(f"cross_shard_frac={cross_shard_frac}")
    if not 0 <= two_pc_ticks <= HIST_TAIL:
        raise ValueError(f"two_pc_ticks={two_pc_ticks} exceeds the "
                         f"histogram tail (HIST_TAIL={HIST_TAIL})")
    if not 0 <= staleness_bound <= cfg.period_ticks + HIST_TAIL:
        raise ValueError(f"staleness_bound={staleness_bound}")
    if ae_interval < 1:
        raise ValueError(f"ae_interval={ae_interval}")
    O = n_observers + pad_observers
    if ae_phase is None:
        phase = np.arange(O, dtype=np.int32)
    else:
        phase = np.asarray(ae_phase, np.int32).reshape(-1)
        if phase.size != O:
            raise ValueError(f"ae_phase has {phase.size} slots, not {O}")
    if market not in ("process", "trace"):
        raise ValueError(f"market={market!r}")
    if market == "trace" and trace is None:
        raise ValueError("market='trace' needs a market.MarketTrace (see "
                         "market.load / market/synthetic.py providers)")
    S = cfg.num_sites + pad_sites
    N = cfg.max_nodes + pad_nodes
    f32, i32 = np.float32, np.int32
    per_node = (trace is not None
                and getattr(trace, "revoked_node", None) is not None)
    if trace is not None:
        width = trace_ticks or trace.ticks
        fitted = trace.fit_to(S, width)
        price_trace = fitted.price.astype(f32)
        revoke_trace = fitted.revoked.astype(bool)
        trace_len = min(trace.ticks, width)
    else:
        price_trace = np.zeros((S, trace_ticks or 1), f32)
        revoke_trace = np.zeros((S, trace_ticks or 1), bool)
        trace_len = 1
    if per_node:
        revoke_node = trace.node_columns(N, price_trace.shape[1])
    else:
        revoke_node = np.zeros((N, price_trace.shape[1]), bool)
    if faults is not None:
        fault_len = fault_ticks or faults.ticks
        fault_trace = faults.fit_to(N, fault_len)
    else:
        fault_len = 1
        fault_trace = np.zeros((N, fault_ticks or 1), bool)
    if arrivals is not None:
        write_curve, read_curve, arrival_len = arrivals.fit_to(
            arrival_ticks or arrivals.ticks)
    else:
        write_curve = np.zeros((arrival_ticks or 1,), f32)
        read_curve = np.zeros((arrival_ticks or 1,), f32)
        arrival_len = 1
    if keypop is not None:
        key_cdf = keypop.materialize(cfg.key_space, pad_keys)
    else:
        key_cdf = uniform_key_cdf(cfg.key_space, pad_keys)
    if spot_bid is None:
        bid = state_mod.site_price_init(cfg, S)[1]
    else:
        bid = np.asarray(spot_bid, np.float32).reshape(-1)
        if bid.size == 1:
            bid = np.full((S,), bid[0], np.float32)
        elif bid.size < S:
            bid = np.concatenate(
                [bid, np.full((S - bid.size,), bid[-1], np.float32)])
        bid = bid[:S]
    if trace_mask is None:
        mask = np.ones((trace_ring.NCLASS,), bool)
    else:
        mask = np.asarray(trace_mask, bool).reshape(-1)
        if mask.size != trace_ring.NCLASS:
            raise ValueError(f"trace_mask has {mask.size} classes")
    od = [s.on_demand_price for s in cfg.sites]
    sp = [s.spot_price_mean for s in cfg.sites]
    od = od + [od[-1]] * pad_sites
    sp = sp + [sp[-1]] * pad_sites
    vol = (cfg.sites[0].spot_price_vol if spot_price_vol is None
           else spot_price_vol)
    arrays = {
        "open_loop": np.asarray(arrivals is not None),
        "write_curve": np.asarray(write_curve, f32),
        "read_curve": np.asarray(read_curve, f32),
        "arrival_len": i32(arrival_len),
        "key_zipf": np.asarray(keypop is not None),
        "key_cdf": np.asarray(key_cdf, f32),
        "market_trace": np.asarray(market == "trace"),
        "price_trace": price_trace,
        "revoke_trace": revoke_trace,
        "trace_len": i32(trace_len),
        "spot_bid": np.asarray(bid, f32),
        "warn_ticks": i32(warning_ticks),
        "bid_on_trace": np.asarray(bool(bid_on_trace)),
        "node_trace": np.asarray(per_node),
        "revoke_node_trace": np.asarray(revoke_node, bool),
        "fault_on": np.asarray(faults is not None),
        "fault_trace": np.asarray(fault_trace, bool),
        "fault_len": i32(fault_len),
        "write_rate": f32(write_rate),
        "read_rate": f32(read_rate),
        "phi": f32(phi),
        "heartbeat_interval": i32(cfg.heartbeat_interval),
        "election_timeout_min": i32(cfg.election_timeout_min),
        "election_timeout_max": i32(cfg.election_timeout_max),
        "on_demand_price": np.asarray(od, f32),
        "spot_price_mean": np.asarray(sp, f32),
        "spot_price_vol": f32(vol),
        "ticks_per_hour": f32(3600.0 / 0.01 / 100),     # 1 tick = 10 ms
        "network_cost_coef": f32(0.0005),
        "cross_frac": f32(cross_shard_frac),
        "two_pc_ticks": i32(two_pc_ticks),
        "staleness_bound": i32(staleness_bound),
        "ae_interval": i32(ae_interval),
        "ae_phase": phase,
        "trace_on": np.asarray(bool(trace_on)),
        "trace_mask": mask,
    }
    return state_mod.from_numpy(arrays, device)


@dataclasses.dataclass
class EpochReport:
    """One epoch's report, field for field `repro.core.runtime.EpochReport`."""
    epoch: int
    reads_arrived: int
    writes_arrived: int
    reads_served: int
    writes_committed: int
    read_lat_mean: float
    read_lat_max: float
    write_lat_mean: float
    write_lat_p95: float
    write_lat_p99: float
    cost: float
    n_secretaries: int
    n_observers: int
    leader_changes: int
    no_leader_ticks: int
    killed: int
    read_lat_p95: float = float("nan")
    read_lat_p99: float = float("nan")
    n_warned: int = 0
    obs_reads_served: int = 0
    obs_rerouted: int = 0
    obs_stale_p95: float = float("nan")
    obs_stale_p99: float = float("nan")
    n_obs_digest: int = 0
    metrics: Optional[Dict[str, int]] = None
    decision: Optional[mgr.PeekDecision] = None

    @property
    def goodput(self) -> float:
        return (self.reads_served + self.writes_committed) / 1.0


def build_report(epoch: int, st: Dict, ms: Dict, cost_before: float,
                 leader_term0: Optional[int] = None) -> EpochReport:
    """One cluster's post-epoch state and per-tick metrics (numpy,
    metric leaves shaped (T, ...)) as an EpochReport: the host
    reference path of `FleetSim(pipeline="host")`, which needs the full
    state (DESIGN.md §7.1); `report_from_digest` is the hot path.

    `leader_term0` is the pre-epoch leader term (-1 = no leader),
    prepended to the per-tick leader terms, so that a leader change on
    the epoch's first tick counts, as `_digest_acc_init` seeds it; None
    keeps the within-epoch difference only."""
    lt = np.asarray(ms["leader_term"])
    if leader_term0 is not None:
        lt = np.concatenate([[np.int64(leader_term0)],
                             lt.astype(np.int64)])
    sub_t = np.asarray(st["entry_submit_t"])
    com_t = np.asarray(st["entry_commit_t"])
    done = (sub_t >= 0) & (com_t >= 0)
    lat = (com_t[done] - sub_t[done]).astype(float)
    reads_served = int(st["reads_served"])
    _, _, read_p95, read_p99 = hist_stats(st["read_lat_hist"])
    _, _, stale_p95, stale_p99 = hist_stats(st["obs_stale_hist"])
    return EpochReport(
        read_lat_p95=read_p95,
        read_lat_p99=read_p99,
        n_warned=int((np.asarray(st["alive"]) &
                      (np.asarray(st["warn_timer"]) >= 0)).sum()),
        obs_reads_served=int(st["obs_reads_served"]),
        obs_rerouted=int(st["obs_rerouted"]),
        obs_stale_p95=stale_p95,
        obs_stale_p99=stale_p99,
        n_obs_digest=int(np.asarray(st["dobs_alive"]).sum()),
        epoch=epoch,
        reads_arrived=int(st["reads_arrived"]),
        writes_arrived=int(st["writes_arrived"]),
        reads_served=reads_served,
        writes_committed=int(done.sum()),
        read_lat_mean=float(st["read_lat_sum"] / max(reads_served, 1)),
        read_lat_max=float(st["read_lat_max"]),
        write_lat_mean=float(lat.mean()) if lat.size else float("nan"),
        write_lat_p95=float(np.percentile(lat, 95)) if lat.size
        else float("nan"),
        write_lat_p99=float(np.percentile(lat, 99)) if lat.size
        else float("nan"),
        cost=float(st["cost_accrued"]) - cost_before,
        n_secretaries=int(ms["n_secretaries"][-1]),
        n_observers=int(ms["n_observers"][-1]),
        leader_changes=int((np.diff(lt) > 0).sum()),
        no_leader_ticks=int((ms["has_leader"] == 0).sum()),
        killed=int(ms["killed"].sum()),
        metrics=(trace_metrics.as_dict(st["metrics_ctr"])
                 if "metrics_ctr" in st else None),
    )


def _digest_acc_init(leader_term0) -> Dict:
    """In-loop accumulators for the per-tick metric reductions, seeded
    with the pre-epoch leader term (-1 = no leader) so that a leader
    change on the epoch's first tick counts."""
    z = torch.zeros((), dtype=torch.int32, device=leader_term0.device)
    return {"killed": z, "no_leader_ticks": z, "leader_changes": z,
            "prev_leader_term": leader_term0.to(torch.int32)}


def _digest_acc_update(acc: Dict, m: Dict) -> Dict:
    """Fold one tick's metrics into the accumulators."""
    changed = m["leader_term"] > acc["prev_leader_term"]
    return {
        "killed": acc["killed"] + m["killed"],
        "no_leader_ticks": acc["no_leader_ticks"] +
        (m["has_leader"] == 0).to(torch.int32),
        "leader_changes": acc["leader_changes"] + changed.to(torch.int32),
        "prev_leader_term": m["leader_term"],
    }


def _finalize_digest(state: Dict, acc: Dict, cost_before, T: int,
                     cfg_c: Dict) -> Dict:
    """The epoch digest of every member from the final (pre-compaction)
    state: counters, the exact unit-bin write-latency histogram, the 2PC
    census, the (N,) role/alive rows and the (S,) prices (DESIGN.md
    §7.1), each leaf with the leading member axis."""
    sub, com = state["entry_submit_t"], state["entry_commit_t"]
    B, L = sub.shape
    done = (sub >= 0) & (com >= 0)
    H = T + 1 + HIST_TAIL
    lat = (com - sub).clamp(0, H - 1)
    hist = step_mod._scatter_add_drop(
        torch.zeros((B, H), dtype=torch.int32, device=sub.device),
        torch.where(done, lat, H), torch.ones_like(lat))
    marked = step_mod.cross_shard_mark(
        torch.arange(L, device=sub.device)[None, :],
        cfg_c["cross_frac"][:, None])
    prepared = marked & (sub >= 0)
    alive = state["alive"]
    cnt = lambda m: m.sum(-1, dtype=torch.int32)
    warned = alive & (state["warn_timer"] >= 0)
    return {
        "cross_arrived": state["cross_arrived"],
        "two_pc_prepares": cnt(prepared),
        "two_pc_aborts": cnt(prepared & (com < 0)),
        "reads_arrived": state["reads_arrived"],
        "writes_arrived": state["writes_arrived"],
        "reads_served": state["reads_served"],
        "read_lat_sum": state["read_lat_sum"],
        "read_lat_max": state["read_lat_max"],
        "read_lat_hist": state["read_lat_hist"],
        "write_lat_hist": hist,
        "cost_delta": state["cost_accrued"] - cost_before,
        "n_secretaries": cnt((state["role"] == SECRETARY) & alive),
        "n_observers": cnt((state["role"] == OBSERVER) & alive),
        "killed": acc["killed"],
        "no_leader_ticks": acc["no_leader_ticks"],
        "leader_changes": acc["leader_changes"],
        "role": state["role"],
        "alive": alive,
        "spot_price": state["spot_price"],
        "warned": warned,
        "n_warned": cnt(warned),
        "obs_stale_hist": state["obs_stale_hist"],
        "obs_reads_served": state["obs_reads_served"],
        "obs_rerouted": state["obs_rerouted"],
        "n_obs_digest": cnt(state["dobs_alive"]),
        "trace_metrics": state["metrics_ctr"],
        "trace_pos": state["trace_pos"],
        "trace_emit": state["trace_emit"],
    }


def device_epoch(state: Dict, static, cfg_c: Dict, bundle: Dict,
                 T: int) -> Tuple[Dict, Dict]:
    """One device-resident epoch of every member: T ticks with the
    metric reduction folded in as they run, the digest, then the log
    compaction.  `state`, `cfg_c` and the `(T, B, ...)` bundle carry the
    member axis B; `static` is `state.stack_static(...)`.  Returns
    `(compacted_state, digest)`, both on the state's device."""
    cost_before = state["cost_accrued"]
    lid0 = state_mod.leader_id(state)
    lt0 = torch.where(lid0 >= 0, step_mod._at(state["term"],
                                              lid0.clamp(min=0)), -1)
    acc = _digest_acc_init(lt0)
    for t in range(T):
        state, m = step_mod.tick(state, static, cfg_c, row(bundle, t))
        acc = _digest_acc_update(acc, m)
    digest = _finalize_digest(state, acc, cost_before, T, cfg_c)
    return compact_state(state), digest


def host_epoch(state: Dict, static, cfg_c: Dict, bundle: Dict,
               T: int) -> Tuple[Dict, Dict]:
    """One epoch of the host reference path (DESIGN.md §7.1): T
    reference ticks (`step.tick(reference=True)`, no kernel launched)
    over the `(T, B, ...)` bundle, with no in-loop digest and no
    compaction.  Returns `(state, metrics)`, each metric stacked over
    the ticks as `(B, T, ...)`, both on the state's device."""
    ms = []
    for t in range(T):
        state, m = step_mod.tick(state, static, cfg_c, row(bundle, t),
                                 reference=True)
        ms.append(m)
    return state, {k: torch.stack([m[k] for m in ms], dim=1)
                   for k in ms[0]}


def hist_percentile(counts: np.ndarray, q: float) -> float:
    """Exact `np.percentile(sample, q)` (linear interpolation) of an
    integer sample given as a unit-width histogram; NaN when empty."""
    counts = np.asarray(counts)
    n = int(counts.sum())
    if n == 0:
        return float("nan")
    cum = np.cumsum(counts)
    rank = (n - 1) * q / 100.0
    lo, hi = int(np.floor(rank)), int(np.ceil(rank))
    vlo = int(np.searchsorted(cum, lo + 1))
    vhi = vlo if hi == lo else int(np.searchsorted(cum, hi + 1))
    return float(vlo + (rank - lo) * (vhi - vlo))


def hist_stats(hist) -> Tuple[int, float, float, float]:
    """(count, mean, p95, p99) of the sample a unit-bin histogram
    encodes; mean and percentiles are NaN when it is empty."""
    hist = np.asarray(hist)
    n = int(hist.sum())
    lat_sum = float(hist @ np.arange(hist.shape[0], dtype=np.int64))
    mean = lat_sum / n if n else float("nan")
    return n, mean, hist_percentile(hist, 95), hist_percentile(hist, 99)


def goodput_under_deadline(hist, deadline: int) -> int:
    """Requests finished within `deadline` ticks: sum(hist[:deadline+1])."""
    hist = np.asarray(hist)
    d = min(int(deadline), hist.shape[0] - 1)
    if d < 0:
        return 0
    return int(hist[:d + 1].sum())


def report_from_digest(epoch: int, dg: Dict) -> EpochReport:
    """One epoch's digest (numpy leaves) as an EpochReport: counters
    exact, latency stats recovered exactly from the unit-bin histograms."""
    n_done, lat_mean, lat_p95, lat_p99 = hist_stats(dg["write_lat_hist"])
    reads_served = int(dg["reads_served"])
    _, _, read_p95, read_p99 = hist_stats(dg["read_lat_hist"])
    _, _, stale_p95, stale_p99 = hist_stats(dg["obs_stale_hist"])
    return EpochReport(
        read_lat_p95=read_p95, read_lat_p99=read_p99,
        n_warned=int(dg["n_warned"]),
        obs_reads_served=int(dg["obs_reads_served"]),
        obs_rerouted=int(dg["obs_rerouted"]),
        obs_stale_p95=stale_p95, obs_stale_p99=stale_p99,
        n_obs_digest=int(dg["n_obs_digest"]),
        epoch=epoch,
        reads_arrived=int(dg["reads_arrived"]),
        writes_arrived=int(dg["writes_arrived"]),
        reads_served=reads_served,
        writes_committed=n_done,
        read_lat_mean=float(dg["read_lat_sum"] / max(reads_served, 1)),
        read_lat_max=float(dg["read_lat_max"]),
        write_lat_mean=lat_mean, write_lat_p95=lat_p95,
        write_lat_p99=lat_p99,
        cost=float(dg["cost_delta"]),
        n_secretaries=int(dg["n_secretaries"]),
        n_observers=int(dg["n_observers"]),
        leader_changes=int(dg["leader_changes"]),
        no_leader_ticks=int(dg["no_leader_ticks"]),
        killed=int(dg["killed"]),
        metrics=trace_metrics.as_dict(dg["trace_metrics"]),
    )


_COMPACT_ZERO = ("dobs_applied", "dobs_term", "dobs_digest",
                 "obs_reads_served", "obs_rerouted", "obs_stale_hist",
                 "log_term", "log_key", "log_val", "log_len", "commit_len",
                 "applied_len", "applied_digest", "match_len",
                 "reads_arrived", "writes_arrived", "cross_arrived",
                 "reads_served", "writes_committed", "read_lat_sum",
                 "read_lat_max", "read_lat_hist", "metrics_ctr")
_COMPACT_NEG = ("dobs_warn", "app_arrive_t", "ack_arrive_t",
                "entry_submit_t", "entry_commit_t")


def compact_state(state: Dict) -> Dict:
    """Epoch-boundary log compaction (the state machines keep the data);
    the per-epoch counters and the metrics registry reset, the trace
    ring and its cursor do not (DESIGN.md §14).  Shape-generic, so it
    serves a batched fleet state as well.  The digest tier resets with
    the log window it fingerprints: every enabled slot comes back alive
    and unwarned with its applied triple cleared, and keeps its last
    sync tick, so a revived slot reroutes until its first round lands
    (DESIGN.md §13)."""
    out = dict(state, dobs_alive=state["dobs_enabled"].clone())
    for k in _COMPACT_ZERO:
        out[k] = torch.zeros_like(state[k])
    for k in _COMPACT_NEG:
        out[k] = torch.full_like(state[k], -1)
    return out


def lease_and_wire(cfg: ClusterConfig, static, role: np.ndarray,
                   alive: np.ndarray, np_rng, predictor, leased: np.ndarray,
                   want_sec: int, want_obs: int,
                   warned: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray]:
    """Peak: score a spot-offer pool (eq. 2), MCSA-select, wire roles —
    numpy, a copy of `repro.core.runtime.lease_and_wire` that draws from
    `np_rng` in the same order.  Returns updated (role, alive, sec_of,
    obs_of); `leased` (per-site census) is updated in place."""
    site = static["site"]
    V = static["V"]
    n_sites = cfg.num_sites
    role = np.asarray(role).copy()
    alive = np.asarray(alive).copy()
    warned = (np.zeros(role.shape, bool) if warned is None
              else np.asarray(warned).astype(bool))

    def lease_slots(slot_mask, want):
        free = np.where(slot_mask & (role == DEAD))[0]
        if want <= 0 or len(free) == 0:
            return []
        pool = min(len(free) * 4, 256)
        offer_site = np_rng.integers(0, n_sites, pool)
        cpu = np_rng.uniform(1, 4, pool)
        mem = np_rng.uniform(1, 8, pool)
        price = np.array([cfg.sites[s].spot_price_mean for s in
                          offer_site]) * np_rng.uniform(0.6, 1.6, pool)
        revoke = predictor.predict()[offer_site]
        scores = mgr.spot_scores(cpu, mem, price, revoke)
        picked = mcsa.mcsa_topk(scores, min(want, len(free)), np_rng)
        slots = []
        for s_id in (int(offer_site[i]) for i in picked):
            cands = [f for f in free if site[f] == s_id and f not in slots]
            if not cands:
                cands = [f for f in free if f not in slots]
            if cands:
                slots.append(int(cands[0]))
                leased[site[slots[-1]]] += 1
        return slots

    for s in lease_slots(static["is_secretary_slot"], want_sec):
        role[s] = SECRETARY
        alive[s] = True
    for s in lease_slots(static["is_observer_slot"], want_obs):
        role[s] = OBSERVER
        alive[s] = True

    sec_of = np.full(role.shape, -1, np.int32)
    obs_of = np.full(role.shape, -1, np.int32)
    for s_id in range(n_sites):
        secs = [i for i in range(len(role))
                if role[i] == SECRETARY and alive[i] and not warned[i]
                and site[i] == s_id]
        fols = [i for i in range(V)
                if role[i] in (FOLLOWER, LEADER) and alive[i]
                and site[i] == s_id]
        if secs:
            for j, f in enumerate(fols):
                sec_of[f] = secs[j % len(secs)]
        obss = [i for i in range(len(role))
                if role[i] == OBSERVER and alive[i] and site[i] == s_id]
        if fols:
            for j, o in enumerate(obss):
                obs_of[o] = fols[j % len(fols)]
    all_fols = [i for i in range(V) if role[i] in (FOLLOWER, LEADER)
                and alive[i]]
    for o in range(len(role)):
        if role[o] == OBSERVER and alive[o] and obs_of[o] < 0 and all_fols:
            obs_of[o] = all_fols[o % len(all_fols)]
    return role, alive, sec_of, obs_of


class ClusterController:
    """Host-side control plane of one cluster: the numpy RNG, the
    revocation predictor, the per-site lease census and the read-growth
    history that Algorithm 1 needs between epochs."""

    def __init__(self, cfg: ClusterConfig, static, *, seed: int,
                 predictor: Optional[mgr.RevocationPredictor] = None):
        self.cfg = cfg
        self.static = static
        self.np_rng = np.random.default_rng(seed + 1)
        # default: flat-prior EWMA; a trace-calibrated predictor
        # (`market.calibrate.calibrate_predictor`) scores spot offers with
        # per-site rates fitted offline (DESIGN.md §10)
        self.predictor = predictor if predictor is not None \
            else mgr.RevocationPredictor(cfg.num_sites)
        self.reads_prev = 0
        self.leased = np.zeros(cfg.num_sites, np.int64)

    def decide(self, rep: EpochReport, spot_price: float
               ) -> mgr.PeekDecision:
        """Algorithm 1 on this epoch's stats."""
        self.predictor.update(
            np.full(self.cfg.num_sites,
                    rep.killed / max(self.cfg.num_sites, 1)),
            np.maximum(self.leased, 1))
        stats = mgr.PeekStats(
            reads_prev=self.reads_prev,
            reads_now=rep.reads_arrived,
            writes_now=rep.writes_arrived,
            followers_per_site=[s.followers for s in self.cfg.sites],
            k_s=rep.n_secretaries, k_o=rep.n_observers,
            budget=self.cfg.budget_per_period,
            spot_price=spot_price,
            on_demand_price=float(
                np.mean([s.on_demand_price for s in self.cfg.sites])),
        )
        return mgr.algorithm1(self.cfg, stats)

    def lease(self, role, alive, want_sec: int, want_obs: int,
              warned=None):
        return lease_and_wire(self.cfg, self.static, role, alive,
                              self.np_rng, self.predictor, self.leased,
                              want_sec, want_obs, warned=warned)

    def end_epoch(self, rep: EpochReport) -> None:
        self.reads_prev = rep.reads_arrived


def _host(tree: Dict) -> Dict:
    return {k: v.cpu().numpy() for k, v in tree.items()}


def run_tick(sim, draws: Dict) -> None:
    """Advance a solo sim by one tick given a one-cluster draw row: the
    batched tick at B = 1."""
    st, _ = step_mod.tick(state_mod.batch1(sim.state), sim.static_t,
                          state_mod.batch1(sim.cfg_c),
                          state_mod.batch1(draws))
    sim.state = state_mod.member(st, 0)


class BWRaftSim:
    """In-process BW-Raft cluster simulation on PyTorch.

    Runs on the card unless `device="cpu"` (and raises when there is no
    card and no device is given).  `draws` is the epoch draw source
    (`core/draws.py`); by default a `TorchDraws` seeded with `seed`.
    The control plane's numpy generator is seeded `seed + 1`, as in the
    JAX package, so under the same draws both lease the same slots.
    `n_observers > 0` attaches a digest-tier observer rack (DESIGN.md
    §13), `pad_observers` inert padded slots.

    `market="trace"` replays `trace` (a `market.MarketTrace`) instead of
    the walk (DESIGN.md §10); `predictor` seeds the control plane with a
    trace-calibrated `RevocationPredictor`.  `arrivals`/`keypop` put the
    cluster under an open-loop plan and Zipfian keys (§11), `faults`
    under a scripted `FaultSchedule` (§12), and `bid_policy` (e.g.
    `market.calibrate.HazardAwareBid`) rewrites the per-site bids after
    every epoch through `set_bid`.

    `state` and `cfg_c` are this cluster's unbatched trees; the epoch
    runs the batched tick on them at B = 1 (views, no copies)."""

    def __init__(self, cfg: ClusterConfig, *, mode: str = "bwraft",
                 write_rate: float = 8.0, read_rate: float = 32.0,
                 phi: float = 0.0, seed: int = 0,
                 manage_resources: bool = True,
                 pad_nodes: int = 0, pad_sites: int = 0,
                 pad_log: int = 0, pad_keys: int = 0,
                 spot_price_vol: Optional[float] = None,
                 prelease: Optional[Tuple[int, int]] = None,
                 cross_shard_frac: float = 0.0, two_pc_ticks: int = 0,
                 market: str = "process", trace=None, predictor=None,
                 arrivals=None, arrival_ticks: Optional[int] = None,
                 keypop=None, warning_ticks: int = 0, spot_bid=None,
                 bid_on_trace: bool = False, faults=None,
                 fault_ticks: Optional[int] = None, bid_policy=None,
                 n_observers: int = 0,
                 pad_observers: int = 0, staleness_bound: int = 16,
                 ae_interval: int = 4, ae_phase=None,
                 trace_on: bool = False, trace_mask=None,
                 trace_capacity: int = trace_ring.DEFAULT_CAPACITY,
                 device=None, draws=None):
        if mode not in ("bwraft", "raft"):
            raise ValueError(f"mode={mode!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mode = mode
        self.static = state_mod.build_static(
            cfg, pad_nodes=pad_nodes, pad_sites=pad_sites,
            n_obs_digest=n_observers, pad_obs=pad_observers,
            trace_capacity=trace_capacity)
        self.static_t = state_mod.stack_static([self.static], self.device)
        self.state = state_mod.init_state(cfg, self.static, self.device,
                                          pad_log=pad_log, pad_keys=pad_keys)
        self.cfg_c = make_cfg_arrays(
            cfg, self.device, write_rate=write_rate, read_rate=read_rate,
            phi=phi, pad_nodes=pad_nodes, pad_sites=pad_sites,
            pad_keys=pad_keys, spot_price_vol=spot_price_vol,
            cross_shard_frac=cross_shard_frac, two_pc_ticks=two_pc_ticks,
            market=market, trace=trace, arrivals=arrivals,
            arrival_ticks=arrival_ticks, keypop=keypop,
            warning_ticks=warning_ticks, spot_bid=spot_bid,
            bid_on_trace=bid_on_trace, faults=faults,
            fault_ticks=fault_ticks, n_observers=n_observers,
            pad_observers=pad_observers, staleness_bound=staleness_bound,
            ae_interval=ae_interval, ae_phase=ae_phase, trace_on=trace_on,
            trace_mask=trace_mask)
        self._trace_on = bool(trace_on)
        self.draws = draws if draws is not None else \
            TorchDraws(seed, self.device)
        self.bid_policy = bid_policy
        self._trace = trace
        self.manage = manage_resources and mode == "bwraft"
        self.controller = ClusterController(cfg, self.static, seed=seed,
                                            predictor=predictor)
        self.epoch = 0
        self._reports: List[EpochReport] = []
        self.last_digest: Optional[Dict] = None
        self._trace_cursor = trace_export.DrainCursor()
        self.trace_events: List[trace_export.TraceEvent] = []
        if prelease is not None:
            self._lease(max(prelease[0], 0), max(prelease[1], 0))

    # ------------------------------------------------------------------ #
    def _scalar(self, value, dtype) -> torch.Tensor:
        return torch.tensor(value, dtype=dtype, device=self.device)

    def set_rates(self, write_rate=None, read_rate=None, phi=None):
        for key, v in (("write_rate", write_rate), ("read_rate", read_rate),
                       ("phi", phi)):
            if v is not None:
                self.cfg_c[key] = self._scalar(v, torch.float32)

    def set_arrivals(self, arrivals) -> None:
        """Swap the open-loop arrival plan: the curves are refitted to
        the width the sim was built with and written into the existing
        leaves (DESIGN.md §11)."""
        width = int(self.cfg_c["write_curve"].shape[0])
        w, r, alen = arrivals.fit_to(width)
        self.cfg_c["open_loop"].fill_(True)
        self.cfg_c["write_curve"].copy_(torch.from_numpy(w))
        self.cfg_c["read_curve"].copy_(torch.from_numpy(r))
        self.cfg_c["arrival_len"].fill_(int(alen))

    def set_bid(self, bids) -> None:
        """Swap the per-site spot bids in place, at the fixed (S,) shape
        (DESIGN.md §12).  A scalar broadcasts; a short vector repeats its
        last site (the `site_price_init` padding rule)."""
        S = int(self.cfg_c["spot_bid"].shape[0])
        b = np.asarray(bids, np.float32).reshape(-1)
        if b.size == 1:
            b = np.full((S,), b[0], np.float32)
        elif b.size < S:
            b = np.concatenate(
                [b, np.full((S - b.size,), b[-1], np.float32)])
        self.cfg_c["spot_bid"].copy_(torch.from_numpy(b[:S].copy()))

    def set_trace(self, on=None, mask=None) -> None:
        """Toggle flight-recorder capture / remask event classes."""
        if on is not None:
            self._trace_on = bool(on)
            self.cfg_c["trace_on"] = self._scalar(bool(on), torch.bool)
        if mask is not None:
            m = np.asarray(mask, bool).reshape(-1)
            if m.size != trace_ring.NCLASS:
                raise ValueError(f"trace mask has {m.size} classes")
            self.cfg_c["trace_mask"] = torch.as_tensor(m, device=self.device)

    def drain_trace(self) -> List[trace_export.TraceEvent]:
        """Decode the ring slots appended since the last drain."""
        events = self._trace_cursor.drain(self.state)
        self.trace_events.extend(events)
        return events

    @property
    def events_dropped(self) -> Dict[str, int]:
        return self._trace_cursor.dropped_by_class()

    def _lease(self, want_sec: int, want_obs: int, warned=None) -> None:
        """Peak: score a spot-offer pool (eq. 2), MCSA-select, wire roles."""
        role, alive, sec_of, obs_of = self.controller.lease(
            self.state["role"].cpu().numpy(),
            self.state["alive"].cpu().numpy(),
            want_sec, want_obs, warned=warned)
        put = lambda a: torch.as_tensor(a, device=self.device)
        self.state = dict(self.state, role=put(role), alive=put(alive),
                          sec_of=put(sec_of), obs_of=put(obs_of))

    def lease_fixed(self, want_sec: int, want_obs: int) -> None:
        """One-shot fixed-role wiring with per-epoch management off."""
        self._lease(max(want_sec, 0), max(want_obs, 0))

    # ------------------------------------------------------------------ #
    def run_epoch(self) -> EpochReport:
        """One epoch: the draw bundle, T ticks on the device, one fetch
        of the digest, then the control plane."""
        T = self.cfg.period_ticks
        bundle = self.draws.epoch(T, self.state, self.cfg_c)
        state, digest = device_epoch(
            state_mod.batch1(self.state), self.static_t,
            state_mod.batch1(self.cfg_c),
            {k: v.unsqueeze(1) for k, v in bundle.items()}, T)
        self.state = state_mod.member(state, 0)
        dg = {k: v[0] for k, v in _host(digest).items()}
        self.last_digest = dg
        if self._trace_on:
            self.drain_trace()
        rep = report_from_digest(self.epoch, dg)
        if self.manage:
            dec = self.controller.decide(
                rep, float(np.mean(dg["spot_price"][:self.cfg.num_sites])))
            rep.decision = dec
            warned, roles = dg["warned"], dg["role"]
            self._lease(
                max(dec.dk_s, 0) + int(((roles == SECRETARY) &
                                        warned).sum()),
                max(dec.dk_o, 0) + int(((roles == OBSERVER) &
                                        warned).sum()),
                warned=warned)
        if self.bid_policy is not None:
            self.set_bid(self.bid_policy.update(
                predictor=self.controller.predictor, trace=self._trace,
                end_tick=(self.epoch + 1) * self.cfg.period_ticks,
                sites=int(self.cfg_c["spot_bid"].shape[0])))
        self.controller.end_epoch(rep)
        self.epoch += 1
        self._reports.append(rep)
        return rep

    def run(self, epochs: int) -> List[EpochReport]:
        return [self.run_epoch() for _ in range(epochs)]

    @property
    def reports(self) -> List[EpochReport]:
        return self._reports
