"""Multi-Raft baseline: key-space sharding over S independent Raft groups
(PyTorch port of `repro.core.multiraft`, DESIGN.md §6.3, §9).

The scale-out the paper compares against (§2.1): each shard is a full
Raft over its own on-demand node set, with 2-phase commit between shard
leaders for cross-shard writes.  Two engines share the shard model:

- **Grouped fleet (default).**  `MultiRaftSim` wraps a `fleet.FleetSim`
  whose members are the S shards of one shard group: they advance in one
  batched tick, the 2PC coupling runs in the tick (a cross-shard write
  pays the two inter-site rounds as measured latency), and the shard
  digests reduce to one group digest on the device through the
  `group_digest` kernel.
- **Sequential host reference.**  `engine="sequential"` steps one
  `BWRaftSim` (mode="raft") per shard and blends the reports with
  `aggregate_shards`, which applies the 2PC tax after the fact.

`shard_specs` is the entry point for joining this Multi-Raft system to a
larger fleet, next to the BW-Raft and Raft members it is compared with.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.cluster_config import ClusterConfig
from repro_torch.core.runtime import BWRaftSim, EpochReport, hist_stats
from repro_torch.trace import metrics as trace_metrics


@dataclasses.dataclass
class MultiRaftReport:
    """One epoch of one Multi-Raft system, field for field
    `repro.core.multiraft.MultiRaftReport`."""
    epoch: int
    writes_committed: int
    writes_arrived: int
    reads_served: int
    reads_arrived: int
    write_lat_mean: float
    write_lat_p95: float
    write_lat_p99: float
    read_lat_mean: float
    cost: float
    read_lat_p95: float = float("nan")
    read_lat_p99: float = float("nan")
    cross_arrived: int = 0
    two_pc_prepares: int = 0
    two_pc_aborts: int = 0
    metrics: Optional[Dict[str, int]] = None

    @property
    def goodput(self) -> float:
        return self.reads_served + self.writes_committed


def shard_workload(write_rate: float, read_rate: float, shards: int,
                   cross_shard_frac: float) -> tuple[float, float]:
    """Per-shard effective rates: cross-shard writes execute in both
    shards, so `w_eff * shards == write_rate * (1 + chi)` (DESIGN.md §9)."""
    w_eff = write_rate * (1 + cross_shard_frac) / shards
    return w_eff, read_rate / shards


def two_pc_penalty(cfg: ClusterConfig) -> int:
    """2PC tax in ticks: prepare + commit round between shard leaders."""
    rtts = [s.rtt_inter for s in cfg.sites]
    return 2 * int(np.mean(rtts))


def shard_specs(cfg: ClusterConfig, *, shards: int = 2,
                write_rate: float = 8.0, read_rate: float = 32.0,
                cross_shard_frac: float = 0.1, seed: int = 0,
                group_id: int = 0, arrivals=None, keypop=None,
                n_observers: int = 0, staleness_bound: int = 16,
                ae_interval: int = 4) -> List:
    """This Multi-Raft system as `shards` fleet members (mode="raft",
    unmanaged, seeds `seed + 17 * i`).  With `group_id >= 0` the members
    form one shard group (DESIGN.md §9) and the fleet reports them as
    `MultiRaftReport`s in `FleetSim.group_reports[group_id]`; with
    `group_id=-1` they are independent members.  `arrivals` (a
    system-wide `workload.OpenLoop` plan) is divided over the shards
    with the `shard_workload` factors of the scalar rates, writes
    inflated by (1 + chi) (DESIGN.md §11); `keypop` passes through to
    every shard.  The digest-tier knobs attach a rack to each shard
    (DESIGN.md §13)."""
    from repro_torch.core.fleet import MemberSpec  # fleet imports runtime
    w_eff, r_eff = shard_workload(write_rate, read_rate, shards,
                                  cross_shard_frac)
    shard_plan = (arrivals.scaled((1 + cross_shard_frac) / shards,
                                  1.0 / shards)
                  if arrivals is not None else None)
    grouped = group_id >= 0
    return [MemberSpec(cfg=cfg, mode="raft", write_rate=w_eff,
                       read_rate=r_eff, seed=seed + 17 * i,
                       manage_resources=False,
                       arrivals=shard_plan, keypop=keypop,
                       n_observers=n_observers,
                       staleness_bound=staleness_bound,
                       ae_interval=ae_interval,
                       group_id=group_id,
                       shards_per_group=shards if grouped else 1,
                       cross_shard_frac=cross_shard_frac if grouped
                       else 0.0)
            for i in range(shards)]


def _nan_blend(values, reduce) -> float:
    """NaN-aware blend of per-shard latency stats: NaN rows are left
    out; all-NaN in, NaN out."""
    arr = np.asarray(values, dtype=float)
    if np.isnan(arr).all():
        return float("nan")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return float(reduce(arr))


def aggregate_shards(epoch: int, reps: Sequence[EpochReport],
                     cfg: ClusterConfig,
                     cross_shard_frac: float = 0.1) -> MultiRaftReport:
    """The sequential engine's blend of per-shard reports: the 2PC tax
    applied after the fact and the cross-shard prepares deduplicated
    (DESIGN.md §9)."""
    chi = cross_shard_frac
    tax = two_pc_penalty(cfg) if chi > 0 else 0
    lat_mean = _nan_blend([r.write_lat_mean for r in reps], np.nanmean)
    lat_p95 = _nan_blend([r.write_lat_p95 for r in reps], np.nanmax)
    lat_p99 = _nan_blend([r.write_lat_p99 for r in reps], np.nanmax)
    lat_mean = lat_mean + chi * tax
    lat_p95 = lat_p95 + tax
    lat_p99 = lat_p99 + tax
    return MultiRaftReport(
        epoch=epoch,
        writes_committed=int(sum(r.writes_committed for r in reps) /
                             (1 + chi)),
        writes_arrived=int(sum(r.writes_arrived for r in reps) / (1 + chi)),
        reads_served=sum(r.reads_served for r in reps),
        reads_arrived=sum(r.reads_arrived for r in reps),
        write_lat_mean=lat_mean, write_lat_p95=lat_p95,
        write_lat_p99=lat_p99,
        read_lat_mean=_nan_blend([r.read_lat_mean for r in reps],
                                 np.nanmean),
        cost=sum(r.cost for r in reps),
    )


def report_from_group_digest(epoch: int, gdg: Dict,
                             cross_shard_frac: float) -> MultiRaftReport:
    """One shard group's pooled epoch digest (numpy leaves) as a
    `MultiRaftReport`: counts deduplicated by 1/(1+chi) with the same
    arithmetic as `aggregate_shards`, latencies exact from the pooled
    unit-bin histograms, whose cross-shard entries carry the measured
    2PC rounds."""
    chi = cross_shard_frac
    n_done, lat_mean, lat_p95, lat_p99 = hist_stats(gdg["write_lat_hist"])
    reads_served = int(gdg["reads_served"])
    _, _, read_p95, read_p99 = hist_stats(gdg["read_lat_hist"])
    return MultiRaftReport(
        read_lat_p95=read_p95,
        read_lat_p99=read_p99,
        epoch=epoch,
        writes_committed=int(n_done / (1 + chi)),
        writes_arrived=int(int(gdg["writes_arrived"]) / (1 + chi)),
        reads_served=reads_served,
        reads_arrived=int(gdg["reads_arrived"]),
        write_lat_mean=lat_mean,
        write_lat_p95=lat_p95,
        write_lat_p99=lat_p99,
        read_lat_mean=float(gdg["read_lat_sum"]) / max(reads_served, 1),
        cost=float(gdg["cost_delta"]),
        cross_arrived=int(gdg["cross_arrived"]),
        two_pc_prepares=int(gdg["two_pc_prepares"]),
        two_pc_aborts=int(gdg["two_pc_aborts"]),
        metrics=(trace_metrics.as_dict(gdg["trace_metrics"])
                 if "trace_metrics" in gdg else None),
    )


class MultiRaftSim:
    """S Raft shards + the 2PC cross-shard write model (DESIGN.md §6.3,
    §9).  `engine="fleet"` (default) wraps a grouped `FleetSim`, whose
    `run(E)` takes the multi-epoch path; `engine="sequential"` steps one
    `BWRaftSim` per shard and blends them with `aggregate_shards`.  Runs
    on the card unless `device="cpu"`; `draws` is one draw source per
    shard (default `TorchDraws(seed + 17 * i)`)."""

    def __init__(self, cfg: ClusterConfig, *, shards: int = 2,
                 write_rate: float = 8.0, read_rate: float = 32.0,
                 cross_shard_frac: float = 0.1, seed: int = 0,
                 engine: str = "fleet", n_observers: int = 0,
                 staleness_bound: int = 16, ae_interval: int = 4,
                 device=None, draws=None):
        if engine not in ("fleet", "sequential"):
            raise ValueError(f"engine={engine!r}")
        self.cfg = cfg
        self.shards = shards
        self.chi = cross_shard_frac
        self.engine = engine
        self.two_pc_penalty = two_pc_penalty(cfg)
        self.epoch = 0
        if engine == "fleet":
            from repro_torch.core.fleet import FleetSim
            self.fleet = FleetSim(
                shard_specs(cfg, shards=shards, write_rate=write_rate,
                            read_rate=read_rate,
                            cross_shard_frac=cross_shard_frac, seed=seed,
                            group_id=0, n_observers=n_observers,
                            staleness_bound=staleness_bound,
                            ae_interval=ae_interval),
                device=device, draws=draws)
            self.sims: List[BWRaftSim] = []
            return
        w_eff, r_eff = shard_workload(write_rate, read_rate, shards,
                                      cross_shard_frac)
        draws = [None] * shards if draws is None else list(draws)
        self.sims = [
            BWRaftSim(cfg, mode="raft", write_rate=w_eff,
                      read_rate=r_eff, seed=seed + 17 * i,
                      manage_resources=False, n_observers=n_observers,
                      staleness_bound=staleness_bound,
                      ae_interval=ae_interval, device=device,
                      draws=draws[i])
            for i in range(shards)
        ]

    def run_epoch(self) -> MultiRaftReport:
        if self.engine == "fleet":
            self.fleet.run_epoch()
            self.epoch += 1
            return self.fleet.group_reports[0][-1]
        reps: List[EpochReport] = [s.run_epoch() for s in self.sims]
        rep = aggregate_shards(self.epoch, reps, self.cfg, self.chi)
        self.epoch += 1
        return rep

    def run(self, epochs: int) -> List[MultiRaftReport]:
        if self.engine == "fleet":
            start = self.epoch
            self.fleet.run(epochs)
            self.epoch += epochs
            return self.fleet.group_reports[0][start:]
        return [self.run_epoch() for _ in range(epochs)]
