"""Batched fleet simulator: B independent BW-Raft clusters advanced by one
batched tick (PyTorch port of `repro.core.fleet`, DESIGN.md §7).

The JAX fleet `vmap`s one epoch body over its members; here the member
axis is written out (`core/step.py`), so the fleet runs the same tick as
a solo `BWRaftSim` at B > 1: the same number of ops per tick for any B,
and each kernel launches once per tick for the whole fleet.

Padding and masking (DESIGN.md §7): smaller clusters are padded to the
fleet's shapes with inert node slots (non-voter, never leased, forever
DEAD), price-only padded sites, dead log and key tail space and
never-enabled digest-tier slots (DESIGN.md §13), exactly as the JAX
fleet pads them.  Member dynamics never couple across the member axis,
so a member equals a solo `BWRaftSim` with the same padded shapes and
draws.

Randomness: one draw source per member (`core/draws.py`), by default
`TorchDraws(spec.seed)`, so each member follows the key schedule of a
solo sim with its seed, as the JAX fleet splits one `PRNGKey(seed)` per
member.  The tests pass one JAX draw tape per member instead.

The host control plane (Algorithm 1 "peek", MCSA "peak" leasing) runs
per member between epochs through `runtime.ClusterController`: it reads
the (N,) role/alive rows from the epoch digest, fetched once for all
members, and writes back only the managed members' four role/wiring
rows.

Shard groups (DESIGN.md §9): members with `group_id >= 0` are the shards
of ONE Multi-Raft system.  After each epoch their digests reduce to one
digest per group on the device through the `group_digest` kernel
(`_group_digest`), and `group_reports` serves them as `MultiRaftReport`s.

Differences from the JAX fleet: the `pipeline="host"` reference path
(the frozen PR-1 marshalling, ROADMAP.md item 11) and the `MemberSpec`
fields whose objects the port's `BWRaftSim` does not take yet (a trace
market, open-loop arrivals, Zipfian keys, fault schedules, bid policies:
ROADMAP.md item 8) raise `NotImplementedError`.  PyTorch compiles
nothing, so `compile_count` and `total_compile_count`, which count the
JAX fleet's jit caches, have no counterpart here.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import state as state_mod
from repro_torch.core.cluster_config import ClusterConfig
from repro_torch.core.draws import TorchDraws, fleet_epoch
from repro_torch.core.runtime import (ClusterController, EpochReport,
                                      device_epoch, make_cfg_arrays,
                                      report_from_digest)
from repro_torch.kernels.group_digest import ops as gd_ops
from repro_torch.trace import export as trace_export
from repro_torch.trace import metrics as trace_metrics
from repro_torch.trace import ring as trace_ring

# spec fields sweepable via FleetSim.from_sweep axes
_SWEEP_AXES = ("mode", "write_rate", "read_rate", "phi", "seed",
               "manage_resources", "spot_price_vol", "budget_per_period",
               "market", "trace", "arrivals", "keypop",
               "warning_ticks", "bid_policy", "faults", "bid_on_trace",
               "n_observers", "staleness_bound", "ae_interval",
               "trace_on")

_ITEM8 = ("is not ported yet: ROADMAP.md, 'Modules to port', item 8 "
          "(host services over the sim)")
_ITEM11 = ("FleetSim(pipeline='host'), the frozen PR-1 reference path, is "
           "not ported: ROADMAP.md, 'Modules to port', item 11")


@dataclasses.dataclass(frozen=True)
class MemberSpec:
    """One cluster in the fleet: topology + workload knobs + seed, field
    for field `repro.core.fleet.MemberSpec`.

    `prelease` wires a fixed (secretaries, observers) complement once at
    t = 0.  `group_id >= 0` makes the member a shard of one Multi-Raft
    system (DESIGN.md §9): `shards_per_group` is the declared group size
    (checked against the members), `cross_shard_frac` the 2PC coupling
    fraction χ, `two_pc_ticks` the 2PC round trip (None: derived from the
    topology by `multiraft.two_pc_penalty`).  `n_observers` attaches a
    digest-tier rack (DESIGN.md §13); members pad to the fleet's largest
    O.  `market="trace"`/`trace`, `arrivals`, `keypop`, `faults` and
    `bid_policy` raise `NotImplementedError` (ROADMAP.md item 8)."""
    cfg: ClusterConfig
    mode: str = "bwraft"
    write_rate: float = 8.0
    read_rate: float = 32.0
    phi: float = 0.0
    seed: int = 0
    manage_resources: bool = True
    spot_price_vol: Optional[float] = None      # None -> cfg.sites[0]
    budget_per_period: Optional[float] = None   # None -> cfg value
    prelease: Optional[Tuple[int, int]] = None
    group_id: int = -1
    shards_per_group: int = 1
    cross_shard_frac: float = 0.0
    two_pc_ticks: Optional[int] = None
    market: str = "process"
    trace: Optional[object] = None
    arrivals: Optional[object] = None
    keypop: Optional[object] = None
    warning_ticks: int = 0
    bid_on_trace: bool = False
    bid_policy: Optional[object] = None
    faults: Optional[object] = None
    n_observers: int = 0
    staleness_bound: int = 16
    ae_interval: int = 4
    trace_on: bool = False
    trace_mask: Optional[Tuple[bool, ...]] = None
    trace_capacity: int = trace_ring.DEFAULT_CAPACITY

    @property
    def manage(self) -> bool:
        return self.manage_resources and self.mode == "bwraft"


@dataclasses.dataclass(frozen=True)
class FleetShapes:
    B: int
    N: int   # nodes, padded to max over members
    S: int   # sites, padded
    L: int   # log window, padded
    K: int   # KV key space, padded
    T: int   # period_ticks (must be equal across members)
    O: int = 0   # digest-tier observer slots, padded (DESIGN.md §13)
    C: int = trace_ring.DEFAULT_CAPACITY  # trace ring depth (§14), padded


# per-member digest fields reduced to a per-group digest (DESIGN.md §9):
# everything a MultiRaftReport needs, summed over the shards of each
# group (read_lat_max by a max); the float sums accumulate in ascending
# member order, which is `segment_sum`'s order
_GROUP_SUM_KEYS = ("write_lat_hist", "read_lat_hist", "reads_arrived",
                   "writes_arrived", "reads_served", "read_lat_sum",
                   "cost_delta", "killed", "no_leader_ticks",
                   "leader_changes", "cross_arrived", "two_pc_prepares",
                   "two_pc_aborts", "trace_metrics")
_GROUP_FLOAT_KEYS = ("read_lat_sum", "cost_delta")
_GROUP_INT_KEYS = tuple(k for k in _GROUP_SUM_KEYS
                        if k not in _GROUP_FLOAT_KEYS)


def group_digest_width(cfg: ClusterConfig) -> int:
    """Fi, the packed int lanes of one member's group digest: the two
    unit-bin latency histograms, nine counters and the metrics
    registry (355 at the paper's 100-tick epoch)."""
    n_counters = len(_GROUP_INT_KEYS) - 3
    return 2 * state_mod.hist_bins(cfg) + n_counters + \
        trace_metrics.NCOUNTER


def _group_digest(digest: Dict, gids: torch.Tensor, n_groups: int) -> Dict:
    """Reduce per-member digest leaves (B, ...) to per-group leaves
    (G, ...) with one `group_reduce` launch.  Ungrouped members carry
    segment id G and are dropped — the masking rule that makes ragged
    group sizes and mixed grouped/ungrouped fleets shape-free
    (DESIGN.md §9).  The leaves are packed as the JAX fleet packs them
    for its kernel: one (B, Fi) int32 matrix of the int leaves in
    `_GROUP_INT_KEYS` order, one (B, 3) float32 matrix (read_lat_sum,
    cost_delta, read_lat_max)."""
    parts = [digest[k].to(torch.int32).reshape(digest[k].shape[0], -1)
             for k in _GROUP_INT_KEYS]
    widths = [p.shape[1] for p in parts]
    int_mat = torch.cat(parts, dim=1).contiguous()
    flt_mat = torch.stack([digest[k] for k in _GROUP_FLOAT_KEYS] +
                          [digest["read_lat_max"]], dim=1).contiguous()
    g_int, g_sum, g_max = gd_ops.group_reduce(gids, int_mat, flt_mat,
                                              n_groups=n_groups)
    out, off = {}, 0
    for k, w in zip(_GROUP_INT_KEYS, widths):
        leaf = g_int[:, off:off + w]
        out[k] = leaf[:, 0] if digest[k].dim() == 1 else leaf
        off += w
    for i, k in enumerate(_GROUP_FLOAT_KEYS):
        out[k] = g_sum[:, i]
    out["read_lat_max"] = g_max[:, len(_GROUP_FLOAT_KEYS)]
    return out


def _to_host(tree: Dict) -> Dict:
    return {k: (_to_host(v) if isinstance(v, dict) else v.cpu().numpy())
            for k, v in tree.items()}


def _nbytes(tree: Dict) -> int:
    return sum(_nbytes(v) if isinstance(v, dict) else v.nbytes
               for v in tree.values())


def _check_ported(spec: MemberSpec) -> None:
    if spec.market != "process" or spec.trace is not None:
        raise NotImplementedError(f"MemberSpec market='trace' {_ITEM8}")
    for name in ("arrivals", "keypop", "faults", "bid_policy"):
        if getattr(spec, name) is not None:
            raise NotImplementedError(f"MemberSpec {name}= {_ITEM8}")


class _Member:
    """Host-side bookkeeping for one fleet slot: its padded static
    tables, initial state, `cfg_c`, controller and reports."""

    def __init__(self, spec: MemberSpec, shapes: FleetShapes, device):
        if spec.mode not in ("bwraft", "raft"):
            raise ValueError(f"mode={spec.mode!r}")
        _check_ported(spec)
        cfg = spec.cfg
        if spec.budget_per_period is not None:
            cfg = dataclasses.replace(
                cfg, budget_per_period=spec.budget_per_period)
        self.spec = spec
        self.cfg = cfg
        self.pads = {
            "pad_nodes": shapes.N - cfg.max_nodes,
            "pad_sites": shapes.S - cfg.num_sites,
            "pad_log": shapes.L - cfg.max_log,
            "pad_keys": shapes.K - cfg.key_space,
            "pad_observers": shapes.O - spec.n_observers,
        }
        if any(p < 0 for p in self.pads.values()):
            raise ValueError(f"member {cfg.name} exceeds fleet shapes "
                             f"{shapes}")
        self.static = state_mod.build_static(
            cfg, pad_nodes=self.pads["pad_nodes"],
            pad_sites=self.pads["pad_sites"],
            n_obs_digest=spec.n_observers,
            pad_obs=self.pads["pad_observers"],
            trace_capacity=shapes.C)
        self.state0 = state_mod.init_state(
            cfg, self.static, device, pad_log=self.pads["pad_log"],
            pad_keys=self.pads["pad_keys"])
        if spec.two_pc_ticks is not None:
            two_pc = spec.two_pc_ticks
        elif spec.group_id >= 0:
            from repro_torch.core.multiraft import two_pc_penalty
            two_pc = two_pc_penalty(cfg)
        else:
            two_pc = 0
        self.two_pc_ticks = int(two_pc)
        self.cfg_c = make_cfg_arrays(
            cfg, device, write_rate=spec.write_rate,
            read_rate=spec.read_rate, phi=spec.phi,
            pad_nodes=self.pads["pad_nodes"],
            pad_sites=self.pads["pad_sites"],
            pad_keys=self.pads["pad_keys"],
            spot_price_vol=spec.spot_price_vol,
            cross_shard_frac=spec.cross_shard_frac, two_pc_ticks=two_pc,
            warning_ticks=spec.warning_ticks,
            bid_on_trace=spec.bid_on_trace,
            n_observers=spec.n_observers,
            pad_observers=self.pads["pad_observers"],
            staleness_bound=spec.staleness_bound,
            ae_interval=spec.ae_interval,
            trace_on=spec.trace_on, trace_mask=spec.trace_mask)
        self.controller = ClusterController(cfg, self.static,
                                            seed=spec.seed)
        if spec.prelease is not None:
            role, alive, sec_of, obs_of = self.controller.lease(
                self.state0["role"].cpu().numpy(),
                self.state0["alive"].cpu().numpy(),
                max(spec.prelease[0], 0), max(spec.prelease[1], 0))
            put = lambda a: torch.as_tensor(a, device=device)
            self.state0 = dict(self.state0, role=put(role),
                               alive=put(alive), sec_of=put(sec_of),
                               obs_of=put(obs_of))
        self.manage = spec.manage
        self.epoch = 0
        self.reports: List[EpochReport] = []


class FleetSim:
    """B independent clusters stepped by one batched tick.

    Per-member dynamics equal a solo `BWRaftSim` with the same padded
    shapes and draws; the control plane runs per member on the host
    between epochs.  Runs on the card unless `device="cpu"`.  `draws`
    is one draw source per member (default `TorchDraws(spec.seed)`)."""

    def __init__(self, specs: Sequence[MemberSpec], *,
                 pipeline: str = "device", device=None, draws=None):
        if pipeline == "host":
            raise NotImplementedError(_ITEM11)
        if pipeline != "device":
            raise ValueError(f"pipeline={pipeline!r}")
        self.pipeline = pipeline
        self.device = resolve_device(device)
        specs = list(specs)
        if not specs:
            raise ValueError("a fleet needs at least one member")
        periods = {s.cfg.period_ticks for s in specs}
        if len(periods) != 1:
            raise ValueError(f"all members must share period_ticks, got "
                             f"{periods}")
        self.shapes = FleetShapes(
            B=len(specs),
            N=max(s.cfg.max_nodes for s in specs),
            S=max(s.cfg.num_sites for s in specs),
            L=max(s.cfg.max_log for s in specs),
            K=max(s.cfg.key_space for s in specs),
            T=periods.pop(),
            O=max(s.n_observers for s in specs),
            C=max(s.trace_capacity for s in specs),
        )
        self.members = [_Member(s, self.shapes, self.device) for s in specs]

        # ---- shard groups (DESIGN.md §9) -----------------------------
        order = sorted({s.group_id for s in specs if s.group_id >= 0})
        self.groups: Dict[int, List[int]] = {
            g: [i for i, s in enumerate(specs) if s.group_id == g]
            for g in order}
        self.n_groups = len(order)
        self._group_chi: Dict[int, float] = {}
        for g, idxs in self.groups.items():
            gspecs = [specs[i] for i in idxs]
            if not all(s.mode == "raft" for s in gspecs):
                raise ValueError(f"group {g}: Multi-Raft shards must be "
                                 f"mode='raft'")
            if any(s.manage for s in gspecs):
                raise ValueError(f"group {g}: shard members must not "
                                 f"manage resources")
            sizes = {s.shards_per_group for s in gspecs}
            if sizes != {len(idxs)}:
                raise ValueError(
                    f"group {g}: declared shards_per_group {sizes} != "
                    f"actual member count {len(idxs)} (ragged-group guard)")
            chis = {s.cross_shard_frac for s in gspecs}
            if len(chis) != 1:
                raise ValueError(f"group {g}: shards disagree on "
                                 f"cross_shard_frac {chis}")
            self._group_chi[g] = chis.pop()
            taxes = {self.members[i].two_pc_ticks for i in idxs}
            if len(taxes) != 1:
                raise ValueError(
                    f"group {g}: shards disagree on two_pc_ticks {taxes} "
                    f"— one 2PC charge per system (DESIGN.md §9)")
        # segment ids: group slot in `order`, or n_groups for ungrouped
        # members (dropped by the group reduction)
        self._gids = torch.tensor(
            [order.index(s.group_id) if s.group_id >= 0 else self.n_groups
             for s in specs], dtype=torch.int32, device=self.device)
        self._group_reports: Dict[int, List] = {g: [] for g in order}

        self._bstatic = state_mod.stack_static(
            [m.static for m in self.members], self.device)
        self._state = state_mod.stack([m.state0 for m in self.members])
        self._cfg_c = state_mod.stack([m.cfg_c for m in self.members])
        for m in self.members:
            m.state0 = None            # stacked; drop the member copies
        if draws is None:
            draws = [TorchDraws(s.seed, self.device) for s in specs]
        self.draws = list(draws)
        if len(self.draws) != len(specs):
            raise ValueError(f"{len(self.draws)} draw sources for "
                             f"{len(specs)} members")
        # cumulative device->host bytes of the epoch digests and trace
        # drains
        self.d2h_bytes = 0
        # the most recent epoch's per-member digest (numpy, leading axis
        # = member) and per-group digest (leading axis = group slot)
        self.last_digest: Optional[Dict] = None
        self.last_group_digest: Optional[Dict] = None
        self._trace_cursors = [trace_export.DrainCursor(member=i)
                               for i in range(len(self.members))]
        self.trace_events: List[trace_export.TraceEvent] = []

    # ------------------------------------------------------------------ #
    @classmethod
    def from_sweep(cls, configs, axes: Optional[Dict] = None, *,
                   pipeline: str = "device", device=None, draws=None,
                   **defaults) -> "FleetSim":
        """Cross-product sweep constructor: one member per config and
        combination of `axes` (MemberSpec field -> values), in
        configs-major, then insertion, order; `defaults` fill the other
        MemberSpec fields."""
        if isinstance(configs, ClusterConfig):
            configs = [configs]
        axes = dict(axes or {})
        for name in axes:
            if name not in _SWEEP_AXES:
                raise ValueError(f"unknown sweep axis {name!r}; valid: "
                                 f"{_SWEEP_AXES}")
        names = list(axes.keys())
        specs = []
        for cfg in configs:
            for combo in itertools.product(*axes.values()):
                specs.append(MemberSpec(cfg=cfg, **defaults,
                                        **dict(zip(names, combo))))
        return cls(specs, pipeline=pipeline, device=device, draws=draws)

    @classmethod
    def sweep(cls, configs, axes: Optional[Dict] = None, *,
              epochs: int = 5, device=None, **defaults
              ) -> List[List[EpochReport]]:
        """One-call sweep: build the fleet and run it.  Returns reports
        indexed [member][epoch]."""
        return cls.from_sweep(configs, axes, device=device,
                              **defaults).run(epochs)

    # ------------------------------------------------------------------ #
    def pads_for(self, i: int) -> Dict[str, int]:
        """Padding a solo BWRaftSim needs to reproduce member i exactly."""
        return dict(self.members[i].pads)

    @property
    def state(self) -> Dict:
        """Batched state (leading axis = member)."""
        return self._state

    def _epoch(self) -> Dict:
        """One device epoch of every member, the group reduction
        included; advances `_state` and returns the digest on the
        device.  Reads nothing on the host."""
        bundle = fleet_epoch(self.draws, self.shapes.T, self._state,
                             self._cfg_c)
        self._state, digest = device_epoch(self._state, self._bstatic,
                                           self._cfg_c, bundle,
                                           self.shapes.T)
        if self.n_groups:
            digest["group"] = _group_digest(digest, self._gids,
                                            self.n_groups)
        return digest

    def _fetch(self, digest: Dict) -> Dict:
        dg = _to_host(digest)
        self.d2h_bytes += _nbytes(dg)
        return dg

    def _append_group_reports(self, gdg: Dict) -> None:
        """One epoch's per-group digest rows (numpy, leading axis = group
        slot) as MultiRaftReports."""
        from repro_torch.core.multiraft import report_from_group_digest
        for slot, g in enumerate(sorted(self.groups)):
            rows = {k: v[slot] for k, v in gdg.items()}
            self._group_reports[g].append(report_from_group_digest(
                len(self._group_reports[g]), rows, self._group_chi[g]))

    @property
    def group_reports(self) -> Dict[int, List]:
        """Per-group `MultiRaftReport` history, keyed by the members'
        `group_id` (DESIGN.md §9)."""
        return {g: list(reps) for g, reps in self._group_reports.items()}

    def _tracing(self) -> bool:
        return bool(self._cfg_c["trace_on"].any())

    def run_epoch(self) -> List[EpochReport]:
        """One epoch of every member: the batched device epoch, one
        digest fetch for all members, then each managing member's control
        plane, whose leases are written back as the managed rows only."""
        dg = self._fetch(self._epoch())
        if self.n_groups:
            self.last_group_digest = dg.pop("group")
            self._append_group_reports(self.last_group_digest)
        self.last_digest = dg
        if self._tracing():
            self.drain_trace()

        managed_rows: List[int] = []
        managed_vals: List[Tuple] = []
        out = []
        for i, m in enumerate(self.members):
            dgi = {k: v[i] for k, v in dg.items()}
            rep = report_from_digest(m.epoch, dgi)
            if m.manage:
                dec = m.controller.decide(
                    rep, float(np.mean(dgi["spot_price"][:m.cfg.num_sites])))
                rep.decision = dec
                managed_rows.append(i)
                # warned secretaries/observers are replaced on top of
                # Algorithm 1's delta and drop out of the wiring (§12)
                warned, roles = dgi["warned"], dgi["role"]
                managed_vals.append(m.controller.lease(
                    dgi["role"], dgi["alive"],
                    max(dec.dk_s, 0) + int(((roles == state_mod.SECRETARY)
                                            & warned).sum()),
                    max(dec.dk_o, 0) + int(((roles == state_mod.OBSERVER)
                                            & warned).sum()),
                    warned=warned))
            m.controller.end_epoch(rep)
            m.epoch += 1
            m.reports.append(rep)
            out.append(rep)
        if managed_rows:
            self._write_rows(managed_rows, managed_vals)
        return out

    def _write_rows(self, rows: List[int], vals: List[Tuple]) -> None:
        """Write (role, alive, sec_of, obs_of) rows back for the members
        in `rows`; the other members' rows stay on the device."""
        idx = torch.tensor(rows, dtype=torch.long, device=self.device)
        for j, name in enumerate(("role", "alive", "sec_of", "obs_of")):
            upd = torch.as_tensor(np.stack([v[j] for v in vals]),
                                  device=self.device)
            self._state[name] = self._state[name].index_copy(0, idx, upd)

    # ------------------------------------------------------------------ #
    def set_trace(self, on: Optional[bool] = None,
                  mask: Optional[Sequence[bool]] = None,
                  members: Optional[Sequence[int]] = None) -> None:
        """Flip the flight recorder for `members` (default: all): a
        `cfg_c` row write (DESIGN.md §14)."""
        idx = torch.tensor(list(range(len(self.members))) if members is None
                           else list(members), dtype=torch.long,
                           device=self.device)
        if on is not None:
            t = self._cfg_c["trace_on"].clone()
            t[idx] = bool(on)
            self._cfg_c["trace_on"] = t
        if mask is not None:
            m = torch.as_tensor(np.asarray(mask, bool), device=self.device)
            if tuple(m.shape) != (trace_ring.NCLASS,):
                raise ValueError(f"trace mask must be "
                                 f"({trace_ring.NCLASS},), got "
                                 f"{tuple(m.shape)}")
            t = self._cfg_c["trace_mask"].clone()
            t[idx] = m
            self._cfg_c["trace_mask"] = t

    def drain_trace(self) -> List[trace_export.TraceEvent]:
        """One fetch of every member's ring and cursors; returns (and
        appends to `trace_events`) the events since the last drain, in
        per-member emission order (DESIGN.md §14)."""
        ev = self._state["trace_ev"].cpu().numpy()
        pos = self._state["trace_pos"].cpu().numpy()
        emit = self._state["trace_emit"].cpu().numpy()
        self.d2h_bytes += ev.nbytes + pos.nbytes + emit.nbytes
        new: List[trace_export.TraceEvent] = []
        for i, cur in enumerate(self._trace_cursors):
            new.extend(cur.drain({"trace_ev": ev[i], "trace_pos": pos[i],
                                  "trace_emit": emit[i]}))
        self.trace_events.extend(new)
        return new

    @property
    def events_dropped(self) -> List[Dict[str, int]]:
        """Exact per-member, per-class ring-overwrite counts."""
        return [c.dropped_by_class() for c in self._trace_cursors]

    def lease_fixed(self, want_sec: int, want_obs: int) -> None:
        """One-shot fixed-role wiring for every member: lease and wire
        `want_sec` secretaries and `want_obs` observers on the host and
        write the four (B, N) role/wiring arrays back — the fixed-role
        sweep recipe (fig12/fig13): one epoch so leadership settles, wire
        once, then run the rest as a single dispatch."""
        role = self._state["role"].cpu().numpy().copy()
        alive = self._state["alive"].cpu().numpy().copy()
        vals = []
        for i, m in enumerate(self.members):
            vals.append(m.controller.lease(role[i], alive[i],
                                           max(want_sec, 0),
                                           max(want_obs, 0)))
        self._write_rows(list(range(len(self.members))), vals)

    # ------------------------------------------------------------------ #
    @property
    def single_dispatch_eligible(self) -> bool:
        """True when `run(E)` can run its E epochs with no host read
        between them: no member runs the per-epoch control plane (the
        bid policies that would also exclude it are not ported)."""
        return not any(m.manage for m in self.members)

    def _run_scan(self, epochs: int) -> None:
        """The multi-epoch path: `epochs` device epochs back to back with
        no host read between them, then the digests fetched once,
        stacked (E, B, ...) — group leaves (E, G, ...)."""
        digests = [self._epoch() for _ in range(epochs)]
        stack = lambda ds: {k: torch.stack([d[k] for d in ds])
                            for k in ds[0]}
        dg = stack([{k: v for k, v in d.items() if k != "group"}
                    for d in digests])
        if self.n_groups:
            dg["group"] = stack([d["group"] for d in digests])
        dg = self._fetch(dg)
        gdg = dg.pop("group") if self.n_groups else None
        self.last_digest = {k: v[-1] for k, v in dg.items()}
        if gdg is not None:
            self.last_group_digest = {k: v[-1] for k, v in gdg.items()}
        for e in range(epochs):
            if gdg is not None:
                self._append_group_reports({k: v[e] for k, v in
                                            gdg.items()})
            for i, m in enumerate(self.members):
                rep = report_from_digest(
                    m.epoch, {k: v[e, i] for k, v in dg.items()})
                m.controller.end_epoch(rep)
                m.epoch += 1
                m.reports.append(rep)
        if self._tracing():
            self.drain_trace()

    def run(self, epochs: int, *,
            single_dispatch: Optional[bool] = None
            ) -> List[List[EpochReport]]:
        """Run `epochs` epochs; returns the reports of this call indexed
        [member][epoch].  `single_dispatch=None` takes the multi-epoch
        path whenever it is eligible; False forces the epoch-by-epoch
        loop, True asserts eligibility."""
        if single_dispatch is None:
            single_dispatch = epochs > 1 and self.single_dispatch_eligible
        if single_dispatch and not self.single_dispatch_eligible:
            raise ValueError("a single-dispatch run needs a fleet with no "
                             "managing member")
        start = len(self.members[0].reports)
        if single_dispatch:
            self._run_scan(epochs)
        else:
            for _ in range(epochs):
                self.run_epoch()
        return [list(m.reports[start:]) for m in self.members]

    @property
    def reports(self) -> List[List[EpochReport]]:
        return [list(m.reports) for m in self.members]


# --------------------------------------------------------------------- #
# the paper's comparison fleets (copies of the benchmarks' builders)
# --------------------------------------------------------------------- #
def system_specs(cfg: ClusterConfig, *, write_rate: float,
                 read_rate: float, seed: int = 0, phi: float = 0.0,
                 shards: int = 2, group_id: int = 0, n_observers: int = 0,
                 staleness_bound: int = 16, ae_interval: int = 4
                 ) -> List[MemberSpec]:
    """The members of one comparison point: BW-Raft (managed), plain
    Raft, and a Multi-Raft system of `shards` shards forming shard group
    `group_id` (DESIGN.md §6.3, §9) — the port's copy of the benchmarks'
    `system_specs` for a closed-loop, process-market point.  The
    digest-tier knobs attach a rack to the BW-Raft member only."""
    from repro_torch.core.multiraft import shard_specs
    return ([MemberSpec(cfg=cfg, mode="bwraft", write_rate=write_rate,
                        read_rate=read_rate, phi=phi, seed=seed,
                        n_observers=n_observers,
                        staleness_bound=staleness_bound,
                        ae_interval=ae_interval),
             MemberSpec(cfg=cfg, mode="raft", write_rate=write_rate,
                        read_rate=read_rate, phi=phi, seed=seed)] +
            shard_specs(cfg, shards=shards, write_rate=write_rate,
                        read_rate=read_rate, seed=seed, group_id=group_id))


def rack_voters(cfg: ClusterConfig) -> int:
    """The voter count the "50X nodes" figure scales its rack by: one
    leader slot plus the followers of every site, sum(1 + followers)."""
    return sum(1 + s.followers for s in cfg.sites)


def digest_rack_spec(cfg: ClusterConfig, *, write_rate: float,
                     read_rate: float, seed: int = 0) -> MemberSpec:
    """BW-Raft with the paper's "50X nodes" digest-observer rack
    (DESIGN.md §13): 50 x `rack_voters(cfg)` slots, a 12-tick staleness
    bound and an anti-entropy round every 4 ticks, as the scale-out
    figure builds it."""
    return MemberSpec(cfg=cfg, mode="bwraft", write_rate=write_rate,
                      read_rate=read_rate, seed=seed,
                      n_observers=50 * rack_voters(cfg),
                      staleness_bound=12, ae_interval=4)
