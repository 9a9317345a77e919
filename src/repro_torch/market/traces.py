"""Replayable market traces: the (S, T) arrays every provider compiles to
(a copy of `repro.market.traces`; the two sample traces are copies too,
under this package's ``market/traces/``).

The market provider contract (DESIGN.md §10): whatever the source — the
synthetic processes in `market/synthetic.py`, an AWS spot-price history,
a Google cluster-trace preemption log — a market is materialized as a
`MarketTrace`: a per-site price series `price[s, t]` (float32, (S, T))
and a per-site revocation schedule `revoked[s, t]` (bool, (S, T)) on the
simulator's tick grid.  The tick replays it verbatim (`step.spot_step`
indexes column `tick % T`), so a trace is ground truth: no clamping, no
re-noising, no RNG at replay time.

External-format loaders live here too:

  `load_aws_spot_history`      AWS ``describe-spot-price-history`` JSON
  `load_google_cluster_events` Google cluster-trace task-event slices

both resampled onto the tick grid by the §10 rule — zero-order hold for
prices, event→tick bucketing for revocations — plus a registry of small
sample traces committed under ``market/traces/`` (`load`,
`available_traces`) so examples/benchmarks run offline.
"""
from __future__ import annotations

import csv
import dataclasses
import datetime
import json
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, Tuple

import numpy as np

TRACES_DIR = Path(__file__).resolve().parent / "traces"

# Google cluster-trace task event types (subset we care about)
GOOGLE_EVICT = 2


@dataclasses.dataclass(eq=False)
class MarketTrace:
    """One replayable market on the tick grid (DESIGN.md §10).

    `price` is (S, T) float32 — the spot price at site s during tick t —
    and `revoked` is (S, T) bool — True revokes (kills) every spot node
    at site s on tick t.  `eq=False` keeps identity hashing so a trace
    can ride on a frozen `fleet.MemberSpec` field.

    `revoked_node` (optional, (M, T) bool) carries *per-node* revocation
    columns (DESIGN.md §12): row m revokes only the single node it maps
    to, not the whole site — the event-bucket resampling at machine
    granularity instead of the site broadcast.  When present,
    `runtime.make_cfg_arrays` fits it to the simulator's node axis
    (`node_columns`) and `step.spot_step` reads it in place of the site
    signal; None keeps the frozen site-level semantics.
    """
    name: str
    price: np.ndarray
    revoked: np.ndarray
    revoked_node: np.ndarray = None         # optional (M, T) bool

    def __post_init__(self):
        self.price = np.asarray(self.price, np.float32)
        self.revoked = np.asarray(self.revoked, bool)
        assert self.price.ndim == 2, self.price.shape
        assert self.price.shape == self.revoked.shape, \
            (self.price.shape, self.revoked.shape)
        if self.revoked_node is not None:
            self.revoked_node = np.asarray(self.revoked_node, bool)
            assert self.revoked_node.ndim == 2, self.revoked_node.shape
            assert self.revoked_node.shape[1] == self.ticks, \
                (self.revoked_node.shape, self.ticks)

    @property
    def sites(self) -> int:
        return self.price.shape[0]

    @property
    def ticks(self) -> int:
        return self.price.shape[1]

    def fit_to(self, sites: int, ticks: int) -> "MarketTrace":
        """Re-shape onto a target (sites, ticks) grid: site s reads source
        row ``s % S0`` (round-robin tiling, the same rule `state.
        build_static` uses to map spot slots onto sites) and tick t reads
        source column ``t % T0`` (wrap).  Widening is replay-neutral:
        the in-step lookup wraps at the member's own source length
        (`cfg_c["trace_len"]`, kept by `make_cfg_arrays`), not at the
        widened array width, so the tiled tail is never read out of
        phase (DESIGN.md §10)."""
        s_idx = np.arange(sites) % self.sites
        t_idx = np.arange(ticks) % self.ticks
        grid = np.ix_(s_idx, t_idx)
        node = None
        if self.revoked_node is not None:
            m_idx = np.arange(self.revoked_node.shape[0])
            node = self.revoked_node[np.ix_(m_idx, t_idx)]
        return MarketTrace(self.name, self.price[grid], self.revoked[grid],
                           node)

    def node_columns(self, nodes: int, ticks: int) -> np.ndarray:
        """Per-node revocation columns fitted to the simulator's
        (nodes, ticks) grid (DESIGN.md §12): node n reads source row
        ``n % M`` (round-robin, the site-tiling rule applied to
        machines) and tick t reads source column ``t % T`` (the §10
        time wrap — the in-step lookup shares `cfg_c["trace_len"]` with
        the site arrays)."""
        assert self.revoked_node is not None, \
            f"trace {self.name!r} carries no per-node columns"
        M = self.revoked_node.shape[0]
        n_idx = np.arange(nodes) % M
        t_idx = np.arange(ticks) % self.revoked_node.shape[1]
        return self.revoked_node[np.ix_(n_idx, t_idx)]

    def empirical_revocation_rates(self) -> np.ndarray:
        """Per-site per-tick revocation hazard — the calibration target
        for `market.calibrate` (DESIGN.md §10)."""
        return self.revoked.mean(axis=1)


# --------------------------------------------------------------------- #
# resampling (the §10 rule)
# --------------------------------------------------------------------- #
def resample_price(times: np.ndarray, values: np.ndarray,
                   ticks: int, span: Tuple[float, float]) -> np.ndarray:
    """Zero-order hold of an irregular price series onto `ticks` uniform
    tick instants spanning ``[span[0], span[1]]``: tick k takes the last
    observation at or before its wall-clock instant (the first
    observation when k precedes them all).  This is the §10 price
    resampling rule."""
    times = np.asarray(times, float)
    values = np.asarray(values, float)
    order = np.argsort(times, kind="stable")
    times, values = times[order], values[order]
    grid = np.linspace(span[0], span[1], ticks)
    idx = np.clip(np.searchsorted(times, grid, side="right") - 1,
                  0, len(times) - 1)
    return values[idx]


def bucket_events(times: np.ndarray, ticks: int,
                  span: Tuple[float, float]) -> np.ndarray:
    """Event→tick bucketing (the §10 revocation resampling rule): an
    event at wall time tau marks tick ``floor((tau - t0)/(t1 - t0) *
    ticks)`` (clipped to [0, ticks-1]) as revoked."""
    out = np.zeros(ticks, bool)
    t0, t1 = span
    width = max(t1 - t0, 1e-12)
    for tau in np.asarray(times, float):
        out[int(np.clip((tau - t0) / width * ticks, 0, ticks - 1))] = True
    return out


def _iso_ts(ts: str) -> float:
    return datetime.datetime.fromisoformat(
        ts.replace("Z", "+00:00")).timestamp()


# --------------------------------------------------------------------- #
# external trace formats
# --------------------------------------------------------------------- #
def load_aws_spot_history(path, *, ticks: int = 600,
                          bid_multiplier: float = 1.5) -> MarketTrace:
    """AWS ``aws ec2 describe-spot-price-history`` JSON → MarketTrace.

    Records are grouped by ``AvailabilityZone`` (one site per AZ, sorted
    by name), each AZ's step-function price is zero-order-held onto the
    shared tick grid spanning the trace's full wall-clock range, and
    revocations are derived by the in-sim bid rule: a site is revoked on
    any tick whose price exceeds ``bid_multiplier`` × that AZ's mean
    price (the same 1.5× rule `state.init_state` bids with —
    DESIGN.md §10)."""
    data = json.loads(Path(path).read_text())
    per_az: Dict[str, list] = defaultdict(list)
    for rec in data["SpotPriceHistory"]:
        per_az[rec["AvailabilityZone"]].append(
            (_iso_ts(rec["Timestamp"]), float(rec["SpotPrice"])))
    assert per_az, f"no SpotPriceHistory records in {path}"
    azs = sorted(per_az)
    all_times = [t for recs in per_az.values() for t, _ in recs]
    span = (min(all_times), max(all_times))
    price = np.stack([
        resample_price(np.array([t for t, _ in per_az[az]]),
                       np.array([p for _, p in per_az[az]]),
                       ticks, span)
        for az in azs]).astype(np.float32)
    bid = bid_multiplier * price.mean(axis=1, keepdims=True)
    return MarketTrace(Path(path).stem, price, price > bid)


def load_google_cluster_events(path, *, ticks: int = 600,
                               sites: int = 0,
                               price_mean: float = 0.0125,
                               node_rows: int = 0) -> MarketTrace:
    """Google cluster-trace task-event slice (CSV with a
    ``time_us,machine_id,event_type`` header) → MarketTrace.

    Machines hash onto ``sites`` rows round-robin by first-seen rank
    (0 → one site per distinct machine, capped at 4); every EVICT
    (event_type 2) marks its tick revoked at the machine's site by the
    §10 bucketing rule.  The trace records preemptions, not prices, so
    the price rows are flat at `price_mean` — pair with an AWS price
    trace or a synthetic walk when price dynamics matter.

    ``node_rows > 0`` additionally buckets each machine's evictions at
    machine granularity into `revoked_node` (DESIGN.md §12): machine
    rank m lands in row ``m % node_rows``, so a single eviction kills
    one simulated node instead of broadcasting over its whole site —
    the per-node fault model the warning window degrades through."""
    events = []
    machines: Dict[str, int] = {}
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            mid = row["machine_id"]
            if mid not in machines:
                machines[mid] = len(machines)
            if int(row["event_type"]) == GOOGLE_EVICT:
                events.append((float(row["time_us"]), machines[mid]))
    assert machines, f"no events in {path}"
    S = sites if sites > 0 else min(len(machines), 4)
    all_times = [t for t, _ in events]
    span = (min(all_times), max(all_times)) if events else (0.0, 1.0)
    revoked = np.zeros((S, ticks), bool)
    for s in range(S):
        site_times = [t for t, m in events if m % S == s]
        if site_times:
            revoked[s] = bucket_events(np.array(site_times), ticks, span)
    price = np.full((S, ticks), price_mean, np.float32)
    revoked_node = None
    if node_rows > 0:
        revoked_node = np.zeros((node_rows, ticks), bool)
        for n in range(node_rows):
            node_times = [t for t, m in events if m % node_rows == n]
            if node_times:
                revoked_node[n] = bucket_events(np.array(node_times),
                                                ticks, span)
    return MarketTrace(Path(path).stem, price, revoked, revoked_node)


# --------------------------------------------------------------------- #
# bundled sample traces (committed under market/traces/)
# --------------------------------------------------------------------- #
_BUNDLED: Dict[str, Tuple[str, Callable]] = {
    "aws-us-east": ("aws_spot_us_east.json", load_aws_spot_history),
    "google-evict": ("google_cluster_evictions.csv",
                     load_google_cluster_events),
}


def available_traces() -> Tuple[str, ...]:
    """Names accepted by `load` (and the example's ``--trace`` flag)."""
    return tuple(sorted(_BUNDLED))


def load(name: str, *, ticks: int = 600, **kwargs) -> MarketTrace:
    """Load a bundled sample trace by registry name, resampled onto
    `ticks` ticks.  Extra kwargs go to the format loader."""
    if name not in _BUNDLED:
        raise KeyError(
            f"unknown trace {name!r}; available: {available_traces()}")
    fname, loader = _BUNDLED[name]
    trace = loader(TRACES_DIR / fname, ticks=ticks, **kwargs)
    trace.name = name
    return trace
