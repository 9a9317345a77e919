"""Deterministic chaos harness: scripted fault schedules + safety replay
(PyTorch port of `repro.market.chaos`).

A `FaultSchedule` is the fault-injection twin of `traces.MarketTrace`
(DESIGN.md §12): an (M, Tf) bool array `kill[m, t]` raising the
revocation *signal* for node m on tick t.  It rides into the device
program through `cfg_c["fault_trace"]` as a jit argument — swapping
schedules never recompiles — and is subject to the same advance-warning
contract as market revocations: the signal must stay up for
`warning_ticks + 1` consecutive ticks before the kill lands, and a
signal that drops early is a reprieve.  Unlike market columns, fault
columns hit *any* node, including on-demand voters — that is what makes
leader-kill drills expressible.

Builders (`kill_nodes`, `kill_mask`, `mass_kill`, `warning_then_reprieve`)
construct the canonical drill shapes; `run_chaos` replays a schedule
through a host tick loop, snapshotting every tick and checking the
paper's safety properties (`core.invariants.check_all`) plus measuring
recovery: how many ticks the cluster runs leaderless after the first
kill lands.

Module-level code is pure NumPy; `run_chaos` imports `repro_torch.core`
lazily so `repro_torch.market` stays importable from the core layer.
The tick itself reads nothing on the host; the per-tick alive/role
probe and the snapshots are the drill's own reads.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(eq=False)
class FaultSchedule:
    """One scripted fault drill on the tick grid (DESIGN.md §12).

    `kill` is (M, Tf) bool: True raises node m's revocation signal on
    tick t.  The in-step lookup wraps at `cfg_c["fault_len"]` — the
    *fitted* width — so a schedule padded to the full run length is
    one-shot, while a deliberately short schedule repeats.  `eq=False`
    keeps identity hashing so a schedule can ride on a frozen
    `fleet.MemberSpec` field.
    """
    name: str
    kill: np.ndarray

    def __post_init__(self):
        self.kill = np.asarray(self.kill, bool)
        assert self.kill.ndim == 2, self.kill.shape

    @property
    def nodes(self) -> int:
        return self.kill.shape[0]

    @property
    def ticks(self) -> int:
        return self.kill.shape[1]

    def fit_to(self, nodes: int, ticks: int) -> np.ndarray:
        """(nodes, ticks) bool for `cfg_c["fault_trace"]`.  Extra rows
        and columns pad False (inert) — widening a drill to a longer
        run or a padded fleet never invents faults; truncation drops
        the overhang.  Contrast `MarketTrace.fit_to`, which tiles: a
        drill is a one-shot script, not a stationary process."""
        out = np.zeros((nodes, ticks), bool)
        m = min(nodes, self.kill.shape[0])
        t = min(ticks, self.kill.shape[1])
        out[:m, :t] = self.kill[:m, :t]
        return out


# --------------------------------------------------------------------- #
# canonical drill builders
# --------------------------------------------------------------------- #
def kill_nodes(nodes: Sequence[int], at: int, *, n_nodes: int, ticks: int,
               hold: Optional[int] = None, warning_ticks: int = 0,
               name: str = "kill-nodes") -> FaultSchedule:
    """Raise the revocation signal on `nodes` at tick `at`, sustained for
    `hold` ticks.  The kill lands only when ``hold > warning_ticks``
    (the §12 warning contract); the default hold is exactly
    ``warning_ticks + 1``, the minimum that lands."""
    h = int(hold if hold is not None else warning_ticks + 1)
    assert h >= 1 and 0 <= at and at + h <= ticks, (at, h, ticks)
    kill = np.zeros((n_nodes, ticks), bool)
    for n in nodes:
        kill[int(n), at:at + h] = True
    return FaultSchedule(name, kill)


def kill_mask(mask: np.ndarray, at: int, *, ticks: int,
              hold: Optional[int] = None, warning_ticks: int = 0,
              name: str = "kill-mask") -> FaultSchedule:
    """`kill_nodes` with a (n_nodes,) bool mask instead of an index list."""
    mask = np.asarray(mask, bool)
    return kill_nodes(np.where(mask)[0], at, n_nodes=mask.shape[0],
                      ticks=ticks, hold=hold, warning_ticks=warning_ticks,
                      name=name)


def mass_kill(at: int, *, n_nodes: int, ticks: int,
              spare: Sequence[int] = (), hold: Optional[int] = None,
              warning_ticks: int = 0) -> FaultSchedule:
    """Correlated mass revocation: every node except `spare` gets the
    signal at tick `at` — the phi=1-style drill, but scripted and
    warned.  Spare at least a quorum of voters to keep the run
    recoverable."""
    mask = np.ones(n_nodes, bool)
    mask[list(spare)] = False
    return kill_mask(mask, at, ticks=ticks, hold=hold,
                     warning_ticks=warning_ticks, name="mass-kill")


def warning_then_reprieve(nodes: Sequence[int], at: int, *, n_nodes: int,
                          ticks: int, warning_ticks: int,
                          hold: Optional[int] = None) -> FaultSchedule:
    """The price-dips-back drill: the signal rises at `at` but drops
    after `hold` ticks (default `warning_ticks`, one short of landing),
    so the warned node degrades, is re-leased around, and then resumes
    — no kill ever lands.  Requires ``warning_ticks >= 1``."""
    assert warning_ticks >= 1, "W=0 has no window to reprieve inside"
    h = int(hold if hold is not None else warning_ticks)
    assert 1 <= h <= warning_ticks, (h, warning_ticks)
    return kill_nodes(nodes, at, n_nodes=n_nodes, ticks=ticks, hold=h,
                      warning_ticks=0, name="warning-then-reprieve")


# --------------------------------------------------------------------- #
# the replay harness
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class ChaosReport:
    """What one chaos replay observed (for tests and BENCH_faults.json)."""
    name: str
    ticks: int
    warning_ticks: int
    first_kill_tick: int          # -1: nothing ever died
    killed_total: int
    recovery_ticks: int           # first leaderless span after first kill
    max_leaderless_span: int
    leader_uptime: float          # fraction of ticks with an alive leader
    alive_end: int
    safety_error: Optional[str]   # None = all §3 properties held
    trace: List[Dict[str, np.ndarray]] = dataclasses.field(
        default_factory=list, repr=False)
    # flight-recorder capture (DESIGN.md §14, `trace_on=True` only):
    # decoded events, exact per-class ring-overwrite counts, whether the
    # trace-replayed leader timeline matches the harness's per-tick
    # alive-leader probe bit for bit, and the Perfetto artifact path
    events: List = dataclasses.field(default_factory=list, repr=False)
    events_dropped: Optional[Dict[str, int]] = None
    trace_leader_match: Optional[bool] = None
    perfetto_path: Optional[str] = None


def run_chaos(cfg, faults: FaultSchedule, *, warning_ticks: int = 0,
              ticks: Optional[int] = None, seed: int = 0, phi: float = 0.0,
              write_rate: float = 8.0, read_rate: float = 16.0,
              lease: Optional[Sequence[int]] = (4, 6), every: int = 1,
              spot_bid=None, check: bool = True, trace_on: bool = False,
              trace_capacity: int = 1024,
              trace_out: Optional[str] = None, device=None,
              draws=None) -> ChaosReport:
    """Replay a `FaultSchedule` through a host tick loop and audit it.

    Builds a `runtime.BWRaftSim` carrying the schedule (so the exact
    same `cfg_c` plumbing the benchmarks use is what the harness
    exercises), leases `lease` secretaries/observers, then drives
    `step.tick` directly for `ticks` ticks (default: the schedule's
    width), one draw row per tick from the source's `tick()` (default
    `TorchDraws(seed)`; the JAX harness splits `PRNGKey(seed)` once per
    tick, which is the tests' `JaxTape.tick`), snapshotting every
    `every` ticks.  Checks every paper safety property over the
    snapshot trace (`invariants.check_all` — raises when `check`, else
    records the violation) and measures recovery: how many ticks elapse
    from the first landed kill until an alive leader exists again (0
    when the kill never takes the leader).

    Pass a large `spot_bid` (say 10x the mean price) to silence
    market-driven revocations so the scripted schedule is the only
    fault source.

    `trace_on=True` arms the flight recorder (DESIGN.md §14) and drains
    the ring every tick: the report gains the decoded events, the exact
    per-class overwrite counts, and `trace_leader_match` — whether the
    trace-replayed leader timeline (`trace.export.leader_timeline`)
    reproduces the harness's per-tick alive-leader probe bit for bit.
    `trace_out` additionally writes the Perfetto artifact.  Runs on the
    card unless `device="cpu"`."""
    from repro_torch.core import invariants
    from repro_torch.core import runtime as RT
    from repro_torch.core import state as SM
    from repro_torch.core.draws import row
    from repro_torch.trace import export as trace_export

    T = int(ticks if ticks is not None else faults.ticks)
    sim = RT.BWRaftSim(cfg, write_rate=write_rate, read_rate=read_rate,
                       phi=phi, seed=seed, warning_ticks=warning_ticks,
                       faults=faults, fault_ticks=T, spot_bid=spot_bid,
                       trace_on=trace_on, trace_capacity=trace_capacity,
                       device=device, draws=draws)
    if lease is not None:
        sim._lease(*lease)
    static = sim.static

    prev_alive = sim.state["alive"].cpu().numpy().copy()
    trace: List[Dict[str, np.ndarray]] = []
    leader_up: List[bool] = []
    first_kill, killed_total = -1, 0
    cursor = trace_export.DrainCursor()
    events: List[trace_export.TraceEvent] = []
    for t in range(T):
        RT.run_tick(sim, row(sim.draws.tick(sim.state, sim.cfg_c), 0))
        alive = sim.state["alive"].cpu().numpy()
        role = sim.state["role"].cpu().numpy()
        newly_dead = int((prev_alive & ~alive).sum())
        killed_total += newly_dead
        if newly_dead and first_kill < 0:
            first_kill = t
        prev_alive = alive.copy()
        leader_up.append(bool(((role == SM.LEADER) & alive).any()))
        if trace_on:
            events.extend(cursor.drain(sim.state))
        if t % every == 0:
            trace.append(invariants.snapshot(sim.state))

    # recovery: ticks from the first landed kill until a leader exists
    recovery, span, max_span = 0, 0, 0
    for t in range(T):
        span = span + 1 if not leader_up[t] else 0
        max_span = max(max_span, span)
    if first_kill >= 0:
        t = first_kill
        while t < T and not leader_up[t]:
            t += 1
        recovery = t - first_kill

    error: Optional[str] = None
    try:
        invariants.check_all(trace)
    except AssertionError as exc:      # pragma: no cover - violation path
        if check:
            raise
        error = str(exc)

    leader_match: Optional[bool] = None
    perfetto_path: Optional[str] = None
    if trace_on:
        up = trace_export.leader_timeline(events, T)
        leader_match = bool((up == np.asarray(leader_up, bool)).all())
        if trace_out is not None:
            trace_export.write_perfetto(
                events, trace_out, ticks=T,
                sites={0: np.asarray(static["site"])},
                obs_site={0: np.asarray(static["dobs_site"])})
            perfetto_path = str(trace_out)

    return ChaosReport(
        name=faults.name, ticks=T, warning_ticks=int(warning_ticks),
        first_kill_tick=first_kill, killed_total=killed_total,
        recovery_ticks=recovery, max_leaderless_span=max_span,
        leader_uptime=float(np.mean(leader_up)) if leader_up else 1.0,
        alive_end=int(sim.state["alive"].sum()),
        safety_error=error, trace=trace, events=events,
        events_dropped=cursor.dropped_by_class() if trace_on else None,
        trace_leader_match=leader_match, perfetto_path=perfetto_path)
