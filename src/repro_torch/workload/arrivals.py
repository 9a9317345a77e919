"""Open-loop arrival processes: rate curves that ride in `cfg_c` (a copy
of `repro.workload.arrivals`).

The closed-loop knob (`cfg_c["write_rate"]` / `["read_rate"]`, one scalar
per epoch) models a fixed-intensity client population; the paper's SLO-
goodput claim is about *open-loop* traffic — arrivals that keep coming at
the schedule's rate whether or not the service keeps up, so queues (and
tails) grow when capacity is exceeded.  Every provider here materializes
to a per-tick rate curve, a plain ``(Ta,)`` float32 array that enters the
compiled program as a jit *argument* — exactly the way market traces do
(DESIGN.md §10) — so swapping arrival schedules at one shape never
recompiles (DESIGN.md §11).

Providers (`materialize(ticks) -> (ticks,) np.float32`):

  `ConstantRate`   the open-loop twin of the closed-loop scalar knob
  `DiurnalRate`    sinusoidal day/night load curve around a base rate
  `FlashCrowd`     a base curve plus multiplicative burst windows — the
                   flash-crowd spikes that stress the p95 deadline

`OpenLoop` bundles a write curve + read curve into the arrival plan that
`runtime.make_cfg_arrays(arrivals=...)` compiles into cfg_c; `fit_to`
wraps a plan to a fleet-shared width the way `MarketTrace.fit_to` wraps
trace columns (the in-step lookup wraps at the plan's OWN length, a jit
argument, so widening is replay-neutral — DESIGN.md §11).

`ZipfianKeys` is the key-popularity side of the open-loop contract: a
``(K,)`` CDF riding in cfg_c; the leader samples write keys from it by
inverse transform, matching `scipy.stats.zipfian(a=s, n=K)` in
distribution (the JAX package's workload tests pin the frequency ranks).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np

Curve = Union["RateProcess", np.ndarray]


class RateProcess:
    """Base marker: providers expose `materialize(ticks) -> (ticks,)`."""

    def materialize(self, ticks: int) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ConstantRate(RateProcess):
    """Flat open-loop rate — `rate` expected arrivals per tick."""
    rate: float

    def materialize(self, ticks: int) -> np.ndarray:
        assert ticks >= 1, ticks
        return np.full((ticks,), max(self.rate, 0.0), np.float32)


@dataclasses.dataclass(frozen=True)
class DiurnalRate(RateProcess):
    """Sinusoidal day/night curve: ``base * (1 + amplitude*sin(2πt/P))``,
    floored at zero.  `period_ticks` is the diurnal period (defaults to
    the materialized length, one full day per plan)."""
    base: float
    amplitude: float = 0.5
    period_ticks: Optional[int] = None
    phase: float = 0.0

    def materialize(self, ticks: int) -> np.ndarray:
        assert ticks >= 1, ticks
        period = self.period_ticks or ticks
        t = np.arange(ticks, dtype=np.float64)
        curve = self.base * (1.0 + self.amplitude *
                             np.sin(2.0 * np.pi * t / period + self.phase))
        return np.maximum(curve, 0.0).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class FlashCrowd(RateProcess):
    """A base curve with multiplicative burst windows: every
    `every_ticks` ticks the rate jumps to ``mult`` x base for
    `burst_ticks` ticks — the flash-crowd arrival spikes whose queueing
    tail the p95 deadline exists to measure."""
    base: Curve
    mult: float = 8.0
    every_ticks: int = 50
    burst_ticks: int = 5
    offset: int = 0

    def materialize(self, ticks: int) -> np.ndarray:
        assert self.every_ticks >= 1 and self.burst_ticks >= 0
        base = materialize_curve(self.base, ticks)
        t = (np.arange(ticks) - self.offset) % self.every_ticks
        burst = t < self.burst_ticks
        return np.where(burst, base * self.mult, base).astype(np.float32)


def materialize_curve(curve: Curve, ticks: int) -> np.ndarray:
    """A provider or a raw array -> validated (ticks,) float32 curve."""
    if isinstance(curve, RateProcess):
        out = curve.materialize(ticks)
    else:
        out = np.asarray(curve, np.float32)
    assert out.ndim == 1 and out.shape[0] == ticks, \
        f"curve shape {out.shape} != ({ticks},)"
    assert np.all(out >= 0.0), "arrival rates must be non-negative"
    return out.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class OpenLoop:
    """One arrival plan: a write curve + a read curve over `ticks` ticks.

    This is the object `runtime.make_cfg_arrays(arrivals=...)` compiles
    into the `cfg_c` arrival arrays (DESIGN.md §11).  The in-step lookup
    wraps at `ticks` (the plan's own period, a jit argument), so a short
    plan repeats across epochs and `fit_to`-widened copies replay the
    same schedule bit-for-bit.
    """
    write: Curve
    read: Curve
    ticks: int

    def materialize(self) -> Tuple[np.ndarray, np.ndarray]:
        return (materialize_curve(self.write, self.ticks),
                materialize_curve(self.read, self.ticks))

    def scaled(self, write_factor: float = 1.0, read_factor: float = 1.0
               ) -> "OpenLoop":
        """The same schedule at scaled intensity — how one system-wide
        plan divides over Multi-Raft shards (`multiraft.shard_workload`
        factors) while keeping the diurnal/burst *shape* intact."""
        w, r = self.materialize()
        return OpenLoop(write=(w * write_factor).astype(np.float32),
                        read=(r * read_factor).astype(np.float32),
                        ticks=self.ticks)

    def fit_to(self, width: int) -> Tuple[np.ndarray, np.ndarray, int]:
        """(write_curve, read_curve, arrival_len) at a fleet-shared
        `width` >= 1: curves tile cyclically (`np.resize`) and
        `arrival_len = min(self.ticks, width)` keeps the in-step modulo
        lookup on this plan's own columns — the same replay-neutral
        widening rule as `MarketTrace.fit_to` (DESIGN.md §10/§11)."""
        assert width >= 1, width
        w, r = self.materialize()
        return (np.resize(w, width).astype(np.float32),
                np.resize(r, width).astype(np.float32),
                min(self.ticks, width))


@dataclasses.dataclass(frozen=True)
class ZipfianKeys:
    """Zipfian key popularity: P(key=k) ∝ 1/(k+1)^s over the real key
    space, key 0 hottest.  Materializes to the (K,) inclusive CDF the
    leader samples write keys from by inverse transform
    (`step.leader_step`, DESIGN.md §11); matches
    `scipy.stats.zipfian(a=s, n=n_keys)` in distribution."""
    s: float = 1.1

    def materialize(self, n_keys: int, pad_keys: int = 0) -> np.ndarray:
        assert n_keys >= 1, n_keys
        ranks = np.arange(1, n_keys + 1, dtype=np.float64)
        p = ranks ** (-self.s)
        cdf = np.cumsum(p / p.sum())
        cdf[-1] = 1.0
        # padded key-space tail: CDF saturated at 1.0 -> never sampled
        return np.concatenate(
            [cdf, np.ones((pad_keys,))]).astype(np.float32)


def uniform_key_cdf(n_keys: int, pad_keys: int = 0) -> np.ndarray:
    """The inert (K,) CDF closed-loop members carry: uniform over the
    real key space, saturated over the padded tail.  Never *sampled*
    when `cfg_c["key_zipf"]` is off — it exists so the cfg_c pytree has
    one stackable shape per fleet (DESIGN.md §11)."""
    assert n_keys >= 1, n_keys
    cdf = (np.arange(1, n_keys + 1, dtype=np.float64) / n_keys)
    return np.concatenate([cdf, np.ones((pad_keys,))]).astype(np.float32)


def host_poisson_totals(curve: np.ndarray, arrival_len: int, ticks: int,
                        ) -> float:
    """Host-side generator twin for the conservation property test: the
    expected arrival total of an open-loop run of `ticks` ticks is the
    sum of the wrapped curve, against which the device path's Poisson
    totals are checked within sampling error."""
    curve = np.asarray(curve, np.float64)
    idx = np.arange(ticks) % arrival_len
    return float(curve[idx].sum())
