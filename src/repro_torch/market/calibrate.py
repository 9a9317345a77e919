"""Calibrating the control plane against a market trace (DESIGN.md §10),
a copy of `repro.market.calibrate` over the port's `core/manager`.

Two fits, both against the (S, T) arrays of a `traces.MarketTrace`:

  `calibrate_predictor`  fit `manager.RevocationPredictor` (the SpotTune
                         stand-in Algorithm 1 scores offers with): pick
                         the EWMA alpha minimizing one-step-ahead error
                         on the trace's per-epoch per-site revocation
                         rates, seed the rate vector from the data, and
                         report the residual calibration error.
  `fit_walk`             moment-match the synthetic walk (mean via the
                         sample mean, vol by inverting the walk's
                         residual ``p[t+1] - p[t] - 0.2*(mean - p[t]) =
                         0.15*vol*mean*noise``) so process-mode sweeps
                         can run at trace-calibrated parameters.

Pure NumPy — this is host-side control-plane tooling, like `manager`.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from repro_torch.core.manager import RevocationPredictor
from repro_torch.market.traces import MarketTrace

DEFAULT_ALPHAS = (0.05, 0.1, 0.2, 0.3, 0.5, 0.7, 0.9)


@dataclasses.dataclass
class CalibrationReport:
    """What a fit achieved, for `BENCH_market.json` and the tests."""
    trace: str
    alpha: float                 # chosen EWMA smoothing
    empirical: np.ndarray        # (S,) per-tick revocation hazard
    fitted: np.ndarray           # (S,) predictor rates after the fit
    mae: float                   # mean |fitted - empirical|
    one_step_mse: float          # best one-step-ahead MSE over epochs


def epoch_revocation_rates(trace: MarketTrace, period_ticks: int
                           ) -> np.ndarray:
    """(E, S) per-epoch per-site revocation rates — the fraction of each
    epoch's ticks a site spends revoked, i.e. exactly what the manager's
    per-epoch "peek" observes.  Uses the whole epochs only (the ragged
    tail is dropped); needs at least one full epoch."""
    E = trace.ticks // period_ticks
    assert E >= 1, (trace.ticks, period_ticks)
    r = trace.revoked[:, :E * period_ticks]
    return r.reshape(trace.sites, E, period_ticks).mean(axis=2).T


def calibrate_predictor(trace: MarketTrace, period_ticks: int, *,
                        alphas: Sequence[float] = DEFAULT_ALPHAS,
                        prior: float = 0.02
                        ) -> Tuple[RevocationPredictor, CalibrationReport]:
    """Fit `RevocationPredictor` to a trace: replay the trace's per-epoch
    revocation rates through the EWMA for every candidate alpha, score
    each by one-step-ahead MSE (predict *before* updating — exactly the
    order Algorithm 1 consumes the predictor in), keep the best, and
    report the calibration error of the final rates against the trace's
    overall empirical hazard."""
    obs = epoch_revocation_rates(trace, period_ticks)       # (E, S)
    S = trace.sites
    leased = np.ones(S)

    def replay(alpha: float) -> Tuple[RevocationPredictor, float]:
        p = RevocationPredictor(S, alpha=alpha, prior=prior)
        err = 0.0
        for e in range(obs.shape[0]):
            err += float(np.mean((p.predict() - obs[e]) ** 2))
            p.update(obs[e], leased)
        return p, err / obs.shape[0]

    scored = [(replay(a), a) for a in alphas]
    (predictor, mse), alpha = min(scored, key=lambda t: t[0][1])
    empirical = trace.empirical_revocation_rates()
    report = CalibrationReport(
        trace=trace.name, alpha=float(alpha), empirical=empirical,
        fitted=predictor.predict(),
        mae=float(np.mean(np.abs(predictor.predict() - empirical))),
        one_step_mse=float(mse))
    return predictor, report


def sliding_window_rates(trace: MarketTrace, end_tick: int,
                         window_ticks: int) -> np.ndarray:
    """(S,) empirical revocation rates over the trailing `window_ticks`
    ticks ending at `end_tick` (exclusive), read through the §10 time
    wrap (``t % T``) so a recalibration window keeps sliding on runs
    longer than the trace.  ``end_tick <= 0`` or a window at least the
    trace length degrades to the full-trace rates — the same target
    `calibrate_predictor` fits against."""
    T = trace.ticks
    if end_tick <= 0 or window_ticks >= T:
        return trace.empirical_revocation_rates()
    idx = np.arange(end_tick - window_ticks, end_tick) % T
    return trace.revoked[:, idx].mean(axis=1)


@dataclasses.dataclass(eq=False)
class HazardAwareBid:
    """Per-epoch hazard-aware bidding policy (DESIGN.md §12).

    Maps a per-site revocation hazard to a per-site bid as a multiple
    of the site's mean price: a calm site (hazard 0) bids
    ``high_mult * mean`` (bid up: out-wait transient spikes), a hot
    site (hazard >= `hazard_ref`) bids ``low_mult * mean`` (shed:
    surrender early rather than ride the spike into an unwarned kill),
    with linear interpolation between.  The hazard source is the
    trailing-window trace rates (`sliding_window_rates`) when
    `window_ticks` > 0 and a trace is at hand, else the manager's
    `RevocationPredictor` — the same signal Algorithm 1 peeks.

    Bids are *data*: `runtime.BWRaftSim`/`fleet.FleetSim` call
    `update` once per epoch and write the result into
    ``cfg_c["spot_bid"]``, so sweeping policies never recompiles.
    `eq=False` keeps identity hashing for `fleet.MemberSpec`.
    """
    mean_price: np.ndarray            # (S,) per-site mean prices
    low_mult: float = 1.1             # shed bid at/above hazard_ref
    high_mult: float = 2.5            # bid-up bid at hazard 0
    hazard_ref: float = 0.05          # hazard that pins the shed bid
    window_ticks: int = 0             # 0: predictor; >0: trailing window

    def __post_init__(self):
        self.mean_price = np.atleast_1d(
            np.asarray(self.mean_price, np.float64))

    def bids(self, hazard: np.ndarray) -> np.ndarray:
        """(S,) bids for (S,) hazards by the interpolation rule."""
        frac = np.clip(np.asarray(hazard, np.float64)
                       / max(self.hazard_ref, 1e-9), 0.0, 1.0)
        mult = self.high_mult - frac * (self.high_mult - self.low_mult)
        mean = self.mean_price
        if mean.shape[0] < frac.shape[0]:       # repeat-last, like pads
            mean = np.concatenate(
                [mean, np.full(frac.shape[0] - mean.shape[0], mean[-1])])
        return (mult * mean[:frac.shape[0]]).astype(np.float32)

    def update(self, *, predictor=None, trace: MarketTrace = None,
               end_tick: int = 0, sites: int = 0) -> np.ndarray:
        """Recalibrate and return the (sites,) bid vector for the next
        epoch.  Hazard rows tile onto sites by ``s % len`` (the site
        round-robin rule)."""
        if self.window_ticks > 0 and trace is not None:
            hazard = sliding_window_rates(trace, end_tick,
                                          self.window_ticks)
        elif predictor is not None:
            hazard = np.asarray(predictor.predict())
        else:
            hazard = np.zeros(max(sites, 1))
        S = sites if sites > 0 else hazard.shape[0]
        return self.bids(hazard[np.arange(S) % hazard.shape[0]])


@dataclasses.dataclass
class WalkFit:
    """Moment-matched walk parameters recovered from a price trace."""
    trace: str
    mean: np.ndarray             # (S,) fitted reversion targets
    vol: float                   # fitted relative volatility (pooled)
    vol_per_site: np.ndarray     # (S,)
    # one-step fit quality: 1 - SSE(fitted reversion)/SSE(hold-last-price)
    # — the share of one-step price variance the fitted mean reversion
    # explains beyond predicting "price stays put".  > 0 means the walk
    # structure is present in the trace; ~0 means a driftless random
    # walk fits as well and the recovered mean/vol should be distrusted.
    reversion_r2: float


def fit_walk(trace: MarketTrace) -> WalkFit:
    """Invert the walk recurrence on a price trace: the reversion target
    is the per-site sample mean, and since the one-step residual of the
    true walk is ``0.15 * vol * mean * N(0,1)`` (away from the price
    floor), ``vol ≈ std(residual) / (0.15 * mean)`` per site.  Floor-
    clamped ticks are excluded from the residual (the clamp truncates
    the noise and would bias vol low).  `reversion_r2` scores the fit
    against the hold-last-price null model."""
    p = np.asarray(trace.price, np.float64)
    mean = p.mean(axis=1)
    resid = p[:, 1:] - (p[:, :-1] + 0.2 * (mean[:, None] - p[:, :-1]))
    off_floor = p[:, 1:] > 0.1 * mean[:, None] * (1 + 1e-6)
    vol_site = np.array([
        resid[s][off_floor[s]].std() / (0.15 * max(mean[s], 1e-9))
        if off_floor[s].any() else 0.0
        for s in range(trace.sites)])
    hold_err = p[:, 1:] - p[:, :-1]
    r2 = 1.0 - float(np.sum(resid ** 2)) / \
        max(float(np.sum(hold_err ** 2)), 1e-12)
    return WalkFit(trace=trace.name, mean=mean.astype(np.float32),
                   vol=float(vol_site.mean()),
                   vol_per_site=vol_site.astype(np.float32),
                   reversion_r2=r2)
