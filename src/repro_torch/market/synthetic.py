"""Synthetic market providers (DESIGN.md §10), PyTorch port of
`repro.market.synthetic`: processes that materialize to (S, T) traces.

  `walk_price_update` /     THE in-sim mean-reverting walk.  The price
  `epoch_walk_prices`       path of a process-market epoch depends only
                            on the epoch's starting price and the normal
                            noise, never on the consensus state, so
                            `core/draws.py` runs the walk once per epoch
                            and the tick reads row `t` of the path.
  `export_walk_trace`       materializes the walk a `BWRaftSim` with the
                            same draw source would run, as a `MarketTrace`
                            that replays bit-identically through the
                            trace path (the §10 replay invariant).
  `RegimeSwitchingWalk`     calm/spike Markov-modulated vol+mean.
  `CorrelatedSiteShocks`    a common cross-site shock factor.

The walk's expression keeps the JAX package's operation order; evaluated
eagerly it matches numpy float32, while a jitted JAX walk may differ in
the last bit (XLA fuses the arithmetic), which is why the tests replay
JAX's own price path.  The two numpy processes draw from
`np.random.default_rng(seed)` exactly as the JAX package's do, so their
traces are equal bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cluster_config import ClusterConfig
from repro_torch.market.traces import MarketTrace


def walk_price_update(price: torch.Tensor, mean: torch.Tensor, vol,
                      normal: torch.Tensor) -> torch.Tensor:
    """One tick of the walk given the tick's standard-normal draws."""
    noise = normal * vol * mean
    price = price + 0.2 * (mean - price) + 0.15 * noise
    return torch.maximum(price, 0.1 * mean)


def epoch_walk_prices(price0: torch.Tensor, mean: torch.Tensor, vol,
                      normals: torch.Tensor) -> torch.Tensor:
    """The (T, S) price path of one epoch: row t is the price after tick
    t, chained from `price0` through `normals[t]`."""
    rows = []
    price = price0
    for t in range(normals.shape[0]):
        price = walk_price_update(price, mean, vol, normals[t])
        rows.append(price)
    return torch.stack(rows)


def walk_params_from_cluster(cfg: ClusterConfig, *, pad_sites: int = 0,
                             spot_price_vol: Optional[float] = None
                             ) -> Tuple[np.ndarray, float, np.ndarray,
                                        np.ndarray]:
    """(mean, vol, price0, bid) of the in-sim walk for this cluster —
    the derivations `runtime.make_cfg_arrays` (mean/vol, padded sites
    repeat the last real site) and `state.init_state` (price0/bid via
    `state.site_price_init`) use."""
    from repro_torch.core import state as state_mod
    sp = [s.spot_price_mean for s in cfg.sites]
    sp = sp + [sp[-1]] * pad_sites
    vol = (cfg.sites[0].spot_price_vol if spot_price_vol is None
           else spot_price_vol)
    price0, bid = state_mod.site_price_init(cfg, cfg.num_sites + pad_sites)
    return np.asarray(sp, np.float32), float(vol), price0, bid


def export_walk_trace(cfg: ClusterConfig, *, seed: int, epochs: int,
                      pad_sites: int = 0,
                      spot_price_vol: Optional[float] = None,
                      name: Optional[str] = None, draws=None,
                      device=None) -> MarketTrace:
    """Materialize the in-sim walk as a `MarketTrace` covering `epochs` x
    `cfg.period_ticks` ticks, bit-identical to the price path of a
    `BWRaftSim(cfg, seed=seed, device=device)` whose draw source is
    `draws` (default `TorchDraws(seed, device)`, the sim's own default),
    and of every same-seed fleet member, whatever their rates, arrival
    plan, node padding or observer slots: the source is consumed epoch
    by epoch as such a sim consumes it, chained from the epoch's last
    price, and the price stream of either source depends only on the
    seed and S (`core/draws.py`).  Under the tests' JAX tape this equals
    `repro.market.synthetic.export_walk_trace`.  Revocations follow the
    in-sim bid rule (price > 1.5x site mean).  Runs on the card unless
    `device="cpu"`."""
    from repro_torch import resolve_device
    from repro_torch.core import runtime as runtime_mod
    from repro_torch.core import state as state_mod
    from repro_torch.core.draws import TorchDraws
    device = resolve_device(device)
    _, _, _, bid = walk_params_from_cluster(
        cfg, pad_sites=pad_sites, spot_price_vol=spot_price_vol)
    static = state_mod.build_static(cfg, pad_sites=pad_sites)
    state = state_mod.init_state(cfg, static, device)
    cfg_c = runtime_mod.make_cfg_arrays(
        cfg, device, write_rate=8.0, read_rate=32.0, pad_sites=pad_sites,
        spot_price_vol=spot_price_vol)
    src = draws if draws is not None else TorchDraws(seed, device)
    T = cfg.period_ticks
    cols: List[np.ndarray] = []
    for _ in range(epochs):
        ps = src.epoch(T, state, cfg_c)["price"]               # (T, S)
        state = dict(state, spot_price=ps[-1], tick=state["tick"] + T)
        cols.append(ps.cpu().numpy())
    prices = np.concatenate(cols, axis=0).T.astype(np.float32)  # (S, E*T)
    return MarketTrace(name or f"walk-{cfg.name}-seed{seed}",
                       prices, prices > bid[:, None])


@dataclasses.dataclass(eq=False)
class MeanRevertingWalk:
    """The in-sim walk as a provider object (`materialize(ticks, seed)`);
    `ticks` must be a whole number of `cfg.period_ticks` epochs because
    bit-identity is defined against the sim's per-epoch draw schedule.
    `device` goes to `export_walk_trace`."""
    cfg: ClusterConfig
    pad_sites: int = 0
    spot_price_vol: Optional[float] = None
    device: Optional[object] = None

    def materialize(self, ticks: int, *, seed: int) -> MarketTrace:
        T = self.cfg.period_ticks
        assert ticks % T == 0, \
            f"ticks={ticks} must be a multiple of period_ticks={T}"
        return export_walk_trace(self.cfg, seed=seed, epochs=ticks // T,
                                 pad_sites=self.pad_sites,
                                 spot_price_vol=self.spot_price_vol,
                                 device=self.device)


def _floor_clamp(price: np.ndarray, mean: np.ndarray) -> np.ndarray:
    """The walk's price floor (0.1x mean), applied at generation time —
    traces replay verbatim, so the floor must be in the data
    (DESIGN.md §10)."""
    return np.maximum(price, 0.1 * mean)


@dataclasses.dataclass(eq=False)
class RegimeSwitchingWalk:
    """Calm/spike Markov-modulated walk: each site carries a two-state
    regime chain (calm -> spike w.p. `p_spike` per tick, spike -> calm
    w.p. `p_calm`); the spike regime multiplies the walk's volatility by
    `spike_vol_mult` and its reversion target by `spike_mean_mult`,
    which produces the clustered revocation bursts AWS spot histories
    show."""
    mean: np.ndarray
    vol: float
    bid: np.ndarray
    p_spike: float = 0.02
    p_calm: float = 0.25
    spike_vol_mult: float = 4.0
    spike_mean_mult: float = 1.8

    @classmethod
    def from_cluster(cls, cfg: ClusterConfig, **kw) -> "RegimeSwitchingWalk":
        mean, vol, _, bid = walk_params_from_cluster(cfg)
        return cls(mean=mean, vol=vol, bid=bid, **kw)

    def materialize(self, ticks: int, *, seed: int) -> MarketTrace:
        rng = np.random.default_rng(seed)
        S = len(self.mean)
        mean = np.asarray(self.mean, np.float64)
        price = mean.copy()
        spike = np.zeros(S, bool)
        prices = np.empty((S, ticks), np.float32)
        for t in range(ticks):
            flip = rng.random(S)
            spike = np.where(spike, flip >= self.p_calm, flip < self.p_spike)
            target = mean * np.where(spike, self.spike_mean_mult, 1.0)
            vol_t = self.vol * np.where(spike, self.spike_vol_mult, 1.0)
            noise = rng.standard_normal(S) * vol_t * mean
            price = _floor_clamp(price + 0.2 * (target - price) +
                                 0.15 * noise, mean)
            prices[:, t] = price
        return MarketTrace(f"regime-seed{seed}", prices,
                           prices > np.asarray(self.bid)[:, None])


@dataclasses.dataclass(eq=False)
class CorrelatedSiteShocks:
    """Mean-reverting walk whose per-tick noise shares a common factor
    across sites: ``z_s = sqrt(c)*z_common + sqrt(1-c)*z_site`` with
    ``c = correlation`` — region-wide capacity crunches that push several
    sites over their bids in the same tick."""
    mean: np.ndarray
    vol: float
    bid: np.ndarray
    correlation: float = 0.6

    @classmethod
    def from_cluster(cls, cfg: ClusterConfig, **kw) -> "CorrelatedSiteShocks":
        mean, vol, _, bid = walk_params_from_cluster(cfg)
        return cls(mean=mean, vol=vol, bid=bid, **kw)

    def materialize(self, ticks: int, *, seed: int) -> MarketTrace:
        assert 0.0 <= self.correlation <= 1.0, self.correlation
        rng = np.random.default_rng(seed)
        S = len(self.mean)
        mean = np.asarray(self.mean, np.float64)
        price = mean.copy()
        prices = np.empty((S, ticks), np.float32)
        w_common = np.sqrt(self.correlation)
        w_site = np.sqrt(1.0 - self.correlation)
        for t in range(ticks):
            z = w_common * rng.standard_normal() + \
                w_site * rng.standard_normal(S)
            price = _floor_clamp(price + 0.2 * (mean - price) +
                                 0.15 * z * self.vol * mean, mean)
            prices[:, t] = price
        return MarketTrace(f"corr-seed{seed}", prices,
                           prices > np.asarray(self.bid)[:, None])
