"""Global resource management — the paper's Algorithm 1 ("peek").

Faithful port of the pseudocode: every period T, from the collected
statistics (follower census F_i, secretary capacity f, write ratio zeta,
read growth A, budget vartheta, prices rho/beta), decide how many new
secretaries (dk_s) and observers (dk_o) to lease, prioritized by the write
ratio against varpi=30%.  Runs at epoch granularity on the host (control
plane), NumPy only.  A copy of `repro.core.manager` (with the cost of
Equation (1), `estimated_cost`), kept here so the port imports nothing
of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.core.cluster_config import ClusterConfig


@dataclasses.dataclass
class PeekStats:
    """Statistics collected over the last period T."""
    reads_prev: int
    reads_now: int
    writes_now: int
    followers_per_site: List[int]     # F_i
    k_s: int                          # current secretaries
    k_o: int                          # current observers
    budget: float                     # vartheta (remaining $ this period)
    spot_price: float                 # rho (mean across sites)
    on_demand_price: float            # beta


@dataclasses.dataclass
class PeekDecision:
    dk_s: int
    dk_o: int
    k: int                            # total new spot instances to lease
    k_s: int
    k_o: int
    budget_left: float


def algorithm1(cfg: ClusterConfig, st: PeekStats) -> PeekDecision:
    """The paper's Algorithm 1, line-for-line."""
    f = cfg.secretary_fanout
    varpi = cfg.write_ratio_threshold
    rho = st.spot_price
    theta = st.budget
    m = len(st.followers_per_site)

    # line 3: k_s' = sum_i (F_i + (f+1)/2) / f   (site needing >= (f+1)/2
    # followers rounds up to one secretary)
    k_s_needed = sum(int((F_i + (f + 1) // 2) // f)
                     for F_i in st.followers_per_site)
    dk_s = k_s_needed - st.k_s                                # line 4

    total = max(st.reads_now + st.writes_now, 1)
    zeta = st.writes_now / total
    dk_o = 0
    if zeta <= varpi:                                         # line 5: reads
        A = (st.reads_now - st.reads_prev) / max(st.reads_prev, 1)  # line 6
        if A > cfg.read_growth_deadband:                      # line 7
            dk_o = m                                          # line 8
            dk_o = min(dk_o, int(min(rho * dk_o, theta) / rho))  # line 9
        elif A < -cfg.read_growth_deadband:                   # line 10
            dk_o = max(-st.k_o, -m)                           # line 11
        theta = max(0.0, theta - rho * dk_o)                  # line 13
        dk_s = min(dk_s, int(theta / rho))                    # line 14
        theta = max(0.0, theta - rho * max(dk_s, 0))          # line 15
    else:                                                     # line 16: writes
        dk_s = min(dk_s, int(theta / rho))                    # line 17
        theta = max(0.0, theta - rho * max(dk_s, 0))          # line 18
        dk_o = min(m, int(theta / rho))                       # line 19
        theta = max(0.0, theta - rho * dk_o)                  # line 20
    dk_s = max(dk_s, -st.k_s)
    k_s = st.k_s + dk_s                                       # line 22
    k_o = st.k_o + dk_o                                       # line 23
    k = max(dk_s, 0) + max(dk_o, 0)                           # line 24
    return PeekDecision(dk_s=dk_s, dk_o=dk_o, k=k, k_s=k_s, k_o=k_o,
                        budget_left=theta)


def estimated_cost(cfg: ClusterConfig, k_s: int, k_o: int,
                   network_coef: float = 0.001) -> float:
    """Equation (1): cost = sum_i beta*F_i + beta + rho(k_s+k_o) + C."""
    beta = float(np.mean([s.on_demand_price for s in cfg.sites]))
    rho = float(np.mean([s.spot_price_mean for s in cfg.sites]))
    followers = sum(s.followers for s in cfg.sites)
    n = followers + 1 + k_s + k_o
    return beta * followers + beta + rho * (k_s + k_o) + network_coef * n


def spot_scores(cpu: np.ndarray, mem: np.ndarray, price: np.ndarray,
                revoke_prob: np.ndarray,
                l1: float = 1.0, l2: float = 1.0, l3: float = 1.0
                ) -> np.ndarray:
    """Equation (2): score = (l1*c + l2*phi + l3/price) / xi."""
    return (l1 * cpu + l2 * mem + l3 / np.maximum(price, 1e-6)) / \
        np.maximum(revoke_prob, 1e-3)


class RevocationPredictor:
    """EWMA per-site revocation-rate estimate (stands in for SpotTune).

    The default is a flat prior updated online from the epoch census;
    `calibrated` (or `market.calibrate.calibrate_predictor`, which also
    fits alpha) seeds the rates from a market trace's empirical per-site
    hazard instead (DESIGN.md §10)."""

    def __init__(self, n_sites: int, alpha: float = 0.3,
                 prior: float = 0.02):
        self.rate = np.full(n_sites, prior)
        self.alpha = alpha

    @classmethod
    def calibrated(cls, rates, alpha: float = 0.3) -> "RevocationPredictor":
        """Predictor seeded from per-site rates fitted offline against a
        trace, instead of the flat prior."""
        rates = np.atleast_1d(np.asarray(rates, float))
        p = cls(len(rates), alpha=alpha)
        p.rate = rates.copy()
        return p

    def update(self, revoked: np.ndarray, leased: np.ndarray) -> None:
        obs = revoked / np.maximum(leased, 1)
        mask = leased > 0
        self.rate[mask] = (1 - self.alpha) * self.rate[mask] + \
            self.alpha * obs[mask]

    def predict(self) -> np.ndarray:
        return self.rate.copy()
