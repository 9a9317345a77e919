"""Cluster/workload configuration for the BW-Raft consensus layer (a copy
of `repro.core.cluster_config`, so the port imports nothing of the JAX
package)."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SiteConfig:
    """One geo-site (paper: EU-Frankfurt / Asia-Singapore / US-East/West)."""
    name: str
    followers: int                 # on-demand voter nodes at this site
    rtt_intra: int                 # ticks for intra-site message delivery
    rtt_inter: int                 # ticks to other sites
    on_demand_price: float         # $/node/period (beta)
    spot_price_mean: float         # $/node/period mean (rho)
    spot_price_vol: float = 0.35   # relative volatility of the price process
    spot_revoke_rate: float = 0.02  # baseline revocation prob / period (xi)


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    name: str
    sites: Tuple[SiteConfig, ...]
    secretary_fanout: int = 4          # f
    write_ratio_threshold: float = 0.30   # varpi
    read_growth_deadband: float = 0.10    # |A| deadband
    period_ticks: int = 100               # T
    budget_per_period: float = 2.0        # vartheta
    max_log: int = 4096                   # log capacity (entries)
    key_space: int = 1024                 # KV state-machine key space
    max_secretaries: int = 16
    max_observers: int = 64
    # timeouts must dominate WAN RTT (max ~10 ticks) + heartbeat interval
    election_timeout_min: int = 30        # ticks
    election_timeout_max: int = 60
    heartbeat_interval: int = 3

    @property
    def num_sites(self) -> int:
        return len(self.sites)

    @property
    def num_followers(self) -> int:
        return sum(s.followers for s in self.sites)

    @property
    def num_voters(self) -> int:
        return self.num_followers                 # leader is one of them

    @property
    def max_nodes(self) -> int:
        return self.num_followers + self.max_secretaries + self.max_observers
