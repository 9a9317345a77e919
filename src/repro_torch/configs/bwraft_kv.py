"""The paper's own system config: the BW-Raft geo-distributed KV service
(a copy of `repro.configs.bwraft_kv`).

4 sites, 7 on-demand voters, 16 spot secretary slots and 64 spot observer
slots (N = 87 nodes), a 4096-entry log window and a 1024-key state
machine.
"""
from repro_torch.core.cluster_config import ClusterConfig, SiteConfig

CONFIG = ClusterConfig(
    name="bwraft-kv-paper",
    sites=(
        SiteConfig("eu-frankfurt", followers=2, rtt_intra=1, rtt_inter=8,
                   on_demand_price=0.0416, spot_price_mean=0.0125),
        SiteConfig("asia-singapore", followers=2, rtt_intra=1, rtt_inter=10,
                   on_demand_price=0.0464, spot_price_mean=0.0139),
        SiteConfig("us-east", followers=2, rtt_intra=1, rtt_inter=6,
                   on_demand_price=0.0416, spot_price_mean=0.0104),
        SiteConfig("us-west", followers=1, rtt_intra=1, rtt_inter=7,
                   on_demand_price=0.0416, spot_price_mean=0.0110),
    ),
    secretary_fanout=4,          # f: followers one secretary can handle
    write_ratio_threshold=0.30,  # varpi
    read_growth_deadband=0.10,   # |A| <= 10% -> no change
    period_ticks=100,            # T ("peek" window)
    budget_per_period=2.0,       # vartheta ($/period for spot lease)
    max_log=4096,
    key_space=1024,
)
