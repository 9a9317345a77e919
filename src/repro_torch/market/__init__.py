"""Trace-driven spot-market subsystem (DESIGN.md §10), PyTorch port of
`repro.market`.

Every market model — the in-sim mean-reverting walk, regime-switching
and correlated-shock processes, AWS spot-price histories, Google
cluster-trace preemption logs — compiles down to one replayable
artifact: a `MarketTrace` of (S, T) per-site price and revocation arrays
on the tick grid.  Traces enter the tick through `cfg_c` as data
(`runtime.make_cfg_arrays(market="trace", trace=...)`), and a walk
exported with `export_walk_trace` replays bit-identically through the
trace path (the §10 replay invariant).  `market.calibrate` fits
`manager.RevocationPredictor` and the walk's mean/vol against a trace;
`market.chaos` scripts fault drills and replays them.
"""
from repro_torch.market.traces import (MarketTrace, available_traces,
                                       bucket_events, load,
                                       load_aws_spot_history,
                                       load_google_cluster_events,
                                       resample_price)
from repro_torch.market.synthetic import (CorrelatedSiteShocks,
                                          MeanRevertingWalk,
                                          RegimeSwitchingWalk,
                                          export_walk_trace,
                                          walk_params_from_cluster,
                                          walk_price_update)
from repro_torch.market.calibrate import (CalibrationReport, HazardAwareBid,
                                          WalkFit, calibrate_predictor,
                                          epoch_revocation_rates, fit_walk,
                                          sliding_window_rates)
# chaos last: its runner lazily imports repro_torch.core
from repro_torch.market.chaos import (ChaosReport, FaultSchedule, kill_mask,
                                      kill_nodes, mass_kill, run_chaos,
                                      warning_then_reprieve)

__all__ = [
    "MarketTrace", "available_traces", "bucket_events", "load",
    "load_aws_spot_history", "load_google_cluster_events", "resample_price",
    "CorrelatedSiteShocks", "MeanRevertingWalk", "RegimeSwitchingWalk",
    "export_walk_trace", "walk_params_from_cluster", "walk_price_update",
    "CalibrationReport", "HazardAwareBid", "WalkFit", "calibrate_predictor",
    "epoch_revocation_rates", "fit_walk", "sliding_window_rates",
    "ChaosReport", "FaultSchedule", "kill_mask", "kill_nodes", "mass_kill",
    "run_chaos", "warning_then_reprieve",
]
