"""Open-loop workload surface (DESIGN.md §11): arrival-rate processes
and key-popularity models that compile to `cfg_c` arrays — a copy of
`repro.workload`."""
from repro_torch.workload.arrivals import (ConstantRate, DiurnalRate,
                                           FlashCrowd, OpenLoop,
                                           RateProcess, ZipfianKeys,
                                           host_poisson_totals,
                                           materialize_curve,
                                           uniform_key_cdf)

__all__ = [
    "ConstantRate", "DiurnalRate", "FlashCrowd", "OpenLoop", "RateProcess",
    "ZipfianKeys", "host_poisson_totals", "materialize_curve",
    "uniform_key_cdf",
]
