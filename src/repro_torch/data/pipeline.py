"""Serving workload generators (a numpy-only copy of the request side of
`repro.data.pipeline`): Google/Alibaba-trace-style requests with Poisson
arrivals, lognormal bursts and Zipf keys.  The training token pipelines
wait for the training slice (ROADMAP.md §1 item 10c).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RequestTrace:
    """Serving workload: arrival times + request sizes (trace-style)."""
    arrivals: np.ndarray          # arrival tick per request
    prompt_lens: np.ndarray
    keys: np.ndarray              # for KV-service benchmarks


def google_trace_like(n: int, *, rate: float = 16.0, burst: float = 2.0,
                      key_space: int = 1024, seed: int = 0) -> RequestTrace:
    """Poisson arrivals with lognormal burst modulation, Zipf keys — the
    shape of the Google cluster trace workloads used in the paper."""
    rng = np.random.default_rng(seed)
    mod = rng.lognormal(0.0, burst * 0.25, size=n)
    gaps = rng.exponential(1.0 / rate, size=n) / np.maximum(mod, 1e-2)
    arrivals = np.cumsum(gaps)
    prompt_lens = np.clip(rng.lognormal(4.5, 0.8, size=n), 8, 2048)
    keys = rng.zipf(1.2, size=n) % key_space
    return RequestTrace(arrivals=arrivals,
                        prompt_lens=prompt_lens.astype(np.int32),
                        keys=keys.astype(np.int32))

