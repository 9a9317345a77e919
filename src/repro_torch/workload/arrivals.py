"""Key-popularity CDF for closed-loop clusters (a copy of
`repro.workload.arrivals.uniform_key_cdf`)."""
from __future__ import annotations

import numpy as np


def uniform_key_cdf(n_keys: int, pad_keys: int = 0) -> np.ndarray:
    """The inert (K,) CDF closed-loop members carry: uniform over the
    real key space, saturated over the padded tail.  Never sampled when
    `cfg_c["key_zipf"]` is off (DESIGN.md §11)."""
    if n_keys < 1:
        raise ValueError(f"n_keys must be >= 1, got {n_keys}")
    cdf = (np.arange(1, n_keys + 1, dtype=np.float64) / n_keys)
    return np.concatenate([cdf, np.ones((pad_keys,))]).astype(np.float32)
