"""The control plane's oracles against the JAX package's on the CPU: the
cost of Equation (1) (`core.manager.estimated_cost`), the single-choice
secretary over a score stream (`core.mcsa.secretary_1e_stream`, JAX's
scan) and the offline top-k optimum (`core.mcsa.topk_oracle`), on seeded
score streams with ties, infinities and NaNs."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.bwraft_kv import CONFIG as J_CONFIG
from repro.core import manager as jmgr
from repro.core import mcsa as jmcsa
from repro_torch.configs.bwraft_kv import CONFIG as T_CONFIG
from repro_torch.core import manager as tmgr
from repro_torch.core import mcsa as tmcsa

from test_torch_tape import port_config, small_config


@pytest.mark.parametrize("k_s, k_o", [(0, 0), (1, 0), (0, 7), (4, 8),
                                      (16, 64)])
def test_estimated_cost_matches_jax(k_s, k_o):
    small = small_config()
    for jcfg, tcfg in ((J_CONFIG, T_CONFIG), (small, port_config(small))):
        for coef in (0.001, 0.25):
            assert tmgr.estimated_cost(tcfg, k_s, k_o, coef) == \
                jmgr.estimated_cost(jcfg, k_s, k_o, coef)


def _streams(n, seed):
    """Seeded score streams of length n: uniform, integer-valued (ties),
    constant, with infinities, with a NaN, and falling."""
    rng = np.random.default_rng(seed)
    out = [rng.uniform(0, 1, n), rng.integers(0, 4, n).astype(float),
           np.full(n, 2.0), -np.arange(n, dtype=float)]
    x = rng.integers(0, 3, n).astype(float)
    x[rng.integers(0, n, 2)] = [np.inf, -np.inf]
    out.append(x)
    y = rng.uniform(0, 1, n)
    y[rng.integers(0, n)] = np.nan
    out.append(y)
    out.append(np.full(n, -np.inf))
    return [s.astype(np.float32) for s in out]


J_SECRETARY = jax.jit(jmcsa.secretary_1e_stream)


@pytest.mark.parametrize("n", [1, 2, 3, 8, 50])
def test_secretary_stream_and_topk_oracle_match_jax(n):
    for seed in range(4):
        for s in _streams(n, seed):
            want = int(J_SECRETARY(jnp.asarray(s)))
            got = tmcsa.secretary_1e_stream(torch.from_numpy(s))
            assert got.dtype == torch.int32 and int(got) == want, (n, s)
            for k in (1, 3, n):
                assert tmcsa.topk_oracle(torch.from_numpy(s), k) == \
                    tmcsa.topk_oracle(s, k) == jmcsa.topk_oracle(s, k)
