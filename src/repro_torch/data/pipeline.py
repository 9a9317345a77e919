"""Deterministic synthetic data pipeline + workload generators (the port
of `repro.data.pipeline`; numpy makes every number, torch only holds the
batch).

Training: a seeded, restartable token stream — `batch_at(step)` is a pure
function of (seed, step, shard), so any pod can reproduce any batch after
failover, and elastic re-sharding (fewer pods -> wider per-pod slices) is
exact.  The tokens come from the same numpy generator as the JAX
pipeline's, so they equal them bit for bit.  Serving: Google/Alibaba-
trace-style request generators (Poisson arrivals, lognormal bursts, Zipf
keys) shared with the consensus benchmarks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


class TokenPipeline:
    """Synthetic LM stream: Zipf-ish unigram mix with induced bigram
    structure so reduced models show decreasing loss."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int, *, shard: int = 0, num_shards: int = 1,
                 extras: Optional[Dict] = None,
                 device=None) -> Dict[str, torch.Tensor]:
        """{"tokens", "labels"} (B_loc, S) int32 and any `extras`, as
        tensors on `device` (None: the card, `repro_torch.resolve_device`)."""
        cfg = self.cfg
        assert cfg.global_batch % num_shards == 0
        device = resolve_device(device)
        b_loc = cfg.global_batch // num_shards
        # generate the GLOBAL batch from (seed, step) only, then slice the
        # shard: re-sharding after failover is exact (no loss/duplication)
        rng = np.random.default_rng(cfg.seed * 1_000_003 + step)
        base = rng.zipf(1.3, size=(cfg.global_batch, cfg.seq_len + 1))
        toks = (base + rng.integers(0, 7, size=base.shape)) % cfg.vocab_size
        # bigram structure: even positions predict +1
        toks[:, 1::2] = (toks[:, 0:-1:2] + 1) % cfg.vocab_size
        toks = toks[shard * b_loc:(shard + 1) * b_loc]
        as_i32 = lambda a: torch.from_numpy(
            np.ascontiguousarray(a, np.int32)).to(device)
        out = {"tokens": as_i32(toks[:, :-1]), "labels": as_i32(toks[:, 1:])}
        if extras:
            out.update({k: torch.as_tensor(np.asarray(v), device=device)
                        for k, v in extras.items()})
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


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


def rw_mix(trace: RequestTrace, alpha: float, seed: int = 0) -> np.ndarray:
    """alpha = read fraction; returns bool mask (True=read) per request."""
    rng = np.random.default_rng(seed)
    return rng.uniform(size=len(trace.arrivals)) < alpha
