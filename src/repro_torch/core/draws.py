"""The tick's randomness as one draw bundle per epoch.

Every random draw of the JAX tick depends only on the key schedule,
`cfg_c` and the tick number, never on the consensus state, so an epoch's
draws can be made up front as `(T, ...)` tensors and the tick reads row
`t`.  A bundle is a dict:

    price         (T, S) float32  process-market price after each tick
    fail_u        (T, N) float32  i.i.d.-failure uniforms (vs cfg_c phi)
    n_writes      (T,)   int32    Poisson write arrivals
    n_reads       (T,)   int32    Poisson read arrivals
    keys_uniform  (T, 64) int32   uniform write keys in [0, K)
    zipf_u        (T, 64) float32 uniforms for the Zipfian key CDF
    vals          (T, 64) int32   write values in [0, 2^20)
    timeouts      (T, N) int32    election timeouts in [min, max]

A draw source has two calls, made in the order the JAX simulator
consumes its key: `epoch(T, state, cfg_c)` for a T-tick epoch and
`tick(state, cfg_c)` for one service step (a bundle with T = 1).
`TorchDraws` makes bundles with a seeded `torch.Generator` on the
state's device; the tests pass a source that replays the JAX key
schedule instead.  The price path is chained from the state's current
price through `market.synthetic.epoch_walk_prices`.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.market.synthetic import epoch_walk_prices

N_WINDOW = 64            # the leader's static accept window (step.py)
VAL_RANGE = 2 ** 20


def row(bundle: Dict[str, torch.Tensor], t: int) -> Dict[str, torch.Tensor]:
    """The draws of tick `t` of a bundle (views, no copies)."""
    return {k: v[t] for k, v in bundle.items()}


class TorchDraws:
    """Draw bundles from one `torch.Generator` seeded with `seed`, on
    `device`; nothing is read on the host."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def _rand(self, *shape):
        return torch.rand(shape, generator=self.gen, device=self.device)

    def epoch(self, T: int, state, cfg_c) -> Dict[str, torch.Tensor]:
        N = state["role"].shape[0]
        K = state["kv"].shape[1]
        S = state["spot_price"].shape[0]
        normals = torch.randn((T, S), generator=self.gen,
                              device=self.device)
        price = epoch_walk_prices(state["spot_price"],
                                  cfg_c["spot_price_mean"],
                                  cfg_c["spot_price_vol"], normals)
        ticks = state["tick"] + torch.arange(T, device=self.device)
        ta = (ticks % cfg_c["arrival_len"]).long()
        open_loop = cfg_c["open_loop"]
        lam_w = torch.where(open_loop, cfg_c["write_curve"][ta],
                            cfg_c["write_rate"])
        lam_r = torch.where(open_loop, cfg_c["read_curve"][ta],
                            cfg_c["read_rate"])
        n_writes = torch.poisson(lam_w, generator=self.gen)
        n_reads = torch.poisson(lam_r, generator=self.gen)
        lo = cfg_c["election_timeout_min"]
        span = cfg_c["election_timeout_max"] - lo + 1
        timeouts = lo + torch.minimum(
            (self._rand(T, N) * span).floor().to(torch.int32), span - 1)
        return {
            "price": price,
            "fail_u": self._rand(T, N),
            "n_writes": n_writes.to(torch.int32),
            "n_reads": n_reads.to(torch.int32),
            "keys_uniform": torch.randint(
                0, K, (T, N_WINDOW), generator=self.gen,
                device=self.device, dtype=torch.int32),
            "zipf_u": self._rand(T, N_WINDOW),
            "vals": torch.randint(0, VAL_RANGE, (T, N_WINDOW),
                                  generator=self.gen, device=self.device,
                                  dtype=torch.int32),
            "timeouts": timeouts.to(torch.int32),
        }

    def tick(self, state, cfg_c) -> Dict[str, torch.Tensor]:
        return self.epoch(1, state, cfg_c)
