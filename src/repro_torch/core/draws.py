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
    dobs_fail_u   (T, O) float32  the digest-tier slots' i.i.d.-failure
                                  uniforms (DESIGN.md §13; O may be 0)

A draw source has two calls, made in the order the JAX simulator
consumes its key: `epoch(T, state, cfg_c)` for a T-tick epoch and
`tick(state, cfg_c)` for one service step (a bundle with T = 1).  Both
take one member's unbatched state and `cfg_c`.  The tick reads a bundle
with a member axis after T: `fleet_epoch` stacks the bundles of one
source per member into `(T, B, ...)`, so each member follows the key
schedule a solo simulator with its seed would follow, and `row(bundle,
t)` gives tick t's `(B, ...)` draws.
`TorchDraws` makes bundles with seeded `torch.Generator`s on the
state's device, the price normals from a generator of their own so that
the price path depends on the seed and S alone, as the JAX walk does
(DESIGN.md §10); `CpuDraws` makes them on the CPU and moves them to the
card, so a card run and a CPU run of one seed see the same draws; the
tests pass a source that replays the JAX key schedule instead.  The
price path is chained from the state's current price through
`market.synthetic.epoch_walk_prices`.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.market.synthetic import epoch_walk_prices

N_WINDOW = 64            # the leader's static accept window (step.py)
VAL_RANGE = 2 ** 20


def row(bundle: Dict[str, torch.Tensor], t: int) -> Dict[str, torch.Tensor]:
    """The draws of tick `t` of a bundle (views, no copies)."""
    return {k: v[t] for k, v in bundle.items()}


def fleet_epoch(sources: Sequence, T: int, state: Dict,
                cfg_c: Dict) -> Dict[str, torch.Tensor]:
    """One epoch's `(T, B, ...)` bundle for a batched state: member i's
    draws come from `sources[i]`, given member i's state and `cfg_c`."""
    from repro_torch.core.state import member
    bundles = [src.epoch(T, member(state, i), member(cfg_c, i))
               for i, src in enumerate(sources)]
    return {k: torch.stack([b[k] for b in bundles], dim=1)
            for k in bundles[0]}


# the price stream's seed is `seed + PRICE_STREAM`, apart from the stream
# of every other draw (seeded `seed`)
PRICE_STREAM = 0x9E3779B9


class TorchDraws:
    """Draw bundles on `device` from two `torch.Generator`s: the price
    normals from one seeded `seed + PRICE_STREAM`, every other draw from
    one seeded `seed`.  The other draws' use of their stream depends on
    N, O and (on the CPU) the Poisson rates; kept apart, the price walk
    depends only on the seed, S and the epochs' lengths, so
    `market.synthetic.export_walk_trace` replays any same-seed sim or
    fleet member whatever its rates, plan, padding or observer slots.
    Nothing is read on the host."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        self.price_gen = torch.Generator(device=self.device)
        self.price_gen.manual_seed(int(seed) + PRICE_STREAM)

    def _rand(self, *shape):
        return torch.rand(shape, generator=self.gen, device=self.device)

    def epoch(self, T: int, state, cfg_c) -> Dict[str, torch.Tensor]:
        N = state["role"].shape[0]
        K = state["kv"].shape[1]
        S = state["spot_price"].shape[0]
        O = state["dobs_alive"].shape[0]
        normals = torch.randn((T, S), generator=self.price_gen,
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
            "dobs_fail_u": self._rand(T, O),
        }

    def tick(self, state, cfg_c) -> Dict[str, torch.Tensor]:
        return self.epoch(1, state, cfg_c)


class CpuDraws:
    """A `TorchDraws(seed)` on the CPU for a state on another device: the
    bundle is made from CPU copies of the few leaves the draws read and
    moved to `device`, so a card run and a CPU run from one seed see the
    same draws (a card-vs-CPU comparison's source)."""

    KEYS = ("role", "kv", "spot_price", "dobs_alive", "tick")

    def __init__(self, seed: int, device):
        self.src = TorchDraws(seed, torch.device("cpu"))
        self.device = torch.device(device)

    def _moved(self, bundle: Dict[str, torch.Tensor]):
        return {k: v.to(self.device) for k, v in bundle.items()}

    def _cpu(self, state, cfg_c):
        return ({k: state[k].cpu() for k in self.KEYS},
                {k: v.cpu() for k, v in cfg_c.items()})

    def epoch(self, T: int, state, cfg_c) -> Dict[str, torch.Tensor]:
        return self._moved(self.src.epoch(T, *self._cpu(state, cfg_c)))

    def tick(self, state, cfg_c) -> Dict[str, torch.Tensor]:
        return self._moved(self.src.tick(*self._cpu(state, cfg_c)))
