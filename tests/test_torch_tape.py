"""The JAX draw tape: a draw source for the PyTorch port that replays the
JAX simulator's key schedule exactly, so the port and a live JAX run see
the same randomness (ROADMAP.md, "Modules to port", item 1).

`BWRaftSim.run_epoch` and `BWKVService._step` each take
`rng, sub = split(rng)`; an epoch splits `sub` into T tick keys, a
service step uses `sub` as the tick key.  Each tick key splits four ways
(spot, work, lead, elec) and the draws follow `repro.core.step`.  The
process-market price path comes from JAX itself
(`repro.market.synthetic._epoch_walk_prices`, jitted like the sim): a
jitted float32 walk is not bit-reproducible by eager evaluation, and a
one-ulp price can flip a `price > bid` revocation.  The other test files
import `JaxTape` and the small cluster config from here."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.cluster_config import ClusterConfig, SiteConfig
from repro.core.runtime import BWRaftSim
from repro.market import synthetic as jsynth

N_WINDOW = 64


def small_config(name="ttiny", followers=(2, 1), max_log=256):
    """The tests' cluster: 2-3 sites, a 256-entry log, 64 keys, 4
    secretary and 8 observer slots, 50-tick epochs."""
    sites = tuple(
        SiteConfig(f"{name}-s{i}", followers=f, rtt_intra=1,
                   rtt_inter=6 + 2 * i, on_demand_price=0.0416,
                   spot_price_mean=0.0125 + 0.001 * i)
        for i, f in enumerate(followers))
    return ClusterConfig(name=name, sites=sites, max_log=max_log,
                         key_space=64, max_secretaries=4,
                         max_observers=8, period_ticks=50)


def port_config(cfg):
    """The same cluster as a `repro_torch` ClusterConfig."""
    from repro_torch.core import cluster_config as tcc
    return tcc.ClusterConfig(
        name=cfg.name,
        sites=tuple(tcc.SiteConfig(**vars(s)) for s in cfg.sites),
        **{k: getattr(cfg, k) for k in (
            "secretary_fanout", "write_ratio_threshold",
            "read_growth_deadband", "period_ticks", "budget_per_period",
            "max_log", "key_space", "max_secretaries", "max_observers",
            "election_timeout_min", "election_timeout_max",
            "heartbeat_interval")})


@functools.partial(jax.jit, static_argnames=("N", "K"))
def _tick_draws(keys, tick0, c, *, N, K):
    """Every non-price draw of the ticks whose keys are `keys`, in a
    scan like the sim's epoch."""
    def body(t, k):
        r_spot, r_work, r_lead, r_elec = jax.random.split(k, 4)
        r_fail = jax.random.split(r_spot, 3)[2]
        r_w, r_r, _ = jax.random.split(r_work, 3)
        ta = jnp.mod(t, c["arrival_len"])
        lam_w = jnp.where(c["open_loop"], c["write_curve"][ta],
                          c["write_rate"])
        lam_r = jnp.where(c["open_loop"], c["read_curve"][ta],
                          c["read_rate"])
        r_timeout, = jax.random.split(r_elec, 1)
        out = {
            "fail_u": jax.random.uniform(r_fail, (N,)),
            "n_writes": jax.random.poisson(r_w, lam_w).astype(jnp.int32),
            "n_reads": jax.random.poisson(r_r, lam_r).astype(jnp.int32),
            "keys_uniform": jax.random.randint(r_lead, (N_WINDOW,), 0, K),
            "zipf_u": jax.random.uniform(jax.random.fold_in(r_lead, 2),
                                         (N_WINDOW,)),
            "vals": jax.random.randint(jax.random.fold_in(r_lead, 1),
                                       (N_WINDOW,), 0, 2 ** 20),
            "timeouts": jax.random.randint(
                r_timeout, (N,), c["election_timeout_min"],
                c["election_timeout_max"] + 1),
        }
        return t + 1, out
    return jax.lax.scan(body, tick0, keys)[1]


@jax.jit
def _one_tick_price(price, k, mean, vol):
    r_price = jax.random.split(jax.random.split(k, 4)[0], 3)[0]
    return jsynth.walk_price_update(price, mean, vol, r_price)


def _jax_tree(tree):
    return {k: jnp.asarray(v.cpu().numpy() if isinstance(v, torch.Tensor)
                           else v) for k, v in tree.items()
            if isinstance(v, (torch.Tensor, np.ndarray))}


class JaxTape:
    """A `repro_torch` draw source replaying `PRNGKey(seed)` as the JAX
    `BWRaftSim` consumes it."""

    def __init__(self, seed: int):
        self.rng = jax.random.PRNGKey(seed)

    def _bundle(self, keys, state, cfg_c, price):
        N = state["role"].shape[0]
        K = state["kv"].shape[1]
        c = _jax_tree(cfg_c)
        tick0 = jnp.int32(int(state["tick"]))
        draws = _tick_draws(keys, tick0, c, N=N, K=K)
        dev = state["role"].device
        out = {k: torch.as_tensor(np.array(v), device=dev)
               for k, v in draws.items()}
        out["price"] = torch.as_tensor(np.array(price), device=dev)
        return out

    def epoch(self, T, state, cfg_c):
        self.rng, sub = jax.random.split(self.rng)
        c = _jax_tree(cfg_c)
        price0 = jnp.asarray(state["spot_price"].cpu().numpy())
        _, prices = jsynth._epoch_walk_prices(
            price0, sub, c["spot_price_mean"], c["spot_price_vol"], T=T)
        return self._bundle(jax.random.split(sub, T), state, cfg_c, prices)

    def tick(self, state, cfg_c):
        self.rng, sub = jax.random.split(self.rng)
        c = _jax_tree(cfg_c)
        price = _one_tick_price(
            jnp.asarray(state["spot_price"].cpu().numpy()), sub,
            c["spot_price_mean"], c["spot_price_vol"])
        return self._bundle(sub[None], state, cfg_c, price[None])


# --------------------------------------------------------------------- #
def test_tape_price_path_matches_live_jax_sim():
    """The tape's price path ends, epoch after epoch, exactly at the
    spot price a live JAX BWRaftSim holds, and its Poisson draws sum to
    the epoch's arrival counts."""
    from repro_torch.core import state as tstate
    cfg = small_config()
    sim = BWRaftSim(cfg, seed=0, phi=0.02)
    tape = JaxTape(0)
    for _ in range(3):
        st = {k: torch.as_tensor(np.array(sim.state[k]))
              for k in ("role", "kv", "tick", "spot_price")}
        cfg_c = tstate.from_numpy(
            {k: np.asarray(v) for k, v in sim.cfg_c.items()}, "cpu")
        bundle = tape.epoch(cfg.period_ticks, st, cfg_c)
        rep = sim.run_epoch()
        assert np.array_equal(bundle["price"][-1].numpy(),
                              np.asarray(sim.state["spot_price"]))
        assert int(bundle["n_writes"].sum()) == rep.writes_arrived
        assert int(bundle["n_reads"].sum()) == rep.reads_arrived
        for k, shape in (("fail_u", (50, st["role"].shape[0])),
                         ("keys_uniform", (50, 64)), ("vals", (50, 64)),
                         ("timeouts", (50, st["role"].shape[0]))):
            assert tuple(bundle[k].shape) == shape, k


def test_tape_tick_matches_epoch_key_schedule():
    """A one-tick bundle uses its key as the tick key: the draws of tick
    t of an epoch equal a tick bundle made from that epoch's t-th key."""
    from repro_torch.core import state as tstate
    from repro_torch.core import runtime as trt
    pcfg = port_config(small_config())
    static = tstate.build_static(pcfg)
    st = tstate.init_state(pcfg, static, "cpu")
    cfg_c = trt.make_cfg_arrays(pcfg, "cpu", write_rate=8.0, read_rate=32.0)
    a = JaxTape(5)
    ep = a.epoch(4, st, cfg_c)
    b = JaxTape(5)
    b.rng, sub = jax.random.split(b.rng)
    keys = jax.random.split(sub, 4)
    one = b._bundle(keys[2][None], st, cfg_c, ep["price"][2:3].numpy())
    for k in ("fail_u", "n_writes", "keys_uniform", "vals", "timeouts"):
        assert torch.equal(one[k][0], ep[k][2]), k
