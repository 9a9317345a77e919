"""Shared fixtures. NOTE: no XLA_FLAGS here — tests see 1 CPU device;
only launch/dryrun.py forces 512 host devices."""
import jax
import numpy as np
import pytest

from repro.configs.bwraft_kv import CONFIG as PAPER_CLUSTER
from repro.core import state as SM
from repro.core import step as step_mod
from repro.core import runtime as RT
from repro.core.invariants import snapshot


@pytest.fixture(scope="session")
def paper_cluster():
    return PAPER_CLUSTER


@pytest.fixture(scope="session")
def sim_trace_factory(paper_cluster):
    """Run a sim for `ticks` with given knobs, snapshotting every k ticks."""
    static = SM.build_static(paper_cluster)
    cfg_c = RT.make_cfg_arrays(paper_cluster, write_rate=8.0, read_rate=16.0)
    tickfn = jax.jit(lambda s, r, c: step_mod.tick(s, static, c, r))

    def run(*, seed=0, ticks=300, every=5, phi=0.0, write_rate=8.0,
            lease_spot=True):
        import dataclasses
        import jax.numpy as jnp
        c = dict(cfg_c)
        c["phi"] = jnp.float32(phi)
        c["write_rate"] = jnp.float32(write_rate)
        state = SM.init_state(paper_cluster, static)
        if lease_spot:
            sim = RT.BWRaftSim(paper_cluster, seed=seed)
            sim._lease(4, 6)
            state = dict(state, role=sim.state["role"],
                         alive=sim.state["alive"],
                         sec_of=sim.state["sec_of"],
                         obs_of=sim.state["obs_of"])
        rng = jax.random.PRNGKey(seed)
        trace = []
        for t in range(ticks):
            rng, sub = jax.random.split(rng)
            state, _ = tickfn(state, sub, c)
            if t % every == 0:
                trace.append(snapshot(state))
        return trace, state

    return run


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (the PyTorch port's kernels); "
        "skips without one")
