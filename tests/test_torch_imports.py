"""Package rules of the PyTorch port: importing `repro_torch` and every
one of its modules (the fleet, Multi-Raft, the model stack with its SSD
mixer, the serving loop, the training path — optimizer, checkpoint
store, coordinator, `launch.train` — the sharding rules, the meshes,
the collective accounting, the cluster stub, the mesh-forward taps,
the dry run and its step accounting, and every kernel family included)
loads no `jax` module and nothing of the `repro` package
(checked in a fresh interpreter), importing builds nothing, and an
entry point given no device runs on the card or raises — it never
falls back to the CPU silently."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parent.parent / "src"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names))
print(",".join(bad))
"""


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    lines = out.stdout.splitlines() + [""]
    assert int(lines[0]) >= 100, out.stdout
    assert lines[1] == "", f"the port imported {lines[1]}"


def test_import_builds_nothing():
    import repro_torch.kernels.build as build
    assert not build._LOADED


def test_entry_points_need_a_device():
    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.configs.bwraft_kv import CONFIG
    from repro_torch.core.runtime import BWRaftSim
    from repro_torch.models import lm
    cfg = get_config("smollm-360m").reduced()
    from repro_torch.coord.coordinator import ConsensusCoordinator
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import train
    pipe = TokenPipeline(DataConfig(vocab_size=64, seq_len=4,
                                    global_batch=2))
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        assert lm.init_lm(cfg, RunConfig()).embed.device.type == "cuda"
        assert pipe.batch_at(0)["tokens"].device.type == "cuda"
        assert ConsensusCoordinator(CONFIG).sim.state["kv"].device.type == \
            "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipe.batch_at(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ConsensusCoordinator(CONFIG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--steps", "1"])
    from repro_torch.core.fleet import FleetSim, MemberSpec
    from repro_torch.core.multiraft import MultiRaftSim
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BWRaftSim(CONFIG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetSim([MemberSpec(cfg=CONFIG)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiRaftSim(CONFIG)
    from repro_torch.launch.serve import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve(cfg, RunConfig(), requests=1, batch=1, prompt_len=4,
              gen_len=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_lm(cfg, RunConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.from_numpy({}, cfg, RunConfig())
    assert BWRaftSim(CONFIG, device="cpu").state["kv"].device.type == "cpu"


def test_digest_tier_builds_and_unported_fleet_paths_raise():
    """The digest tier is ported (a rack of 550 slots builds on the
    CPU); a trace market is accepted with a trace and refused without
    one with the JAX package's message; the host pipeline, the last
    fleet path to be ported, builds at the paper's cluster and refuses
    an unknown pipeline name."""
    from repro_torch.configs.bwraft_kv import CONFIG
    from repro_torch.core.fleet import FleetSim, MemberSpec
    from repro_torch.core.runtime import BWRaftSim
    from repro_torch.market import load
    sim = BWRaftSim(CONFIG, n_observers=550, device="cpu")
    assert sim.state["dobs_alive"].shape == (550,)
    trace = load("aws-us-east", ticks=200)
    f = FleetSim([MemberSpec(cfg=CONFIG, market="trace", trace=trace)],
                 device="cpu")
    assert f._cfg_c["price_trace"].shape == (1, CONFIG.num_sites, 200)
    with pytest.raises(ValueError, match="needs a market.MarketTrace"):
        FleetSim([MemberSpec(cfg=CONFIG, market="trace")], device="cpu")
    host = FleetSim([MemberSpec(cfg=CONFIG)], pipeline="host", device="cpu")
    assert host.pipeline == "host" and not host.single_dispatch_eligible
    with pytest.raises(ValueError, match="pipeline="):
        FleetSim([MemberSpec(cfg=CONFIG)], pipeline="bogus", device="cpu")
