"""Package rules of the PyTorch port: importing `repro_torch` and every
one of its modules (the fleet, Multi-Raft and both new kernel families
included) loads no `jax` module and nothing of the `repro` package
(checked in a fresh interpreter), importing builds nothing, and an entry
point given no device runs on the card or raises — it never falls back
to the CPU silently."""
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
    assert int(lines[0]) >= 33, out.stdout
    assert lines[1] == "", f"the port imported {lines[1]}"


def test_import_builds_nothing():
    import repro_torch.kernels.build as build
    assert not build._LOADED


def test_entry_points_need_a_device():
    from repro_torch import resolve_device
    from repro_torch.configs.bwraft_kv import CONFIG
    from repro_torch.core.runtime import BWRaftSim
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    from repro_torch.core.fleet import FleetSim, MemberSpec
    from repro_torch.core.multiraft import MultiRaftSim
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BWRaftSim(CONFIG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetSim([MemberSpec(cfg=CONFIG)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiRaftSim(CONFIG)
    assert BWRaftSim(CONFIG, device="cpu").state["kv"].device.type == "cpu"


def test_digest_tier_builds_and_unported_fleet_paths_raise():
    """The digest tier is ported (a rack of 550 slots builds on the
    CPU); what is not ported yet raises and names its ROADMAP item."""
    from repro_torch.configs.bwraft_kv import CONFIG
    from repro_torch.core.fleet import FleetSim, MemberSpec
    from repro_torch.core.runtime import BWRaftSim
    sim = BWRaftSim(CONFIG, n_observers=550, device="cpu")
    assert sim.state["dobs_alive"].shape == (550,)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FleetSim([MemberSpec(cfg=CONFIG, market="trace")], device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FleetSim([MemberSpec(cfg=CONFIG)], pipeline="host", device="cpu")
