"""Package rules of the PyTorch port: importing `repro_torch` and every
one of its modules loads no `jax` module and nothing of the `repro`
package (checked in a fresh interpreter), importing builds nothing, and
an entry point given no device runs on the card or raises — it never
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
    assert int(lines[0]) >= 25, out.stdout
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
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BWRaftSim(CONFIG)
    assert BWRaftSim(CONFIG, device="cpu").state["kv"].device.type == "cpu"


def test_digest_tier_not_ported_raises():
    from repro_torch.configs.bwraft_kv import CONFIG
    from repro_torch.core.runtime import BWRaftSim
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BWRaftSim(CONFIG, n_observers=4, device="cpu")
