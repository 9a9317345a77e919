"""Hand-written CUDA kernels of the port, one family per Pallas family
of `repro.kernels` (DESIGN.md §8).

Each family is `kernel.py` (the ctypes launcher of `csrc/<family>.cu`),
`ref.py` (the plain PyTorch twin) and `ops.py` (the public op).  An op
picks by device: a CPU tensor runs the twin, a CUDA tensor launches the
kernel after its operands are checked, or the op raises; there is no
fallback.  Each op counts its kernel launches in a plain integer
attribute, `<op>.launches`, which `launch_counts` reads.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

OPS = ("log_match_append", "commit_majority", "apply_last_wins",
       "leader_fanout", "ae_sync", "group_reduce")


def _ops():
    from repro_torch.kernels.ae_sync import ops as ae
    from repro_torch.kernels.group_digest import ops as gd
    from repro_torch.kernels.leader_fanout import ops as lf
    from repro_torch.kernels.raft_tick import ops as rt
    return {"log_match_append": rt.log_match_append,
            "commit_majority": rt.commit_majority,
            "apply_last_wins": rt.apply_last_wins,
            "leader_fanout": lf.leader_fanout,
            "ae_sync": ae.ae_sync,
            "group_reduce": gd.group_reduce}


def launch_counts() -> Dict[str, int]:
    """{op name: CUDA launches so far} for the ported kernels."""
    return {name: fn.launches for name, fn in _ops().items()}


def reset_launch_counts() -> None:
    for fn in _ops().values():
        fn.launches = 0


def on_cpu(t: torch.Tensor, op: str) -> bool:
    """True for a CPU tensor (the op runs its twin), False for a CUDA
    tensor (the op launches its kernel); raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{op}: unsupported device {t.device}")


def check(op: str, name: str, t: torch.Tensor, dtype: torch.dtype,
          shape: Sequence[int], device: torch.device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on
    `device` — what the CUDA kernels take."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{op}: {name} must be a tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{op}: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{op}: {name} has dtype {t.dtype}, "
                         f"expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {name} must be contiguous")
