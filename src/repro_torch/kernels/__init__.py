"""Hand-written CUDA kernels of the port, one family per Pallas family
of `repro.kernels` (DESIGN.md §8; the two attention families and the SSD
scan serve the model stack, DESIGN.md §3).

Each family is `kernel.py` (the ctypes launcher of `csrc/<family>.cu`),
`ref.py` (the plain PyTorch twin) and `ops.py` (the public op).  An op
picks by device: a CPU tensor runs the twin, a CUDA tensor launches the
kernel after its operands are checked, or the op raises; there is no
fallback.  Each op counts its kernel launches in a plain integer
attribute, `<op>.launches`, which `launch_counts` reads; the ops with a
tensor-core and a scalar route (the two attention ops and the SSD scan)
also count per route in `<op>.route_launches`, which `route_counts`
reads.  Every launcher launches inside `device_stream(t)`, on the device
of its own operand and that device's current stream.

The model kernels (flash, decode, ssd_scan) also take fake operands
(`torch._subclasses.fake_tensor.is_fake`: a dry run under
`FakeTensorMode`, `launch/dryrun.py`): the op checks them as it checks
the card's, bar the alignment that needs an address, and returns empty
outputs of the kernel's shapes, launching and counting nothing.  On the
card, real or fake, each of them reports its work (`flops(...)` of its
package, and the bytes of its operands and results) to the cost sinks
in `COST_SINKS` when there are any: the dry run's accounting, which
cannot see inside a ctypes launch.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Sequence

import torch
from torch._subclasses.fake_tensor import FakeTensor

OPS = ("log_match_append", "commit_majority", "apply_last_wins",
       "leader_fanout", "ae_sync", "group_reduce", "flash_attention",
       "decode_attention", "ssd_scan")


def _ops():
    from repro_torch.kernels.ae_sync import ops as ae
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.group_digest import ops as gd
    from repro_torch.kernels.leader_fanout import ops as lf
    from repro_torch.kernels.raft_tick import ops as rt
    from repro_torch.kernels.ssd_scan import ops as ss
    return {"log_match_append": rt.log_match_append,
            "commit_majority": rt.commit_majority,
            "apply_last_wins": rt.apply_last_wins,
            "leader_fanout": lf.leader_fanout,
            "ae_sync": ae.ae_sync,
            "group_reduce": gd.group_reduce,
            "flash_attention": fa.flash_attention,
            "decode_attention": da.decode_attention,
            "ssd_scan": ss.ssd_scan}


def launch_counts() -> Dict[str, int]:
    """{op name: CUDA launches so far} for the ported kernels."""
    return {name: fn.launches for name, fn in _ops().items()}


ROUTED = ("flash_attention", "decode_attention", "ssd_scan")


def route_counts() -> Dict[str, Dict[str, int]]:
    """{op name: {route: CUDA launches so far}} for the routed ops."""
    ops = _ops()
    return {name: dict(ops[name].route_launches) for name in ROUTED}


def reset_launch_counts() -> None:
    ops = _ops()
    for fn in ops.values():
        fn.launches = 0
    for name in ROUTED:
        ops[name].route_launches = dict.fromkeys(ops[name].route_launches, 0)
    ops["decode_attention"].lse_launches = 0


@contextlib.contextmanager
def device_stream(t: torch.Tensor) -> Iterator[int]:
    """Make `t`'s card the current device for the launch (the CUDA side
    sets per-device attributes on `cudaGetDevice()`'s device) and yield
    that card's current stream as an int for the ctypes call."""
    with torch.cuda.device(t.device):
        yield torch.cuda.current_stream(t.device).cuda_stream


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


def is_fake(t: torch.Tensor) -> bool:
    """A fake operand (a dry run's, under `FakeTensorMode`): what
    `torch._subclasses.fake_tensor.is_fake` says of the plain tensors the
    kernels take, as one type check on the launch path (`is_fake` also
    unwraps tensor subclasses, which costs several times more)."""
    return isinstance(t, FakeTensor)


#: Receivers of the model kernels' work on the card: objects with
#: `add_cost(op, flops, nbytes)` (`launch.dryrun.StepCost`), pushed and
#: popped by their owner.  Empty outside an accounted run.
COST_SINKS: list = []


def note_cost(op: str, flops: int, tensors) -> None:
    """Report a kernel call's `flops` and the bytes of `tensors` (its
    operands and results, each read or written once) to every sink."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors
                 if t is not None)
    for sink in COST_SINKS:
        sink.add_cost(op, flops, nbytes)
