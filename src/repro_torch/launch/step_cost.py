"""What one step costs a rank: the accounting of the dry run
(`launch/dryrun.py`), which also runs around a real step to check it.

`StepCost` is a `TorchDispatchMode` that sees the *local* ops a rank
dispatches: an op on DTensors is handed back to DTensor (the mode
returns `NotImplemented`), which runs it as ops on the rank's local
shards and its collectives, and those come back to the mode.  So the
counts are per rank, where `torch.utils.flop_counter.FlopCounterMode`
around DTensor ops counts each op's global work.  The ops that DTensor's
sharding propagation runs on global shapes to learn an output's
metadata are skipped.  Per step it keeps:

* `flops`: the local matrix products by `flop_counter`'s formulas, plus
  what the model kernels report on the card (`kernels.COST_SINKS`:
  their `flops(...)`), which no dispatch sees inside a ctypes launch;
* `nbytes`: the bytes of every operand and result of each local op
  that moves data (views and allocations move none), and of each kernel
  call.  This is the port's eager traffic, op by op: XLA's "bytes
  accessed" of a fused program is smaller;
* `records`: the collectives (`comm_stats.CollectiveRecorder`, as it
  stands), for `comm_stats.collective_stats`;
* `kernel_calls`: the model kernels' calls on the card by op name;
* `peak`: the most bytes of storage live at once, counting from the
  storages passed to `track` (the step's arguments) and every storage a
  local op makes, each until it is freed.

It works on fake tensors (a dry run under `FakeTensorMode`) and on real
ones alike.  `tensors(obj)` lists the local tensors of a nested
argument (dicts, lists, tuples, modules, DTensors), and
`storage_bytes(ts)` the bytes of their distinct storages
(`storage_key`).
"""
from __future__ import annotations

import sys
import weakref
from collections import Counter
from typing import Dict, Iterator, List

import torch
from torch import nn
from torch.utils.flop_counter import flop_registry

from repro_torch import kernels as tk
from repro_torch.launch.comm_stats import CollectiveRecorder

#: ops that allocate without reading or writing data, or only wait
_NO_TRAFFIC = ("aten::empty", "aten::empty_strided", "aten::empty_like",
               "aten::new_empty", "aten::new_empty_strided",
               "_c10d_functional::wait_tensor")


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor
    return issubclass(t, DTensor)


def _in_sharding_prop() -> bool:
    """Called from DTensor's sharding propagation (its metadata-only runs
    of an op on global shapes, and the tensors it makes for them), within
    a few frames."""
    f = sys._getframe(2)
    for _ in range(16):
        if f is None:
            return False
        if f.f_code.co_filename.endswith("sharding_prop.py"):
            return True
        f = f.f_back
    return False


def tensors(obj) -> Iterator[torch.Tensor]:
    """The local tensors of a nested step argument or result: leaves of
    dicts, lists and tuples, a module's parameters, a DTensor's local
    shard."""
    if isinstance(obj, nn.Module):
        obj = list(obj.parameters())
    if isinstance(obj, dict):
        for v in obj.values():
            yield from tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from tensors(v)
    elif isinstance(obj, torch.Tensor):
        from repro_torch.sharding.axes import is_dtensor
        yield obj._local_tensor if is_dtensor(obj) else obj


def storage_key(t: torch.Tensor) -> int:
    """An id of `t`'s storage, shared by its views, while it lives."""
    return t.untyped_storage()._cdata


def storage_bytes(ts) -> int:
    """The bytes of the distinct storages behind the tensors `ts`."""
    return sum({storage_key(t): t.untyped_storage().nbytes()
                for t in ts}.values())


class StepCost(CollectiveRecorder):
    """`with StepCost() as cost: cost.track(args); step(*args)` counts
    the step's local work (the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.nbytes = 0
        self.kernel_calls: Counter = Counter()
        self.live = 0
        self.peak = 0
        self._live: Dict[int, int] = {}

    # -- storage liveness ---------------------------------------------
    def _free(self, key: int, n: int) -> None:
        if self._live.pop(key, None) is not None:
            self.live -= n

    def _note(self, t: torch.Tensor) -> None:
        if t.device.type == "meta":       # a shape, never memory
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live += n
        weakref.finalize(st, self._free, key, n)

    def track(self, ts) -> int:
        """Count the storages of `ts` (the step's arguments) as live from
        now; returns their bytes."""
        before = self.live
        for t in ts:
            self._note(t)
        self.peak = max(self.peak, self.live)
        return self.live - before

    # -- the kernels' reports -----------------------------------------
    def add_cost(self, op: str, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.nbytes += nbytes
        self.kernel_calls[op] += 1

    def __enter__(self):
        tk.COST_SINKS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        tk.COST_SINKS.remove(self)
        return super().__exit__(*exc)

    # -- the local ops ------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented
        if _in_sharding_prop():
            return func(*args, **kwargs)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        fn = flop_registry.get(func.overloadpacket)
        if fn is not None:
            self.flops += int(fn(*args, **kwargs, out_val=out))
        outs = _flat(out)
        if not func.is_view and func._schema.name not in _NO_TRAFFIC:
            self.nbytes += sum(t.numel() * t.element_size()
                               for t in _flat(args) + _flat(kwargs) + outs)
        for t in outs:
            self._note(t)
        self.peak = max(self.peak, self.live)
        return out


def _flat(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat(v)]
    return []
