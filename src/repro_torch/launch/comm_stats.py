"""Collective accounting of the port: the counterpart of
`repro.launch.hlo_stats`.

The port has no HLO text to parse, so it records the collectives as
they are made: `CollectiveRecorder` is a `TorchDispatchMode` that
notes each collective op reaching the dispatcher, functional
(`_c10d_functional.*`, which DTensor's redistributions and
`models.moe`'s bodies make) or not (`c10d.*`, what
`torch.distributed.all_reduce` and its kin make), with its kind, the
bytes of its result and the size of its group.  The accounting is
JAX's: from the result's bytes and the participant count n, standard
ring-algorithm wire bytes *per device*:

  all-gather          result x (n-1)/n        (operand = result/n)
  reduce-scatter      result x (n-1)          (operand = result x n)
  all-reduce          2 x result x (n-1)/n    (RS + AG phases)
  all-to-all          result x (n-1)/n
  collective-permute  result                  (one hop)

with the same kind names and the same `{kind: {count, result_bytes,
wire_bytes}}` table, so a report prints JAX's.  Ops that only wait on
or copy a collective's result are not collectives and are skipped.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8, "f8e4m3fn": 1, "f8e5m2": 1,
    "bf16": 2, "f16": 2, "f32": 4, "f64": 8, "c64": 8, "c128": 16,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# op name (namespace.name, without the overload) -> (kind, where the
# result is: "out" the op's return value, or the index of the argument
# the op writes in place)
_OPS = {
    "_c10d_functional.all_reduce": ("all-reduce", "out"),
    "_c10d_functional.all_reduce_": ("all-reduce", "out"),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", "out"),
    "_c10d_functional.all_reduce_coalesced_": ("all-reduce", "out"),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", "out"),
    "_c10d_functional.all_gather_into_tensor_out": ("all-gather", "out"),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather",
                                                         "out"),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", "out"),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter",
                                                         "out"),
    "_c10d_functional.all_to_all_single": ("all-to-all", "out"),
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allgather_": ("all-gather", 0),
    "c10d._allgather_base_": ("all-gather", 0),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 0),
    "c10d.reduce_scatter_": ("reduce-scatter", 0),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 0),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "c10d.alltoall_base_": ("all-to-all", 0),
    "c10d.alltoall_": ("all-to-all", 0),
}


class Record(NamedTuple):
    kind: str
    result_bytes: int
    group_size: int


def shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _group_size(func, args, kwargs) -> int:
    """The size of the op's group: a functional op names it
    (`group_name`), a c10d op passes the ProcessGroup itself."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for i, a in enumerate(func._schema.arguments):
        v = args[i] if i < len(args) else kwargs.get(a.name)
        if a.name == "group_name":
            return _resolve_process_group(v).size()
        if a.name == "process_group":
            return dist.ProcessGroup.unbox(v).size()
    raise ValueError(f"{func._schema.name} names no process group")


class CollectiveRecorder(TorchDispatchMode):
    """`with CollectiveRecorder() as rec:` notes every collective made
    inside as a `Record` in `rec.records`, in order."""

    def __init__(self):
        super().__init__()
        self.records: List[Record] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        entry = _OPS.get(func._schema.name.replace("::", "."))
        if entry is not None:
            kind, where = entry
            res = out if where == "out" else args[where]
            self.records.append(Record(
                kind, sum(t.numel() * t.element_size()
                          for t in _tensors(res)),
                _group_size(func, args, kwargs)))
        return out


def _wire_factor(kind: str, n: int) -> float:
    if n <= 1:
        return 0.0
    if kind == "all-gather":
        return (n - 1) / n
    if kind == "reduce-scatter":
        return float(n - 1)
    if kind == "all-reduce":
        return 2 * (n - 1) / n
    if kind == "all-to-all":
        return (n - 1) / n
    return 1.0  # collective-permute


def collective_stats(records: Iterable[Record]) -> Dict[str, Dict[str, float]]:
    """{kind: {count, result_bytes, wire_bytes}} per device."""
    out: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "result_bytes": 0.0, "wire_bytes": 0.0})
    for kind, nbytes, n in records:
        out[kind]["count"] += 1
        out[kind]["result_bytes"] += nbytes
        out[kind]["wire_bytes"] += nbytes * _wire_factor(kind, n)
    return dict(out)


def total_collective_bytes(records: Iterable[Record]) -> int:
    """Total wire bytes per device."""
    return int(sum(v["wire_bytes"]
                   for v in collective_stats(records).values()))


def render_stats(stats: Dict[str, Dict[str, float]]) -> str:
    if not stats:
        return "  (no collectives)"
    lines = []
    for k in sorted(stats):
        v = stats[k]
        lines.append(f"  {k:20s} count={int(v['count']):4d} "
                     f"result={v['result_bytes'] / 1e6:10.2f} MB "
                     f"wire={v['wire_bytes'] / 1e6:10.2f} MB")
    return "\n".join(lines)
