"""Production mesh construction: the port of `repro.launch.mesh`.

Functions, not module-level constants, so importing this module
initialises nothing.  The single-pod production mesh is 16 x 16 = 256
ranks, ("data", "model"); the multi-pod mesh adds a leading "pod" axis
(2 pods = 512 ranks).  Both are built over the default process group,
which the caller initialises (`torch.distributed.init_process_group`
with NCCL on a fleet; a fake group of 256 or 512 ranks for a dry run).

`Mesh` carries a JAX-style `shape` (axis names to sizes, in dim order),
which `sharding.axes` and `models.moe.moe_apply` read, and the torch
`DeviceMesh` behind it, or none on a 1 x 1 host mesh.
"""
from __future__ import annotations

from typing import Dict


class Mesh:
    """Named mesh axes and the `DeviceMesh` over them (None when the mesh
    holds one rank)."""

    def __init__(self, shape: Dict[str, int], device_mesh=None):
        self.shape = dict(shape)
        self.device_mesh = device_mesh

    def group(self, axis: str):
        """The process group of this rank's line along `axis`."""
        if self.device_mesh is None:
            raise ValueError(f"a mesh of one rank has no {axis!r} group")
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _build(shape, axes, device_type: str) -> Mesh:
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= s
    dm = DeviceMesh(device_type, torch.arange(n).reshape(shape),
                    mesh_dim_names=axes)
    return Mesh(dict(zip(axes, shape)), dm)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> Mesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") with `multi_pod`, over the default process group, whose
    world size must be the mesh's: the mesh is never shrunk."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = 512 if multi_pod else 256
    world = _world_size()
    if world != want:
        raise ValueError(f"the {'x'.join(map(str, shape))} production mesh "
                         f"needs a process group of {want} ranks, not "
                         f"{world}")
    return _build(shape, axes, device_type)


def make_host_mesh(model: int = 1, device_type: str = "cuda") -> Mesh:
    """("data", "model") over the ranks that exist (tests / smoke runs):
    `model` clamped to [1, world size], `data` the rest.  One rank gives
    a 1 x 1 mesh with no DeviceMesh."""
    n = _world_size()
    model = max(1, min(model, n))
    if n % model:
        raise ValueError(f"a model axis of {model} does not divide {n} "
                         f"ranks")
    if n == 1:
        return Mesh({"data": 1, "model": 1})
    return _build((n // model, model), ("data", "model"), device_type)


#: The card the port targets: NVIDIA H100 SXM (data sheet, dense rates,
#: at its full 700 W power limit).  The byte and FLOP rates are the ones
#: `chip_smoke.py` and PERF.md bound the kernels with.
HW: Dict[str, object] = {
    "name": "NVIDIA H100 80GB HBM3",
    "power_limit_w": 700.0,
    "peak_flops_bf16": 989e12,      # per card, dense tensor-core rate
    "hbm_gbps": 3.35e12,            # bytes/s per card
    "nvlink_gbps": 450e9,           # bytes/s per direction (NVLink 4)
    "hbm_bytes": 80 * 2**30,
}
