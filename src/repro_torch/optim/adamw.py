"""AdamW with global-norm clipping (the port of `repro.optim.adamw`).

The state mirrors the parameters, keyed by the model's parameter names
(`{"m": {name: t}, "v": {name: t}, "step": int32 scalar}`), with m/v in
`opt_state_dtype`; `models.lm.to_tree` gives it the JAX tree's layout
for a checkpoint and `opt_from_numpy` carries a JAX state across.  The
update follows the JAX one op for op in float32 — the bias corrections
`1 - b ** step` are float32 powers on the device, as JAX takes them,
never Python float64 ones — and writes the parameters and moments in
place (the JAX step donates them).

On a mesh the parameters are DTensors (`sharding.axes.shard_lm`): m and
v are placed exactly as their parameter (`init_opt_state`,
`opt_from_numpy`), a gradient is brought to its parameter's placements,
the update runs elementwise on each rank's local shards, and
`global_norm` sums the squares of every local shard, each counted once
over the mesh dims that replicate it, then reduces that sum over the
mesh, so that every rank clips by the same norm.
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from repro_torch.models.common import ParamSpec, tree_map
from repro_torch.sharding.axes import is_dtensor


def _local(t):
    """A tensor's local shard (itself, for a plain tensor)."""
    return t.to_local() if is_dtensor(t) else t


def _like(p, local):
    """`local` as the local shard of a tensor placed as `p`."""
    if not is_dtensor(p):
        return local
    from repro_torch.sharding.axes import from_local
    return from_local(local, p.placements, p.device_mesh, p.shape)


def zeros_as(p, dtype=torch.float32):
    """Zeros of `p`'s shape in `dtype`, placed as `p` (each rank
    allocating its own shard)."""
    return _like(p, torch.zeros(_local(p).shape, dtype=dtype,
                                device=p.device))


def init_opt_state(params: Dict[str, torch.Tensor],
                   dtype=torch.float32) -> Dict:
    """m and v at zero in `dtype`, each placed as its parameter."""
    zeros = lambda p: zeros_as(p, dtype)
    dev = next(iter(params.values())).device
    return {"m": {n: zeros(p) for n, p in params.items()},
            "v": {n: zeros(p) for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def abstract_opt_state(param_specs, dtype=torch.float32):
    """ParamSpec mirror of the JAX-layout optimizer tree."""
    conv = lambda p: ParamSpec(p.shape, dtype, p.axes, "zeros")
    return {"m": tree_map(conv, param_specs),
            "v": tree_map(conv, param_specs),
            "step": ParamSpec((), torch.int32, (), "zeros")}


def opt_from_numpy(opt_np, model, device=None) -> Dict:
    """The JAX optimizer tree (`{"m", "v", "step"}`, blocks stacked, as
    numpy; bfloat16 leaves as their uint16 bits) -> the port's state for
    `model`'s parameters, on `device` (None: the model's); each moment
    placed as its parameter where the model is on a mesh (the rank
    keeping its own shard)."""
    from repro_torch.models.lm import from_tree
    from repro_torch.sharding.axes import local_part
    dev = torch.device(device) if device is not None else \
        model.embed.device
    params = dict(model.named_parameters())

    def leaf(a, p=None):
        a = np.array(a)
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            if a.dtype == np.uint16 else torch.from_numpy(a)
        if p is not None and is_dtensor(p):
            t = local_part(t, p.placements, p.device_mesh).contiguous()
        return _like(p, t.to(dev)) if p is not None else t.to(dev)

    return {k: {n: leaf(a, params[n])
                for n, a in from_tree(model, opt_np[k]).items()}
            for k in ("m", "v")} | {
        "step": leaf(np.asarray(opt_np["step"], np.int32))}


def global_norm(leaves: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32.  With
    DTensor leaves each rank sums the squares of its local shards, each
    divided by the number of ranks that hold the same shard (the sizes of
    the mesh dims that do not shard it), and that one sum is reduced over
    every mesh dim: each rank gets the same norm."""
    sq, mesh = [], None
    for x in leaves:
        s = torch.sum(torch.square(_local(x).float()))
        if is_dtensor(x):
            mesh = x.device_mesh
            reps = 1
            for i, p in enumerate(x.placements):
                reps *= 1 if p.is_shard() else mesh.size(i)
            s = s / reps
        sq.append(s)
    total = torch.sum(torch.stack(sq))
    if mesh is not None:
        from repro_torch.sharding.axes import all_reduce
        total = all_reduce(total, "sum", [mesh.get_group(i)
                                          for i in range(mesh.ndim)
                                          if mesh.size(i) > 1])
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], opt_state: Dict, *, lr,
                 b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
                 grad_clip=0.0):
    """One AdamW step over `params` (name -> tensor), in place: the
    parameters, m, v and step.  Returns (params, opt_state, {"grad_norm"}),
    the metric a device scalar.  DTensor gradients are brought to their
    parameters' placements first; the update runs on local shards."""
    step = opt_state["step"]
    step.add_(1)
    grads = {n: grads[n].redistribute(p.device_mesh, p.placements)
             if is_dtensor(grads[n]) else grads[n]
             for n, p in params.items()}
    gnorm = global_norm(grads[n] for n in params)
    scale = None
    if grad_clip:
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    stepf = step.float()
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=step.device)
    b1c = 1.0 - f32(b1) ** stepf
    b2c = 1.0 - f32(b2) ** stepf
    for n, p in params.items():
        # a clipped gradient is float32, as JAX's bf16 x f32 product is
        g = _local(grads[n])
        g32 = g.float() if scale is None else g.float() * scale
        p = _local(p)
        m, v = _local(opt_state["m"][n]), _local(opt_state["v"][n])
        m_new = b1 * m.float() + (1 - b1) * g32
        v_new = b2 * v.float() + (1 - b2) * g32 * g32
        mhat = m_new / b1c
        vhat = v_new / b2c
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)
    return params, opt_state, {"grad_norm": gnorm}
