"""AdamW with global-norm clipping (the port of `repro.optim.adamw`).

The state mirrors the parameters, keyed by the model's parameter names
(`{"m": {name: t}, "v": {name: t}, "step": int32 scalar}`), with m/v in
`opt_state_dtype`; `models.lm.to_tree` gives it the JAX tree's layout
for a checkpoint and `opt_from_numpy` carries a JAX state across.  The
update follows the JAX one op for op in float32 — the bias corrections
`1 - b ** step` are float32 powers on the device, as JAX takes them,
never Python float64 ones — and writes the parameters and moments in
place (the JAX step donates them).
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from repro_torch.models.common import ParamSpec, tree_map


def init_opt_state(params: Dict[str, torch.Tensor],
                   dtype=torch.float32) -> Dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)
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
    `model`'s parameters, on `device` (None: the model's)."""
    from repro_torch.models.lm import from_tree
    dev = torch.device(device) if device is not None else \
        model.embed.device

    def leaf(a):
        a = np.array(a)
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            if a.dtype == np.uint16 else torch.from_numpy(a)
        return t.to(dev)

    return {"m": {n: leaf(a) for n, a in from_tree(model, opt_np["m"]).items()},
            "v": {n: leaf(a) for n, a in from_tree(model, opt_np["v"]).items()},
            "step": leaf(np.asarray(opt_np["step"], np.int32))}


def global_norm(leaves: Iterable[torch.Tensor]) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in leaves]
    return torch.sqrt(torch.sum(torch.stack(sq)))


@torch.no_grad()
def adamw_update(params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], opt_state: Dict, *, lr,
                 b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
                 grad_clip=0.0):
    """One AdamW step over `params` (name -> tensor), in place: the
    parameters, m, v and step.  Returns (params, opt_state, {"grad_norm"}),
    the metric a device scalar."""
    step = opt_state["step"]
    step.add_(1)
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
        g32 = grads[n].float() if scale is None else grads[n].float() * scale
        m, v = opt_state["m"][n], opt_state["v"][n]
        m_new = b1 * m.float() + (1 - b1) * g32
        v_new = b2 * v.float() + (1 - b2) * g32 * g32
        mhat = m_new / b1c
        vhat = v_new / b2c
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)
    return params, opt_state, {"grad_norm": gnorm}
