"""Mixture-of-Experts MLP (the port of `repro.models.moe`): a router over
the experts padded to a multiple of 16, top-k with renormalized weights,
the Switch load-balance aux loss, and shared experts as a dense SwiGLU
added on top.

On one device the JAX layer runs its dense oracle: its host mesh has a
"model" (expert) axis of 1, so `moe_apply` returns `moe_apply_dense`,
which computes every expert for every token and combines them with the
router's weights.  The port runs the same function on one card, in plain
torch products (the JAX layer reaches no Pallas kernel).  The expert
products run in the activation dtype, SiLU in float32, the combine in
float32, as in JAX.  The expert-parallel forms (`_moe_local_a2a` and
`_moe_local_psum`, an expert axis above 1) are ROADMAP.md §1 item 10e.

Ties in the router's top-k take the lowest expert ids first, as
`lax.top_k` does: the ids come from a stable descending sort, where
`torch.topk` promises no order among equal values.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, swiglu, unported, upcast


def padded_experts(e: int, multiple: int = 16) -> int:
    return ((e + multiple - 1) // multiple) * multiple


def moe_params(cfg, dtype=torch.bfloat16):
    D, Fe = cfg.d_model, cfg.moe_d_ff
    E = padded_experts(cfg.moe_num_experts)
    p = {
        "pre_norm": ParamSpec((D,), torch.float32, ("unsharded",), "ones"),
        "router": ParamSpec((D, E), torch.float32, ("embed", "experts")),
        "wg": ParamSpec((E, D, Fe), dtype, ("experts", "embed", "expert_mlp")),
        "wu": ParamSpec((E, D, Fe), dtype, ("experts", "embed", "expert_mlp")),
        "wd": ParamSpec((E, Fe, D), dtype, ("experts", "expert_mlp", "embed")),
    }
    if cfg.moe_shared_d_ff:
        Fs = cfg.moe_shared_d_ff
        p["shared_wg"] = ParamSpec((D, Fs), dtype, ("embed", "shared_mlp"))
        p["shared_wu"] = ParamSpec((D, Fs), dtype, ("embed", "shared_mlp"))
        p["shared_wd"] = ParamSpec((Fs, D), dtype, ("shared_mlp", "embed"))
    return p


def _route(x_flat, router, cfg):
    """x_flat: (T,D) -> top-k (weights (T,k) float32, ids (T,k) int64,
    aux loss): the padded experts masked to -1e30, a float32 softmax,
    the k largest (lowest ids first among equals), renormalized."""
    E = cfg.moe_num_experts
    logits = x_flat.to(router.dtype) @ router                # (T, E_pad)
    pad = torch.arange(logits.shape[-1], device=logits.device) >= E
    logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :cfg.moe_top_k], ids[:, :cfg.moe_top_k]
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    # Switch aux loss: E * sum_e f_e * p_e, f_e the share of tokens
    # routed to e (a k-hot row per token: a scatter, where `one_hot`
    # may read the ids on the host)
    frac = torch.zeros_like(probs).scatter_(1, ids, 1.0).mean(dim=0)
    aux = E * torch.sum(frac * probs.mean(dim=0)) / cfg.moe_top_k
    return w, ids, aux


def moe_apply_dense(p, x, cfg):
    """Every expert on every token, masked combine: x (B,S,D) -> (y, aux
    loss).  O(E·T·D·F): every decode step reads every expert."""
    B, S, D = x.shape
    xf = x.reshape(-1, D)
    w, ids, aux = _route(xf, p["router"], cfg)
    E_pad = p["wg"].shape[0]
    comb = torch.zeros((xf.shape[0], E_pad), dtype=w.dtype,
                       device=x.device).scatter_add_(1, ids, w)
    g = torch.matmul(xf, p["wg"])                            # (E, T, F)
    u = torch.matmul(xf, p["wu"])
    h = F.silu(upcast(g)).to(x.dtype) * u
    y_all = torch.matmul(h, p["wd"])                         # (E, T, D)
    y = torch.einsum("etd,te->td", y_all.to(comb.dtype), comb)
    y = y.to(x.dtype).reshape(B, S, D)
    if "shared_wg" in p:
        y = y + swiglu(x, p["shared_wg"], p["shared_wu"], p["shared_wd"])
    return y, aux


def moe_apply(p, x, cfg, mesh=None):
    """The MoE layer: x (B,S,D) -> (y, aux loss).  `mesh` is anything
    with a JAX-style `shape` mapping of axis names to sizes; with none,
    or an expert ("model") axis of 1, this is the dense path, as on the
    JAX host mesh."""
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        raise unported("the expert-parallel MoE (all-to-all and psum "
                       "forms)", "10e")
    return moe_apply_dense(p, x, cfg)
