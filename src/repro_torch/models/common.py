"""Parameter descriptors, initialization and shared layer math (the port
of `repro.models.common`).

A model is (1) a tree of `ParamSpec` descriptors built from its config,
with the JAX package's shapes and nesting, and (2) functions that apply
it.  `init_tree` materializes a spec tree on a `torch.Generator`'s
device with the same fan-in rule as the JAX `init_tree`; the numbers
differ (torch cannot reproduce `jax.random`), so the tests carry JAX's
own weights across instead (`models/lm.py:from_numpy`).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: Any                            # a torch dtype
    axes: Tuple[Optional[str], ...]       # logical axis names, len == ndim
    init: str = "normal"                  # normal | zeros | ones | embed
    scale: float = 1.0


def _is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_items(tree, prefix: Tuple[str, ...] = ()) -> Iterator[
        Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs of a nested dict in JAX's flatten order (keys
    sorted at every level)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_map(fn: Callable, tree):
    """`fn` applied to every leaf of a nested dict (ParamSpecs are
    leaves)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_tree(gen: torch.Generator, tree) -> Dict:
    """Materialize parameters on `gen`'s device, one leaf after another
    in flatten order: fan-in scaled normal by default (`std = scale /
    sqrt(shape[-2])`, or `shape[-1]` for a vector), zeros or ones."""
    def one(p: ParamSpec):
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=p.dtype, device=gen.device)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=p.dtype, device=gen.device)
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        std = p.scale / math.sqrt(max(fan_in, 1))
        a = torch.randn(p.shape, generator=gen, dtype=torch.float32,
                        device=gen.device)
        return (a * std).to(p.dtype)

    out: Dict = {}
    for path, p in tree_items(tree):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = one(p)
    return out


def empty_tree(tree, device) -> Dict:
    """An uninitialised tensor of each ParamSpec's shape and dtype on
    `device` (the port of JAX's `abstract_tree`): under `FakeTensorMode`
    (a dry run, `launch/dryrun.py`) they hold no memory and cost
    nothing."""
    return tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                          device=device), tree)


def zeros_tree(tree, device) -> Dict:
    """A zero tensor for every ParamSpec of a nested dict."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=p.dtype,
                                          device=device), tree)


def assign(dst, src) -> None:
    """dst.copy_(src) in place; for a DTensor `dst`, `src` redistributed
    to its placements first and the rank's shards copied."""
    from repro_torch.sharding.axes import is_dtensor
    if is_dtensor(dst):
        src = src.redistribute(dst.device_mesh, dst.placements)
        dst.to_local().copy_(src.to_local())
    else:
        dst.copy_(src)


def param_count(tree) -> int:
    return sum(int(np.prod(p.shape)) for _, p in tree_items(tree))


def param_bytes(tree) -> int:
    return sum(int(np.prod(p.shape)) * p.dtype.itemsize
               for _, p in tree_items(tree))


# ---------------------------------------------------------------------------
# Shared layer math (the same float32 upcasts as the JAX forms)
# ---------------------------------------------------------------------------

def upcast(x: torch.Tensor) -> torch.Tensor:
    """x in float32, the JAX forms' upcast; a float64 tensor (a float64
    reference run of the model) stays float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = upcast(x)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * gamma.to(x.dtype)).to(dt)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


_FREQS: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}


def _freqs_on(hd: int, theta: float, device) -> torch.Tensor:
    """`rope_freqs` on `device`, copied there once: a host-to-device copy
    per layer would make the host wait for the card at every layer."""
    key = (hd, theta, device)
    if key not in _FREQS:
        _FREQS[key] = torch.as_tensor(rope_freqs(hd, theta), device=device)
    return _FREQS[key]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = _freqs_on(hd, theta, x.device)
    xf = upcast(x)
    ang = positions[..., :, None].to(xf.dtype) * freqs    # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]                 # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = xf.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x, wg, wu, wd, *, bg=None, bu=None, bd=None):
    g = x @ wg
    u = x @ wu
    if bg is not None:
        g = g + bg
        u = u + bu
    h = torch.nn.functional.silu(upcast(g)).to(x.dtype) * u
    out = h @ wd
    if bd is not None:
        out = out + bd
    return out


def cross_entropy(logits, labels, vocab_size: int):
    """Mean next-token cross entropy in float32; logits may carry padded
    vocab entries, masked to -1e30 before the logsumexp.  DTensor logits
    (a forward on a mesh) take `_cross_entropy_sharded`."""
    from repro_torch.sharding.axes import is_dtensor
    if is_dtensor(logits):
        return _cross_entropy_sharded(logits, labels, vocab_size)
    padded = logits.shape[-1]
    logits = logits.float()
    if padded != vocab_size:
        mask = torch.arange(padded, device=logits.device) < vocab_size
        logits = torch.where(mask, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - picked)


def _cross_entropy_sharded(logits, labels, vocab_size: int):
    """The vocabulary-parallel cross entropy of DTensor logits (B,S,Vp)
    placed (batch, seq, vocab), `labels` (B,S) a tensor every rank holds
    whole: on its rows, each rank takes the max and the sum of
    exponentials over its vocabulary shard (the padded entries past
    `vocab_size` masked), all-reduces them over the vocabulary's mesh
    axes, and takes each label's logit from the rank that holds it (a
    sum over those axes of the owner's value and zeros); the rows'
    losses are then summed over the axes that shard the rows.  The
    logits are never gathered.  Returns the mean, a plain float32 tensor
    every rank holds."""
    from torch.distributed.tensor import Replicate

    from repro_torch.sharding.axes import (all_reduce, psum, shard_dims,
                                           shard_index)
    dm = logits.device_mesh
    if any(p.is_partial() for p in logits.placements):
        logits = logits.redistribute(dm, [
            Replicate() if p.is_partial() else p for p in logits.placements])
    pl = logits.placements
    B, S, Vp = logits.shape
    lg = logits.to_local().float()
    Bl, Sl, Vl = lg.shape

    def groups(*dims):
        return [dm.get_group(i) for d in dims for i in shard_dims(pl, d)
                if dm.size(i) > 1]

    bi = shard_index(pl, dm, 0)[0]
    si = shard_index(pl, dm, 1)[0]
    v0 = shard_index(pl, dm, 2)[0] * Vl
    if Vp != vocab_size:
        mask = torch.arange(v0, v0 + Vl, device=lg.device) < vocab_size
        lg = torch.where(mask, lg, -1e30)
    vg = groups(2)
    m = all_reduce(lg.detach().amax(dim=-1), "max", vg)
    lse = m + torch.log(psum(torch.exp(lg - m[..., None]).sum(dim=-1), vg))
    idx = labels[bi * Bl:(bi + 1) * Bl, si * Sl:(si + 1) * Sl].long() - v0
    own = (idx >= 0) & (idx < Vl)
    picked = torch.gather(lg, -1, idx.clamp(0, Vl - 1)[..., None])[..., 0]
    picked = psum(torch.where(own, picked, 0.0), vg)
    return psum((lse - picked).sum(), groups(0, 1)) / (B * S)
