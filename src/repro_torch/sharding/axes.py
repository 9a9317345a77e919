"""Logical-axis sharding rules (MaxText-style) with divisibility pruning:
the port of `repro.sharding.axes`.

Every parameter / activation carries a tuple of *logical* axis names.
A profile maps logical names to mesh axis names; `logical_to_spec`
resolves them against a mesh, dropping any mesh axis that does not
evenly divide the corresponding dimension.  The pruning decisions are
recorded so a report can show which dims fell back to replication (e.g.
smollm's 15 heads on a 16-way "model" axis).

A spec is a tuple with one entry per tensor dim: a mesh-axis name, a
tuple of names, or None (JAX's `PartitionSpec` as a tuple).  A mesh is
anything with a JAX-style `shape` mapping of axis names to sizes, in
the mesh's dim order (`launch.mesh.Mesh`); `placements` turns a spec
into DTensor placements over the mesh's `DeviceMesh`, and `constrain`
redistributes a DTensor to them (the port's
`with_sharding_constraint`).

`distribute` places a whole tensor that every rank holds as a DTensor
of a spec, each rank keeping its own shard and no rank communicating
(JAX's `device_put` of a host array); `shard_lm` does so for every
parameter of an `LM`, to `tree_shardings` of its parameter specs, and
`shard_index` says which shard of a tensor dim this rank holds;
`place` does so for a tensor every rank holds whole at its logical axes
(a model's context).  `split_dim` splits a merged dim (heads x
head_dim) of a DTensor whose shards do not divide its leading part
(`even_dim` gathers such a dim first), and `even_grad` does so for the
gradient of such a merge.  `all_reduce` reduces a plain tensor over the
process groups of mesh axes, one after another (the decode merge,
greedy decoding over a sharded vocabulary), and `psum` sums one under
autograd (the vocabulary-parallel cross entropy).  `local_for` hands a
DTensor operand to a computation that each rank runs on its own share
(the attention and SSD forms on the rank's heads), and says which of
its gradients are partial sums; `use_rules` are ZeRO-3's rules at use.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence, Tuple

Spec = Tuple[Any, ...]

# ---------------------------------------------------------------------------
# Sharding profiles.  Values are mesh-axis names or tuples of them; names not
# present in the mesh are silently skipped (so the same profile serves the
# single-pod ("data","model") and the multi-pod ("pod","data","model") mesh).
# ---------------------------------------------------------------------------

#: Default training profile: DP over (pod, data), ZeRO-3 style weight
#: sharding over "data" on the embed dim, tensor parallelism over "model".
TRAIN_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,                 # "model" in the sequence-parallel profile
    "embed": "data",             # FSDP shard of weight d_model dims
    "embed_tp": None,            # second d_model dim on square weights
    "heads": "model",
    "kv_heads": "model",         # pruned to None when kv < |model|
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",          # expert parallelism
    "expert_mlp": None,
    "shared_mlp": "model",
    "layers": None,
    "conv": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "ssm_heads": "model",
    "img_seq": None,
    "frames": None,
    "kv_seq": None,
    "unsharded": None,
}

#: Serving (decode) profile: batch over data, KV caches sharded over the
#: sequence axis on "model" (flash-decode style), weights as in training.
DECODE_RULES: dict[str, Any] = dict(
    TRAIN_RULES,
    batch=("pod", "data"),
    kv_seq="model",
    embed="data",
)

#: Long-context (batch=1) profile: nothing can shard on batch; KV/sequence
#: state shards over both axes.
LONG_RULES: dict[str, Any] = dict(
    TRAIN_RULES,
    batch=None,
    seq=("data", "model"),
    kv_seq=("data", "model"),
)

#: Sequence-parallel training profile: residual-stream activations shard
#: the sequence dim on "model" between blocks.
TRAIN_SP_RULES: dict[str, Any] = dict(TRAIN_RULES, seq="model")

PROFILES: dict[str, dict[str, Any]] = {
    "train": TRAIN_RULES,
    "train_sp": TRAIN_SP_RULES,
    "decode": DECODE_RULES,
    "long": LONG_RULES,
}


def resolve_rules(cfg, profile: str) -> dict[str, Any]:
    """A profile with the config's `sharding_overrides` on top (JAX's
    `launch.steps.resolve_rules`)."""
    rules = dict(PROFILES[profile])
    rules.update(dict(cfg.sharding_overrides))
    return rules


@dataclasses.dataclass
class PruneLog:
    """Records (path, dim, logical, mesh_axes, size) replication fallbacks."""
    entries: list = dataclasses.field(default_factory=list)

    def add(self, name: str, dim: int, logical: str, axes, size: int) -> None:
        self.entries.append((name, dim, logical, axes, size))

    def render(self) -> str:
        if not self.entries:
            return "(no sharding fallbacks)"
        lines = ["sharding fallbacks (dim -> replicated):"]
        for name, dim, logical, axes, size in self.entries:
            lines.append(f"  {name} dim{dim} [{logical}]={size} !% mesh{axes}")
        return "\n".join(lines)


def _mesh_extent(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def logical_to_spec(
    logical_axes: Sequence[Optional[str]],
    shape: Sequence[int],
    rules: Mapping[str, Any],
    mesh,
    *,
    name: str = "?",
    prune_log: Optional[PruneLog] = None,
) -> Spec:
    """Resolve logical axes -> spec on `mesh`, pruning uneven dims.

    Mesh axes already used by an earlier dim of the same tensor are dropped
    (a mesh axis may appear at most once in a spec).
    """
    if len(logical_axes) != len(shape):
        raise ValueError(f"{name}: axes {logical_axes} for shape {shape}")
    used: set = set()
    out = []
    for dim, (logical, size) in enumerate(zip(logical_axes, shape)):
        if logical is None:
            out.append(None)
            continue
        mapped = rules.get(logical)
        if mapped is None:
            out.append(None)
            continue
        axes = mapped if isinstance(mapped, tuple) else (mapped,)
        axes = tuple(a for a in axes if a in mesh.shape and a not in used)
        if not axes:
            out.append(None)
            continue
        if size % _mesh_extent(mesh, axes) != 0:
            # try progressively shorter prefixes before giving up
            while axes and size % _mesh_extent(mesh, axes) != 0:
                axes = axes[:-1]
            if not axes:
                if prune_log is not None:
                    prune_log.add(name, dim, logical, mapped, size)
                out.append(None)
                continue
        used.update(axes)
        out.append(axes if len(axes) > 1 else axes[0])
    return tuple(out)


def tree_shardings(param_tree, rules: Mapping[str, Any], mesh, *,
                   prune_log: Optional[PruneLog] = None):
    """Map a tree of ParamSpec -> the same tree of specs, each leaf named
    by its path ("blocks/attn/wq") in the prune log."""
    from repro_torch.models.common import tree_items

    out: dict = {}
    for path, p in tree_items(param_tree):
        spec = logical_to_spec(p.axes, p.shape, rules, mesh,
                               name="/".join(path), prune_log=prune_log)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        if path:
            node[path[-1]] = spec
        else:
            return spec
    return out


def _dim_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.shape)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of `spec` over `mesh`'s dims (a `Mesh` or a
    named `DeviceMesh`): `Shard(d)` on each mesh dim that tensor dim d
    names, `Replicate()` on the others.  A tensor dim split over several
    mesh axes takes them in the spec tuple's order, major to minor, which
    is the order DTensor shards in: the mesh's own dim order, so a tuple
    against it is refused.  A mesh dim of size 1 stays `Replicate()`: a
    shard over it is the whole dim, and DTensor cannot merge a dim
    sharded even over one rank with its neighbours (a view)."""
    from torch.distributed.tensor import Replicate, Shard

    names = _dim_names(mesh)
    sizes = mesh.shape if isinstance(mesh.shape, Mapping) else \
        dict(zip(names, mesh.shape))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} takes {axes} against "
                             f"the mesh's order {names}")
        for i, a in zip(idx, axes):
            if sizes[a] > 1:
                out[i] = Shard(d)
    return out


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, logical_axes, rules, mesh):
    """with_sharding_constraint via logical names: a DTensor redistributed
    to the spec's placements; a plain tensor, or any tensor on a mesh of
    one device, unchanged."""
    if mesh is None or _mesh_extent(mesh, tuple(mesh.shape)) == 1 or \
            not is_dtensor(x):
        return x
    spec = logical_to_spec(logical_axes, x.shape, rules, mesh)
    return x.redistribute(x.device_mesh, placements(spec, mesh))


def shard_index(pl, mesh, dim: int) -> Tuple[int, int]:
    """(index, count) of this rank's shard of tensor dim `dim` under the
    placements `pl` on `mesh`: the mesh dims that shard it, major to
    minor in mesh order, as DTensor splits them; (0, 1) when none
    does."""
    from torch.distributed.tensor import Shard

    dm = device_mesh(mesh)
    coord = dm.get_coordinate() if dm is not None else None
    idx, n = 0, 1
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == dim:
            size = dm.size(i)
            idx, n = idx * size + coord[i], n * size
    return idx, n


def even_dim(x, dim: int, size: int):
    """DTensor `x` with its `dim` gathered over the mesh dims that shard
    it where their extent does not divide `size` (DTensor can then split
    or merge it); `x` itself otherwise, and for a plain tensor."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dim = dim % x.dim()
    dm, pl = x.device_mesh, x.placements
    n = 1
    for i in shard_dims(pl, dim):
        n *= dm.size(i)
    if size % n == 0:
        return x
    return x.redistribute(dm, [Replicate() if p.is_shard(dim) else p
                               for p in pl])


def split_dim(x, dim: int, sizes):
    """`x.unflatten(dim, sizes)` (a merged dim such as heads x head_dim
    split back).  DTensor splits a sharded dim only where the shards
    divide its leading part; a DTensor whose `dim` is sharded over mesh
    dims whose extent does not divide sizes[0] (llama3.2-1b's 8 KV heads
    on a 16-way "model" axis) has it gathered over them first
    (`even_dim`), so its parts come out whole, as JAX's pruned rule
    keeps them."""
    return even_dim(x, dim, sizes[0]).unflatten(dim, sizes)


def even_grad(x, dim: int, size: int):
    """`x` unchanged, its gradient passed through `even_dim(g, dim,
    size)` in the backward pass: for a merged dim (heads x head_dim)
    that the backward of its merge splits again, where DTensor may have
    sharded the gradient in a way it cannot split (it would then
    fail)."""
    if not is_dtensor(x) or not x.requires_grad:
        return x
    import torch

    class _EvenGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t.view_as(t)

        @staticmethod
        def backward(ctx, g):
            return even_dim(g, dim, size)

    return _EvenGrad.apply(x)


def device_mesh(mesh):
    """The `DeviceMesh` of a `launch.mesh.Mesh`, or `mesh` itself."""
    return getattr(mesh, "device_mesh", mesh)


def shard_dims(pl, dim: int) -> Tuple[int, ...]:
    """The mesh dims whose placement in `pl` shards tensor dim `dim`."""
    from torch.distributed.tensor import Shard
    return tuple(i for i, p in enumerate(pl)
                 if isinstance(p, Shard) and p.dim == dim)


def local_part(t, pl, mesh):
    """This rank's shard of the whole tensor `t` under placements `pl`
    on `mesh` (a `Mesh` or a `DeviceMesh`; every sharded dim divides
    evenly, as `logical_to_spec` ensures): a view of `t`."""
    for d in range(t.dim()):
        i, n = shard_index(pl, mesh, d)
        if n > 1:
            if t.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(t.shape)} does not "
                                 f"split {n} ways")
            w = t.shape[d] // n
            t = t.narrow(d, i * w, w)
    return t


def from_local(local, pl, mesh, shape):
    """The DTensor of global `shape` whose shard on this rank is `local`
    (no check, no communication)."""
    import torch
    from torch.distributed.tensor import DTensor
    stride = torch.empty(tuple(shape), device="meta").stride()
    return DTensor.from_local(local, device_mesh(mesh), pl, run_check=False,
                              shape=tuple(shape), stride=stride)


def distribute(t, spec: Spec, mesh):
    """A whole tensor held by every rank -> the DTensor of `spec` on
    `mesh`, each rank keeping a contiguous copy of its own shard (a
    copy: a slice of leading rows is contiguous already, and as a view
    it would keep the whole tensor's storage alive)."""
    import torch
    pl = placements(spec, mesh)
    local = local_part(t, pl, mesh).clone(
        memory_format=torch.contiguous_format)
    return from_local(local, pl, mesh, t.shape)


def shard_lm(model, rules, mesh):
    """Replace every parameter of the port's `models.lm.LM` in place by a
    DTensor on `mesh`, sharded as `tree_shardings` places the JAX
    parameter tree under `rules` (a stacked block leaf's spec without its
    "layers" entry), each rank keeping its own shard of the weights it
    holds whole.  Returns the model."""
    from torch import nn

    from repro_torch.models import lm

    specs = tree_shardings(lm.build_param_specs(model.cfg), rules, mesh)
    for path, names in lm.leaf_names(model):
        spec = specs
        for k in path:
            spec = spec[k]
        if lm._stacked(path):
            spec = spec[1:]
        for name in names:
            owner, _, attr = name.rpartition(".")
            mod = model.get_submodule(owner) if owner else model
            p = getattr(mod, attr) if not isinstance(mod, nn.ParameterDict) \
                else mod[attr]
            d = nn.Parameter(distribute(p.detach(), spec, mesh),
                             requires_grad=p.requires_grad)
            if isinstance(mod, nn.ParameterDict):
                mod[attr] = d
            else:
                setattr(mod, attr, d)
    return model


def place(x, logical_axes, rules, mesh):
    """A tensor every rank holds whole, at its logical axes -> the
    DTensor of `rules` on `mesh` (`distribute`; JAX's constraint of an
    input: the model's context)."""
    return distribute(x, logical_to_spec(logical_axes, x.shape, rules, mesh),
                      mesh)


def use_rules(rules) -> dict:
    """ZeRO-3's rules at use (JAX `lm.forward` with `zero3_at_use`): the
    d_model dims of the weights (`embed`) whole, so a layer's weights,
    stored sharded over "data", are gathered over it where they are
    used."""
    return dict(rules, embed=None)


def local_for(t, pl, split):
    """This rank's shard of DTensor `t` redistributed to placements `pl`,
    for a computation each rank runs on its own share, split over the
    mesh dims where the placements `split` shard.  A mesh dim where `pl`
    keeps `t` whole but the computation is split gives each rank a
    different part of `t`'s gradient: its gradient is declared
    `Partial()` there, so autograd sums it over that dim."""
    from torch.distributed.tensor import Partial
    gp = [Partial() if not p.is_shard() and q.is_shard() else p
          for p, q in zip(pl, split)]
    return t.redistribute(t.device_mesh, pl).to_local(grad_placements=gp)


def psum(x, groups):
    """x summed over each process group of `groups` in turn under
    autograd, the cotangent passed through unchanged (`models.moe`'s
    psum: every rank's term receives the whole replicated cotangent)."""
    from repro_torch.models.moe import _psum
    for g in groups:
        x = _psum(x, g)
    return x


def all_reduce(x, op: str, groups):
    """x reduced with `op` ("sum", "max", "min") over each process group
    of `groups` in turn (one mesh axis after another)."""
    from torch.distributed._functional_collectives import all_reduce as ar
    from torch.distributed._functional_collectives import wait_tensor
    for g in groups:
        x = wait_tensor(ar(x.contiguous(), op, g))
    return x


def make_constrainer(rules, mesh):
    def f(x, *logical_axes):
        return constrain(x, logical_axes, rules, mesh)
    return f

