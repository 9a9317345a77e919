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
    against it is refused."""
    from torch.distributed.tensor import Replicate, Shard

    names = _dim_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} takes {axes} against "
                             f"the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, logical_axes, rules, mesh):
    """with_sharding_constraint via logical names: a DTensor redistributed
    to the spec's placements; a plain tensor, or any tensor on a mesh of
    one device, unchanged."""
    if mesh is None or _mesh_extent(mesh, tuple(mesh.shape)) == 1 or \
            not _is_dtensor(x):
        return x
    spec = logical_to_spec(logical_axes, x.shape, rules, mesh)
    return x.redistribute(x.device_mesh, placements(spec, mesh))


def make_constrainer(rules, mesh):
    def f(x, *logical_axes):
        return constrain(x, logical_axes, rules, mesh)
    return f

