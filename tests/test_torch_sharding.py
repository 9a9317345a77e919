"""The port's logical-axis rules (`sharding/axes.py`) against JAX's
`repro.sharding.axes`, which is pure: every architecture x the four
profiles x both production mesh shapes (a stand-in mesh with JAX's own
`FakeMesh` trick from `tests/test_sharding.py`), over the parameter,
train-state (parameters + AdamW moments) and serving-cache spec trees
and the batch specs: the same spec for every leaf and the same
replication fallbacks in the prune log, and the train state's
`launch.steps.state_shardings` against JAX's.  Then the DTensor
placements of a spec, and `constrain` off a mesh."""
from __future__ import annotations

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as j_get_config
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import SHAPES_BY_NAME as J_SHAPES
from repro.configs.base import shape_applicable as j_shape_applicable
from repro.launch import steps as JS
from repro.models.common import ParamSpec as JParamSpec
from repro.sharding import axes as jax_axes
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import RunConfig, SHAPES_BY_NAME
from repro_torch.launch import steps as TS
from repro_torch.models.common import tree_items
from repro_torch.sharding import axes as ax


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
DECODE = ("decode_32k", "long_500k")


def _jax_specs(tree, rules, mesh, log):
    """JAX's `tree_shardings` without the NamedSharding (which needs real
    devices): its leaf names and its `logical_to_spec` calls."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JParamSpec))[0]
    out = []
    for path, p in leaves:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        out.append((name, tuple(jax_axes.logical_to_spec(
            p.axes, p.shape, rules, mesh, name=name, prune_log=log))))
    return out


def _port_specs(tree, rules, mesh, log):
    specs = ax.tree_shardings(tree, rules, mesh, prune_log=log)
    return [("/".join(path), spec) for path, spec in tree_items(specs)]


def _trees(arch):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    jrc, trc = JRunConfig(), RunConfig()
    pairs = [(JS.param_specs(jcfg, jrc), TS.param_specs(tcfg, trc)),
             (JS.train_state_specs(jcfg, jrc),
              TS.train_state_specs(tcfg, trc))]
    for name in DECODE:
        if j_shape_applicable(jcfg, J_SHAPES[name])[0]:
            pairs.append((JS.decode_state_specs(jcfg, J_SHAPES[name], jrc),
                          TS.decode_state_specs(tcfg, SHAPES_BY_NAME[name],
                                                trc)))
    for name in J_SHAPES:
        pairs.append((JS.batch_specs(jcfg, J_SHAPES[name]),
                      TS.batch_specs(tcfg, SHAPES_BY_NAME[name])))
    return jcfg, tcfg, pairs


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("profile", sorted(ax.PROFILES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_and_fallbacks_match_jax(arch, profile, mesh_name):
    mesh = FakeMesh(MESHES[mesh_name])
    jcfg, tcfg, pairs = _trees(arch)
    jrules = JS.resolve_rules(jcfg, profile)
    trules = ax.resolve_rules(tcfg, profile)
    assert trules == jrules
    jlog, tlog = jax_axes.PruneLog(), ax.PruneLog()
    n = 0
    for jtree, ttree in pairs:
        want = _jax_specs(jtree, jrules, mesh, jlog)
        assert _port_specs(ttree, trules, mesh, tlog) == want
        n += len(want)
    assert n > 20
    assert tlog.entries == jlog.entries
    assert tlog.render() == jlog.render()


def test_profiles_match_jax():
    assert ax.PROFILES == jax_axes.PROFILES


@pytest.mark.parametrize("axes,shape,rules,mesh", [
    (("heads", "head_dim"), (15, 64), {"heads": "model"},
     {"data": 16, "model": 16}),
    (("batch",), (32,), {"batch": ("pod", "data", "model")},
     {"pod": 2, "data": 16, "model": 16}),
    (("kv_seq", "kv_heads"), (512, 16),
     {"kv_seq": ("data", "model"), "kv_heads": "model"},
     {"data": 16, "model": 16}),
    (("batch", "embed", None), (7, 64, 3),
     {"batch": ("pod", "data"), "embed": "data"},
     {"pod": 2, "data": 16, "model": 16}),
])
def test_pruning_cases_match_jax(axes, shape, rules, mesh):
    """JAX's own cases: an uneven dim falls back (and is logged), the
    shorter-prefix retry, each mesh axis once per tensor."""
    jlog, tlog = jax_axes.PruneLog(), ax.PruneLog()
    want = jax_axes.logical_to_spec(axes, shape, rules, FakeMesh(mesh),
                                    name="t", prune_log=jlog)
    got = ax.logical_to_spec(axes, shape, rules, FakeMesh(mesh), name="t",
                             prune_log=tlog)
    assert isinstance(want, P) and got == tuple(want)
    assert tlog.entries == jlog.entries


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeMesh(MESHES["2x16x16"])
    assert ax.placements((("pod", "data"), "model", None), mesh) == \
        [Shard(0), Shard(0), Shard(1)]
    assert ax.placements((None, None), mesh) == [Replicate()] * 3
    assert ax.placements((None, ("data", "model")), mesh) == \
        [Replicate(), Shard(1), Shard(1)]
    with pytest.raises(ValueError, match="order"):
        ax.placements((("model", "data"),), mesh)


def test_constrain_is_a_no_op_off_mesh():
    x = torch.ones(4, 8)
    for mesh in (None, FakeMesh({"data": 1, "model": 1}),
                 FakeMesh(MESHES["16x16"])):
        cn = ax.make_constrainer(ax.TRAIN_RULES, mesh)
        assert cn(x, "batch", "embed") is x       # a plain tensor


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-moe-a2.7b",
                                  "seamless-m4t-medium"])
def test_state_shardings_match_jax(arch, mesh_name):
    """`launch.steps.state_shardings` of the train state under the train
    profile: each leaf's spec is the spec of JAX's NamedSharding (over an
    abstract mesh of the production shape)."""
    from jax.sharding import AbstractMesh
    shape = MESHES[mesh_name]
    jmesh = AbstractMesh(tuple(shape.values()), tuple(shape))
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    jsh = JS.state_shardings(JS.train_state_specs(jcfg, JRunConfig()),
                             JS.resolve_rules(jcfg, "train"), jmesh)
    tsh = TS.state_shardings(TS.train_state_specs(tcfg, RunConfig()),
                             ax.resolve_rules(tcfg, "train"),
                             FakeMesh(shape))
    want = [("/".join(str(getattr(k, "key", k)) for k in path),
             tuple(s.spec)) for path, s in
            jax.tree_util.tree_flatten_with_path(jsh)[0]]
    got = [("/".join(path), spec) for path, spec in tree_items(tsh)]
    assert sorted(got) == sorted(want)
