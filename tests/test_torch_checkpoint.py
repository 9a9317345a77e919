"""The port's checkpoint store against the JAX package's on the CPU:
round trip, corruption detected, the asynchronous save and its error
path, `tree_digest` equal to JAX's on the same tree, a checkpoint
written by the JAX store restored by the port bit for bit (bfloat16
leaves included), and the port's files equal to JAX's (the same npz
members: names, dtypes and bytes; the same manifest), so the JAX store
restores a port-written float32/int32 checkpoint.  The JAX store cannot
restore a bfloat16 leaf at all: its `jnp.asarray` refuses the `|V2`
items numpy loads (a reference quirk, ROADMAP.md §3).  All comparisons
are exact."""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro_torch.checkpoint import store as tstore


def _np_tree(seed, big=True):
    """A mixed tree: float32, bfloat16 (as float32 values), int32, a
    scalar, a one-key branch, leaves under and over 4096 bytes."""
    rng = np.random.default_rng(seed)
    n = 3000 if big else 10
    return {
        "params": {"embed": rng.standard_normal((n, 4)).astype(np.float32),
                   "blocks": {"r0": {"w": rng.standard_normal((2, n))
                                     .astype(np.float32)}}},
        "opt": {"m": {"x": rng.standard_normal(7).astype(np.float32)},
                "step": np.array(seed + 3, np.int32)},
        "ids": np.arange(n, dtype=np.int32) * (seed + 1),
    }


BF16 = (("params", "blocks", "r0", "w"),)


def _jax(tree, bf16=BF16):
    out = jax.tree.map(jnp.asarray, tree)
    for path in bf16:
        node = out
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = node[path[-1]].astype(jnp.bfloat16)
    return out


def _torch(jtree):
    def leaf(a):
        a = np.asarray(a)
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree.map(leaf, jtree)


def _bits(t):
    a = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return a.numpy()


def _assert_equal(jtree, ttree):
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = list(tstore._items(ttree))
    assert [jax.tree_util.keystr(p) for p, _ in jl] == \
        [tstore.keystr(p) for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        a = np.asarray(a)
        want = a.view(np.int16) if a.dtype == jnp.bfloat16 else a
        assert tuple(b.shape) == want.shape
        assert np.array_equal(_bits(b), want)


def test_roundtrip(tmp_path):
    store = tstore.CheckpointStore(str(tmp_path), shards=2)
    t = _torch(_jax(_np_tree(0)))
    digest = store.save(3, t)
    like = jax.tree.map(torch.zeros_like, t)
    t2, d2 = store.restore(3, like)
    assert d2 == digest == tstore.tree_digest(t2)
    for (_, a), (_, b) in zip(tstore._items(t), tstore._items(t2)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert sorted(os.listdir(tmp_path / "step_3")) == \
        ["manifest.json", "shard_0.npz", "shard_1.npz"]


def test_digest_detects_corruption(tmp_path):
    store = tstore.CheckpointStore(str(tmp_path))
    t = _torch(_jax(_np_tree(1)))
    d = store.save(1, t)
    assert tstore.tree_digest(_torch(_jax(_np_tree(2)))) != d
    t["params"]["embed"][0, 0] += 1           # in the digested head
    assert tstore.tree_digest(t) != d


def test_async_save_and_its_error(tmp_path):
    store = tstore.CheckpointStore(str(tmp_path))
    t = _torch(_jax(_np_tree(3)))
    d = store.save(7, t, blocking=False)
    t["ids"] += 1                             # the save copied the tree
    store.wait()
    assert 7 in store.available_steps()
    t2, d2 = store.restore(7, t)
    assert d2 == d and not torch.equal(t2["ids"], t["ids"])
    (tmp_path / "step_8").write_text("not a directory")
    store.save(8, t, blocking=False)
    with pytest.raises(OSError):
        store.wait()
    store.wait()                              # the error is raised once


@pytest.mark.parametrize("big", [True, False])
def test_tree_digest_equals_jax(big):
    jt = _jax(_np_tree(4, big))
    assert tstore.tree_digest(_torch(jt)) == jstore.tree_digest(jt)
    # numpy leaves digest alike
    np_leaves = jax.tree.map(lambda a: np.asarray(a, np.float32)
                             if np.asarray(a).dtype == jnp.bfloat16
                             else np.asarray(a), jt)
    assert tstore.tree_digest(np_leaves) == jstore.tree_digest(
        jax.tree.map(jnp.asarray, np_leaves))


def test_jax_checkpoint_restores_in_the_port_and_back(tmp_path):
    """JAX writes (2 shards, bfloat16 included) -> the port restores bit
    for bit with JAX's digest; the port writes the same tree -> the same
    npz members and manifest; JAX restores the port's float32/int32
    checkpoint."""
    jt = _jax(_np_tree(5))
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jd = jstore.CheckpointStore(str(jdir), shards=2).save(4, jt)
    ts = tstore.CheckpointStore(str(tdir), shards=2)
    like = jax.tree.map(torch.zeros_like, _torch(jt))
    got, digest = tstore.CheckpointStore(str(jdir)).restore(4, like)
    assert digest == jd == tstore.tree_digest(got)
    _assert_equal(jt, got)
    assert ts.save(4, got) == jd
    for name in ("shard_0.npz", "shard_1.npz"):
        with np.load(jdir / "step_4" / name) as a, \
                np.load(tdir / "step_4" / name) as b:
            assert a.files == b.files
            for k in a.files:
                assert a[k].dtype.str == b[k].dtype.str
                assert a[k].tobytes() == b[k].tobytes(), k
    assert json.loads((jdir / "step_4" / "manifest.json").read_text()) == \
        json.loads((tdir / "step_4" / "manifest.json").read_text())
    # float32/int32 only: JAX restores what the port wrote
    jt32 = _jax(_np_tree(6), bf16=())
    d32 = ts.save(5, _torch(jt32))
    back, jd32 = jstore.CheckpointStore(str(tdir)).restore(5, jt32)
    assert jd32 == d32 == jstore.tree_digest(back)
    for a, b in zip(jax.tree.leaves(jt32), jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_train_state_checkpoint_roundtrip(tmp_path):
    """A reduced model's train state, after a step, saved through
    `state_tree` and restored into a fresh state by `load_state_tree`:
    every parameter, moment and the step equal, and the same digest."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import steps as S
    from repro_torch.models import lm
    cfg = get_config("smollm-360m").reduced().with_layers(2)
    run = RunConfig(remat=False)
    st = S.init_train_state(lm.init_lm(cfg, run, seed=1, device="cpu",
                                       trainable=True))
    batch = TokenPipeline(DataConfig(cfg.vocab_size, 8, 2)).batch_at(
        0, device="cpu")
    st, _ = S.make_train_step(cfg, run)(st, batch)
    store = tstore.CheckpointStore(str(tmp_path))
    d = store.save(1, S.state_tree(st))
    fresh = S.init_train_state(lm.init_lm(cfg, run, seed=2, device="cpu",
                                          trainable=True))
    tree, d2 = store.restore(1, S.state_tree(fresh))
    S.load_state_tree(fresh, tree)
    assert d2 == d == tstore.tree_digest(S.state_tree(fresh))
    for (_, a), (_, b) in zip(tstore._items(S.state_tree(st)),
                              tstore._items(S.state_tree(fresh))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(fresh["opt"]["step"]) == 1
