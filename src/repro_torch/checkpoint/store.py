"""Sharded checkpoint store with async save and atomic consensus commit
(the port of `repro.checkpoint.store`).

Layout:  <dir>/step_<N>/shard_<i>.npz + manifest.json, the JAX store's:
a tree is a nested dict (the JAX train state `{"params", "opt": {"m",
"v", "step"}}` with stacked blocks, `launch.steps.state_tree`), each leaf
stored under its JAX `keystr` path (`['params']['embed']`), so either
package reads the other's files.  A bfloat16 leaf is stored as JAX
stores it, as 2-byte void items (`|V2`), and a `|V2` leaf loads as
bfloat16.  A checkpoint is *valid* only once its `CKPT_COMMIT(step,
digest)` record commits in the BW-Raft control log (the coordinator does
that) — a torn/partial save can never be restored because the digest
won't match.  `save` copies the tree to the host before it returns (the
training step updates the state in place); the files are then written
on a worker thread (training continues) and `wait()` joins before the
commit record is proposed, re-raising any error of the write.

On a mesh the tree's leaves are DTensors, each rank holding a shard.
`save` is then a collective: every rank gathers each DTensor leaf whole
(`whole_tree`) before it returns, and one writer, rank 0 of the default
process group, writes the files in the same layout (every leaf whole),
so a checkpoint saved from shards is the one a single device saves of
the same state.  Every rank returns the digest.  `tree_digest` stays
local: it refuses a DTensor leaf.  `restore` with DTensor leaves in
`like_tree` gives each rank the slice of each stored tensor that its
like leaf's placements name.  A tree without DTensors is saved and
restored as on one device.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_HEAD = 4096                  # bytes of each leaf's head and tail digested
_V2 = np.dtype("V2")          # how numpy stores a JAX bfloat16 leaf


def _items(tree, path: Tuple[str, ...] = ()) -> Iterator[
        Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) in JAX's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], path + (k,))
    else:
        yield path, tree


def keystr(path: Tuple[str, ...]) -> str:
    """`jax.tree_util.keystr` of a dict-key path: "['opt']['m']"."""
    return "".join(f"[{k!r}]" for k in path)


def _path_str(path: Tuple[str, ...]) -> str:
    """`str()` of the JAX key path, a tuple of `DictKey`s."""
    keys = [f"DictKey(key={k!r})" for k in path]
    return "(" + ", ".join(keys) + ("," if len(keys) == 1 else "") + ")"


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of the default
    process group, or any process outside one."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def whole_tree(tree):
    """`tree` with each DTensor leaf gathered whole on every rank (a
    collective: every rank calls it with the same tree)."""
    from repro_torch.sharding.axes import is_dtensor

    def whole(t):
        if isinstance(t, dict):
            return {k: whole(v) for k, v in t.items()}
        return t.full_tensor() if is_dtensor(t) else t
    return whole(tree)


def _host(t) -> np.ndarray:
    """A copy of a leaf on the host as numpy, bfloat16 as its 2-byte
    items (a copy even of a CPU tensor: the state changes in place while
    an asynchronous save writes)."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        t = t.clone() if t.device.type == "cpu" else t.cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_V2)
        return t.numpy()
    return np.array(t)


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype == _V2:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _head_tail(leaf) -> Tuple[tuple, bytes, bytes]:
    """(shape, first and last 4096 bytes): only those cross to the host."""
    from repro_torch.sharding.axes import is_dtensor
    if is_dtensor(leaf):
        raise TypeError("tree_digest takes whole tensors: gather a tree "
                        "of DTensors with whole_tree first")
    if isinstance(leaf, torch.Tensor):
        flat = leaf.detach().reshape(-1)
        n = _HEAD // flat.element_size()
        if flat.numel() > n:
            return (tuple(leaf.shape), _host(flat[:n]).tobytes(),
                    _host(flat[-n:]).tobytes())
        leaf = _host(flat).reshape(tuple(leaf.shape))
    raw = np.asarray(leaf).tobytes()
    return np.asarray(leaf).shape, raw[:_HEAD], raw[-_HEAD:]


def tree_digest(tree) -> str:
    """The JAX `tree_digest`: sha256 over every leaf, in the order of its
    key path's text, of that text, the shape and the leaf's first and
    last 4096 bytes; 16 hex digits.  Equal to JAX's on the same tree.
    Local: a tree of DTensors is refused (digest `whole_tree(tree)`)."""
    h = hashlib.sha256()
    for path, leaf in sorted(_items(tree), key=lambda kv: _path_str(kv[0])):
        shape, head, tail = _head_tail(leaf)
        h.update(_path_str(path).encode())
        h.update(str(shape).encode())
        h.update(head)      # prefix digest: fast + effective
        h.update(tail)
    return h.hexdigest()[:16]


class CheckpointStore:
    def __init__(self, directory: str, *, shards: int = 1):
        self.dir = directory
        self.shards = shards
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None

    # ------------------------------------------------------------------ #
    def _flatten(self, tree) -> Dict[str, np.ndarray]:
        return {keystr(path): _host(leaf) for path, leaf in _items(tree)}

    def save(self, step: int, tree, *, blocking: bool = True) -> str:
        """Write shards + manifest (the writer only); returns the
        digest."""
        tree = whole_tree(tree)
        digest = tree_digest(tree)
        if not _writer():
            return digest
        flat = self._flatten(tree)

        def work():
            try:
                d = os.path.join(self.dir, f"step_{step}")
                os.makedirs(d, exist_ok=True)
                names = sorted(flat)
                per = -(-len(names) // self.shards)
                for i in range(self.shards):
                    chunk = {n: flat[n] for n in names[i * per:(i + 1) * per]}
                    np.savez(os.path.join(d, f"shard_{i}.npz"), **chunk)
                manifest = {"step": step, "digest": digest,
                            "shards": self.shards, "n_arrays": len(names)}
                tmp = os.path.join(d, "manifest.json.tmp")
                with open(tmp, "w") as f:
                    json.dump(manifest, f)
                os.replace(tmp, os.path.join(d, "manifest.json"))
            except BaseException as e:      # surfaced by wait()
                self._last_error = e

        if blocking:
            work()
        else:
            self.wait()
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        return digest

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err

    # ------------------------------------------------------------------ #
    def restore(self, step: int, like_tree) -> Tuple[Any, str]:
        """Load a checkpoint into the structure of `like_tree` (a nested
        dict of tensors); each leaf lands on its `like_tree` leaf's
        device, in the dtype it was stored in, a DTensor like leaf's as
        the DTensor of this rank's slice of the stored tensor, placed as
        the like leaf is.  Returns (tree, digest)."""
        from repro_torch.sharding.axes import (from_local, is_dtensor,
                                               local_part)
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        data: Dict[str, np.ndarray] = {}
        for i in range(manifest["shards"]):
            with np.load(os.path.join(d, f"shard_{i}.npz")) as z:
                data.update({k: z[k] for k in z.files})
        out: Dict[str, Any] = {}
        for path, like in _items(like_tree):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            a = data[keystr(path)]
            if is_dtensor(like):
                pl, dm = like.placements, like.device_mesh
                t = local_part(_to_tensor(a, "cpu"), pl, dm)
                local = torch.empty(t.shape, dtype=t.dtype,
                                    device=like.device).copy_(t)
                node[path[-1]] = from_local(local, pl, dm, a.shape)
                continue
            dev = like.device if isinstance(like, torch.Tensor) else "cpu"
            node[path[-1]] = _to_tensor(a, dev)
        return out, manifest["digest"]

    def available_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
        return sorted(out)
