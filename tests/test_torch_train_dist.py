"""`launch/train.py` on the ranks that exist, on the CPU: the trainer of
the reduced smollm-360m (float32 `RunConfig` through `build(runcfg=)`, B
4, S 16, 4 steps, a checkpoint every 2, pod 1 killed at step 3) on 4
spawned gloo ranks, the (4, 1) ("data", "model") host mesh, against the
same loop on one device from the same weights.

- Every rank reads the same loss and grad_norm at every step, and they
  equal the one-device loop's within MESH_TOL (`test_torch_train_mesh`'s
  1e-5); the mesh starts from the one-device weights bit for bit (equal
  state digests).
- One coordinator (rank 0) commits steps [2, 4]; membership is 0b1101
  on every rank; every rank computed each save's digest.
- The mesh checkpoint holds the one-device checkpoint's keys, shapes and
  dtypes; JAX's `CheckpointStore.restore` reads it, and JAX's
  `tree_digest` of what it read is the manifest's digest and the
  committed tag.
- Restores, bit for bit: the mesh checkpoint onto one device; the mesh
  checkpoint and the one-device checkpoint onto the mesh, each rank's
  shard against its slice of the stored tensor.
- The update: the mesh checkpoint's parameters after the 4 steps lie
  as `test_torch_train` holds float32 parameters (a leaf share of at
  most 1e-3 past 2e-5, none past 4 lr) from the one-device
  checkpoint's, AdamW's m and v within MOMENTS_TOL a leaf
  (||mesh - one device|| / ||one device||).
- Without a process group the store writes what JAX's store writes of
  the same tree, member for member; `tree_digest` refuses a DTensor
  tree (it is local: a caller gathers with `whole_tree` first).
- JAX's own `launch.train.main` on the (4, 1) mesh of 4 forced host
  devices, from the port's weights and with the same float32
  RunConfig: losses and grad_norms within MESH_TOL of the port's mesh
  run, commits [2, 4], and its last checkpoint (read back by JAX's
  store, whose digest it matches) against the port's mesh checkpoint
  as the update above.
- bfloat16 (the trainer's own RunConfig), the first step from those
  weights rounded: the port's mesh against its one device and JAX's
  mesh against its one device within BF16_MESH (`chip_smoke.py` phase
  19's bfloat16 metric limit), and the port's one device against JAX's
  within `test_torch_train`'s bfloat16 limits (loss 2e-3, grad_norm
  3e-2).  The distances print with `-s`.

JAX's run in a subprocess and one `run_ranks` call (the ranks run
`test_torch_local_ranks.train_dist_ranks` and import no JAX) start
first; the one-device loop runs meanwhile, in this process, without a
group, and the ranks wait for its last checkpoint.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import zipfile

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.store import (CheckpointStore, _items, keystr,
                                          tree_digest)
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.launch import steps as TS
from repro_torch.launch import train as T
from repro_torch.launch.local_ranks import run_ranks
from test_torch_local_ranks import (WORLD, _stored, bf16_first_step,
                                    train_dist_ranks, train_dist_runcfg)

MESH_TOL = dict(rtol=1e-5, atol=1e-5)
MOMENTS_TOL = 1e-4
BF16_MESH = 1e-2              # chip_smoke.py's TRAIN_MESH_METRIC["bfloat16"]
BF16_JAX = {"loss": 2e-3, "grad_norm": 3e-2}
LR = RunConfig().learning_rate
ARGV = ["--arch", "smollm-360m", "--steps", "4", "--ckpt-every", "2",
        "--kill-at", "3", "--batch", "4", "--seq", "16", "--seed", "3",
        "--device", "cpu"]
STEPS = (2, 4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX's side, in two subprocesses with 4 forced host devices, each
# given ARGV (less `--device`), the port's initial weights (an npz by key
# path) and a directory: "main" runs `launch.train.main` with the
# float32 RunConfig from those weights, writing its checkpoints to the
# directory; "bf16" runs the first bfloat16 step from those weights
# rounded, on the (4, 1) mesh and on a 1 x 1 mesh of one device, as
# JAX's `build` jits it (no argument shardings), and counts the compiled
# step's collectives by element type.
_JAX_SIDE = r"""
import json, re, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.configs.base import RunConfig
from repro.data.pipeline import DataConfig, TokenPipeline
from repro.launch import steps as S
from repro.launch import train
from repro.launch.mesh import make_host_mesh
from repro.models.common import ParamSpec
from repro.optim import adamw
mode, argv = sys.argv[1], json.loads(sys.argv[2])
weights, ckpt = sys.argv[3], sys.argv[4]
with np.load(weights) as z:
    w = dict(z)
def place(specs):
    return jax.tree_util.tree_map_with_path(lambda p, s: jnp.asarray(
        w[jax.tree_util.keystr(p)], s.dtype), specs,
        is_leaf=lambda x: isinstance(x, ParamSpec))
out = {"devices": len(jax.devices())}
if mode == "main":
    rc = RunConfig(remat=False, num_microbatches=1, param_dtype="float32",
                   activation_dtype="float32")
    out.update(losses=[], grad_norms=[], commits=[])
    build, commit = train.build, train.ConsensusCoordinator.commit_checkpoint
    def jbuild(*a, **k):
        cfg, runcfg, mesh, step, pipe = build(*a, runcfg=rc, **k)
        out["mesh"] = list(mesh.shape.values())
        def rec(state, batch):
            state, m = step(state, batch)
            out["losses"].append(float(m["loss"]))
            out["grad_norms"].append(float(m["grad_norm"]))
            return state, m
        return cfg, runcfg, mesh, rec, pipe
    def jcommit(self, step, digest):
        out["commits"].append((step, digest))
        return commit(self, step, digest)
    train.build, train.init_tree = jbuild, lambda rng, specs: place(specs)
    train.ConsensusCoordinator.commit_checkpoint = jcommit
    assert train.main(argv + ["--ckpt-dir", ckpt]) == 0
else:
    cfg = get_config(argv[argv.index("--arch") + 1]).reduced()
    a = dict(zip(argv[::2], argv[1::2]))
    bf = RunConfig(remat=False, num_microbatches=1)
    batch = TokenPipeline(DataConfig(cfg.vocab_size, int(a["--seq"]),
                                     int(a["--batch"]))).batch_at(0)
    one = jax.make_mesh((1, 1), ("data", "model"),
                        devices=jax.devices()[:1],
                        axis_types=(jax.sharding.AxisType.Auto,) * 2)
    for name, mesh in (("mesh", make_host_mesh()), ("one", one)):
        step, _ = S.make_train_step(cfg, bf, mesh)
        p = place(S.param_specs(cfg, bf))
        st = {"params": p, "opt": adamw.init_opt_state(p)}
        run = jax.jit(step).lower(st, batch).compile()
        _, m = run(st, batch)
        out[name] = [float(m["loss"]), float(m["grad_norm"])]
        ops = {}                 # the compiled step's collectives by dtype
        for line in run.as_text().splitlines():
            op = re.search(r"= (.*?) (all-reduce|reduce-scatter|all-gather|"
                           r"all-to-all)(-start)?\(", line)
            for dt in set(re.findall(r"\b([a-z]+[0-9]+)\[",
                                     op.group(1) if op else "")):
                k = f"{op.group(2)} {dt}"
                ops[k] = ops.get(k, 0) + 1
        out[name + "_collectives"] = ops
print(json.dumps(out))
"""


def _jax_side(mode, weights, ckpt_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           os.environ.get("PYTHONPATH",
                                                          "")]))
    argv = [x for x in ARGV if x not in ("--device", "cpu")]
    return subprocess.Popen([sys.executable, "-c", _JAX_SIDE, mode,
                             json.dumps(argv), weights, ckpt_dir], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _port_runs(one_dir, mesh_dir):
    """The mesh ranks (in a thread) and, meanwhile, the one-device loop
    and its bfloat16 first step: {"ranks" or "error", "one", "one_init",
    "one_bf16"}."""
    got = {}

    def ranks():
        try:
            got["ranks"] = run_ranks(train_dist_ranks, WORLD, ARGV,
                                     mesh_dir, one_dir, timeout=120.0)
        except BaseException as exc:          # re-raised by the fixture
            got["error"] = exc
    th = threading.Thread(target=ranks)
    th.start()
    init_state = T.init_state

    def recorded(*a, **k):
        st = init_state(*a, **k)
        got["one_init"] = tree_digest(TS.state_tree(st))
        return st
    T.init_state = recorded
    threads = torch.get_num_threads()
    torch.set_num_threads(2)        # the ranks and JAX share the cores
    try:
        got["one"] = T.train(T.parse_args(ARGV + ["--ckpt-dir", one_dir]),
                             runcfg=train_dist_runcfg())
        got["one_bf16"] = bf16_first_step(ARGV)
    finally:
        T.init_state = init_state
        torch.set_num_threads(threads)
        th.join()
    return got


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_dist")
    one_dir, mesh_dir = str(root / "one"), str(root / "mesh")
    jax_dir, weights = str(root / "jax"), str(root / "weights.npz")
    assert not torch.distributed.is_initialized()
    cfg = get_config("smollm-360m").reduced()
    st = T.init_state(cfg, train_dist_runcfg(), seed=3, device="cpu")
    np.savez(weights, **{keystr(p): t.numpy() for p, t in
                         _items(TS.state_tree(st)["params"])})
    jax_procs = {m: _jax_side(m, weights, jax_dir) for m in ("main", "bf16")}
    try:
        got, jax_out = _port_runs(one_dir, mesh_dir), {}
        for m, proc in jax_procs.items():
            stdout, stderr = proc.communicate(timeout=240)
            assert proc.returncode == 0, stderr[-4000:]
            jax_out[m] = json.loads(stdout.strip().splitlines()[-1])
    finally:
        for proc in jax_procs.values():
            proc.kill()                   # a no-op once it has exited
    if "error" in got:
        raise got["error"]
    return dict(got, one_dir=one_dir, mesh_dir=mesh_dir, jax_dir=jax_dir,
                jax=jax_out["main"], jax_bf16=jax_out["bf16"])


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _update_near(got, want, what):
    """`got`'s state tree (key -> array) against `want`'s: the
    parameters as `test_torch_train._check_params` holds float32 ones (a
    leaf share of at most 1e-3 past 2e-5, none past 4 lr), AdamW's m and
    v within MOMENTS_TOL a leaf, the step count equal."""
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g, w = np.asarray(got[k], np.float64), np.asarray(w, np.float64)
        d = np.abs(g - w)
        if k.startswith("['params']"):
            assert (d > 2e-5).sum() <= 1e-3 * d.size, (what, k)
            assert d.max() <= 4 * LR, (what, k, d.max())
        elif k.endswith("['step']"):
            assert np.array_equal(g, w), (what, k)
        else:
            rel = np.linalg.norm(d) / max(np.linalg.norm(w), 1e-30)
            assert rel <= MOMENTS_TOL, (what, k, rel)


@pytest.mark.parametrize("check", ["metrics", "records", "layout_and_jax",
                                   "restore_one_device", "restore_mesh",
                                   "update", "jax_mesh", "bf16"])
def test_trainer_on_ranks(runs, check):
    one, ranks = runs["one"], runs["ranks"]
    r0 = ranks[0]
    if check == "metrics":
        assert all(r["init_digest"] == runs["one_init"] for r in ranks)
        assert any("Shard" in p for p in r0["placements"].values())
        for key in ("losses", "grad_norms"):
            assert all(r[key] == r0[key] for r in ranks), key
            assert len(r0[key]) == 4
            np.testing.assert_allclose(r0[key], getattr(one, key),
                                       **MESH_TOL)
    elif check == "records":
        assert [r["coordinators"] for r in ranks] == [1, 0, 0, 0]
        assert [c[0] for c in r0["commits"]] == list(STEPS)
        assert all(r["commits"] == [] for r in ranks[1:])
        assert all(r["membership"] == 0b1101 for r in ranks)
        assert all(r["digest_refused"] for r in ranks)
        assert all(r["digests"] == r0["digests"] for r in ranks)
        assert [(s, d) for s, d, _ in r0["commits"]] == r0["digests"]
        assert [c[0] for c in one.commits] == list(STEPS)
        assert one.membership == 0b1101
    elif check == "layout_and_jax":
        from repro.checkpoint.store import CheckpointStore as JStore
        from repro.checkpoint.store import tree_digest as j_tree_digest
        mesh, ref = (_stored(runs[d], STEPS[-1])
                     for d in ("mesh_dir", "one_dir"))
        assert sorted(mesh) == sorted(ref)
        for k in ref:
            assert (mesh[k].shape, mesh[k].dtype) == (ref[k].shape,
                                                      ref[k].dtype), k
        like = TS.state_tree(one.state)
        jtree, digest = JStore(runs["mesh_dir"]).restore(STEPS[-1], like)
        step, want, _ = r0["commits"][-1]
        assert step == STEPS[-1] and digest == want == j_tree_digest(jtree)
        assert one.coord.last_committed_checkpoint()[1] == \
            int(one.commits[-1][1][:3], 16)
        assert int(want[:3], 16) == int(r0["digests"][-1][1][:3], 16)
        assert r0["init_digest"] != want
    elif check == "restore_one_device":
        # the mesh checkpoint on one device, bit for bit the files
        like = TS.state_tree(one.state)
        got, digest = CheckpointStore(runs["mesh_dir"]).restore(STEPS[-1],
                                                                like)
        files = _stored(runs["mesh_dir"], STEPS[-1])
        for path, t in _leaves(got):
            assert isinstance(t, torch.Tensor) and not hasattr(t,
                                                               "placements")
            assert torch.equal(t, torch.from_numpy(files[keystr(path)]))
        assert tree_digest(got) == digest == r0["commits"][-1][1]
    elif check == "restore_mesh":
        # the mesh and the one-device checkpoints on the mesh, each rank's
        # shard its slice of the stored tensor
        for r in ranks:
            assert r["restore_mesh"] == ([], r0["commits"][-1][1])
            assert r["restore_one"] == ([], one.commits[-1][1])
    elif check == "update":
        for s in STEPS:
            _update_near(_stored(runs["mesh_dir"], s),
                         _stored(runs["one_dir"], s), f"step {s}")
    elif check == "jax_mesh":
        from repro.checkpoint.store import CheckpointStore as JStore
        from repro.checkpoint.store import tree_digest as j_tree_digest
        j = runs["jax"]
        assert j["devices"] == WORLD and j["mesh"] == [WORLD, 1]
        for key in ("losses", "grad_norms"):
            np.testing.assert_allclose(j[key], r0[key], **MESH_TOL)
        assert [c[0] for c in j["commits"]] == list(STEPS)
        like = TS.state_tree(one.state)
        jtree, digest = JStore(runs["jax_dir"]).restore(STEPS[-1], like)
        assert digest == j["commits"][-1][1] == j_tree_digest(jtree)
        _update_near(_stored(runs["mesh_dir"], STEPS[-1]),
                     _stored(runs["jax_dir"], STEPS[-1]), "JAX's mesh")
    else:
        # bfloat16's first step: each package's mesh against its own one
        # device, and the two packages' one-device runs
        j, port = runs["jax_bf16"], (r0["bf16"], runs["one_bf16"])
        assert j["devices"] == WORLD
        assert all(r["bf16"] == r0["bf16"] for r in ranks)
        rel = lambda a, b: [abs(x - y) / abs(y) for x, y in zip(a, b)]
        print(f"bf16 first step (loss, grad_norm): port mesh {port[0]}, "
              f"one device {port[1]}, apart {rel(*port)}; JAX mesh "
              f"{j['mesh']}, one device {j['one']}, apart "
              f"{rel(j['mesh'], j['one'])}; port against JAX, one device "
              f"{rel(port[1], j['one'])}, mesh {rel(port[0], j['mesh'])}; "
              f"JAX's mesh step's collectives {j['mesh_collectives']}")
        assert max(rel(*port)) <= BF16_MESH
        assert max(rel(j["mesh"], j["one"])) <= BF16_MESH
        for i, k in enumerate(("loss", "grad_norm")):
            assert rel(port[1], j["one"])[i] <= BF16_JAX[k], k


def test_store_without_a_group_writes_what_jax_writes(tmp_path):
    """Save the one-device state's tree with no process group: the same
    arrays, member for member of the npz, and the same manifest as JAX's
    store writes of the same tree."""
    from repro.checkpoint.store import CheckpointStore as JStore
    assert not torch.distributed.is_initialized()
    rc = train_dist_runcfg()
    cfg = get_config("smollm-360m").reduced()
    tree = TS.state_tree(T.init_state(cfg, rc, seed=3, device="cpu"))
    got = CheckpointStore(str(tmp_path / "t")).save(7, tree)
    want = JStore(str(tmp_path / "j")).save(7, _np_tree(tree))
    assert got == want
    for name in ("manifest.json", "shard_0.npz"):
        a, b = (os.path.join(tmp_path, w, "step_7", name) for w in "tj")
        if name.endswith(".json"):
            assert open(a, "rb").read() == open(b, "rb").read()
            continue
        with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
            assert za.namelist() == zb.namelist()
            for m in za.namelist():
                assert za.read(m) == zb.read(m), m


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().numpy()
