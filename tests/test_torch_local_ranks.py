"""`launch.local_ranks.run_ranks`, the spawner of the port's distributed
checks: a rank that raises, or one that hangs past the time limit,
fails the run and every rank is stopped.

This module imports torch and the port only, so the ranks that
`tests/test_torch_moe_ep.py`, `tests/test_torch_lm_mesh.py`,
`tests/test_torch_train_mesh.py` and `tests/test_torch_train_dist.py`
spawn import it, and not JAX: their side of the expert-parallel MoE
checks (`moe_ep_ranks`), of the LM forward on DTensors
(`lm_mesh_ranks`), of the train step on DTensors (`train_mesh_ranks`)
and of `launch/train.py` on the ranks (`train_dist_ranks`) lives here.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.comm_stats import CollectiveRecorder
from repro_torch.launch.local_ranks import run_ranks
from repro_torch.models import moe as tmoe

WORLD = 4
GRAD_LOSS_AUX = 0.01


def local_x(x, form, ep, r):
    """Rank r's tokens: a2a shards the sequence, psum replicates."""
    if form == "psum":
        return x
    s = x.shape[1] // ep
    return x[:, r * s:(r + 1) * s]


def _cfg(arch, cf):
    return dataclasses.replace(get_config(arch).reduced(),
                               moe_capacity_factor=cf)


def _np(t):
    return t.detach().cpu().numpy()


def _run_cases(rank, weights, tokens, cases, groups):
    """Each (arch, ep, form, cf) case's body on this rank's share:
    (out, aux, integer routing) as numpy, and the collectives it made."""
    out = {}
    for case in cases:
        arch, ep, form, cf = case
        w = {k: torch.from_numpy(v) for k, v in weights[arch].items()}
        r = rank % ep
        E_loc = w["wg"].shape[0] // ep
        sl = slice(r * E_loc, (r + 1) * E_loc)
        x = torch.from_numpy(local_x(tokens[arch, form], form, ep, r))
        body = tmoe._moe_local_a2a if form == "a2a" else tmoe._moe_local_psum
        with CollectiveRecorder() as rec:
            y, aux, route = body(x, w["router"], w["wg"][sl], w["wu"][sl],
                                 w["wd"][sl], cfg=_cfg(arch, cf), ep=ep,
                                 group=groups[ep])
        out[case] = (_np(y), _np(aux), {k: _np(v) for k, v in
                                        route.items()}, rec.records)
    return out


def _run_apply(weights, tokens, forms=("a2a", "psum")):
    """moe_apply on DTensors: the forward on a 1 x 4 and a 2 x 2
    ("data", "model") mesh, both forms, at 8.0, and the gradients of
    sum(y * c) + 0.01 aux."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.axes import (TRAIN_RULES, logical_to_spec,
                                           placements)
    out = {}
    arch = "qwen2-moe-a2.7b"
    cfg = _cfg(arch, 8.0)
    specs = tmoe.moe_params(cfg, torch.float32)
    for shape in ((1, 4), (2, 2)):
        mesh = make_host_mesh(model=shape[1], device_type="cpu")
        assert tuple(mesh.shape.values()) == shape
        dm = mesh.device_mesh
        rep = [Replicate(), Replicate()]
        for form in forms:
            x = tokens[arch, form]
            c = np.cos(np.arange(x.size, dtype=np.float32)).reshape(x.shape)
            p = {k: distribute_tensor(
                    torch.from_numpy(v), dm,
                    placements(logical_to_spec(specs[k].axes, v.shape,
                                               TRAIN_RULES, mesh), mesh)
                 ).requires_grad_() for k, v in weights[arch].items()}
            dx = distribute_tensor(torch.from_numpy(x), dm,
                                   rep).requires_grad_()
            y, aux = tmoe.moe_apply(p, dx, cfg, mesh)
            loss = (y * distribute_tensor(torch.from_numpy(c), dm,
                                          rep)).sum() + GRAD_LOSS_AUX * aux
            loss.backward()
            grads = {k: _np(v.grad.full_tensor()) for k, v in p.items()
                     if v.grad is not None}
            grads["x"] = _np(dx.grad.full_tensor())
            out[shape, form] = (_np(y.full_tensor()),
                                _np(aux.full_tensor()), grads)
    return out


def moe_ep_ranks(rank, world, weights, tokens, cases):
    """A rank of `tests/test_torch_moe_ep.py`: the bodies in a group of
    4 and in two groups of 2, then `moe_apply` on DTensors."""
    import torch.distributed as dist
    torch.set_num_threads(1)          # four ranks share the host's cores
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    groups = {4: dist.group.WORLD, 2: pairs[rank // 2]}
    return (_run_cases(rank, weights, tokens, cases, groups),
            _run_apply(weights, tokens))


# --------------------------------------------------------------------- #
# the LM forward on DTensors (tests/test_torch_lm_mesh.py)
# --------------------------------------------------------------------- #
MESH_CAPACITY = 8.0                # MoE capacity at which nothing drops


def mesh_cfg(arch):
    """The reduced config of the mesh checks: an expert-parallel MoE layer
    drops nothing at MESH_CAPACITY, so it computes the dense form's
    function."""
    return dataclasses.replace(get_config(arch).reduced(),
                               moe_capacity_factor=MESH_CAPACITY)


def mesh_runcfg(profile):
    from repro_torch.configs.base import RunConfig
    return RunConfig(sharding_profile=profile, remat=False,
                     param_dtype="float32", activation_dtype="float32")


def _gather(t):
    return _np(t.full_tensor() if hasattr(t, "full_tensor") else t)


def _mesh_serve(case, weights, feed, mesh, taps=None):
    """One case's prefill and decode steps on the mesh: the steps' greedy
    tokens, every forward's logits, the kernels' operand shapes and the
    merge's collectives (`launch.taps.Taps`), every cache leaf gathered
    with its placements, and with `taps` (the one-device run's layer
    inputs) each layer fed its input and its output gathered."""
    from repro_torch.launch import steps as TS
    from repro_torch.launch.taps import Taps, serve
    from repro_torch.models import lm as tlm
    from repro_torch.models.common import tree_items
    from repro_torch.sharding.axes import resolve_rules
    arch, profile, B, S, cap = case
    cfg, rc = mesh_cfg(arch), mesh_runcfg(profile)
    model = tlm.from_numpy(weights, cfg, rc, "cpu", mesh=mesh)
    layers = tlm.alloc_caches(cfg, B, cap, torch.float32, "cpu", mesh=mesh,
                              rules=resolve_rules(cfg, profile))
    fed = [torch.from_numpy(t) for t in feed["fed"]]
    seen = Taps(mesh, feed=None if taps is None else
                [torch.from_numpy(t) for t in taps],
                on_layer=None if taps is None else
                lambda i, h, y: _gather(y))
    with seen:
        toks, caches, _, _ = serve(
            model, layers, torch.from_numpy(feed["tokens"]),
            TS.make_prefill_step(cfg, rc, mesh),
            TS.make_decode_step(cfg, rc, mesh), len(fed), fed)
    leaves = {"/".join(p): (_gather(a), str(a.placements))
              for p, a in tree_items(caches["layers"])}
    return {"tokens": [_np(t) for t in toks],
            "logits": [_gather(g) for g in seen.logits], "caches": leaves,
            "flash": seen.flash, "decode": seen.decode, "ssd": seen.ssd,
            "merge": seen.merge, "layers": seen.layers,
            "pos": _np(caches["pos"])}


def one_device_serve(case, weights, feed, tap=False):
    """The port's steps on one device, as `_mesh_serve` runs them on a
    mesh: every forward's logits, each step's greedy tokens, the caches,
    and with `tap` each layer call's input ("taps") and output."""
    from repro_torch.launch import steps as TS
    from repro_torch.launch.taps import Taps, serve
    from repro_torch.models import lm as tlm
    from repro_torch.models.common import tree_items
    arch, profile, B, S, cap = case
    cfg, rc = mesh_cfg(arch), mesh_runcfg(profile)
    model = tlm.from_numpy(weights, cfg, rc, "cpu")
    layers = tlm.alloc_caches(cfg, B, cap, torch.float32, "cpu")
    fed = [torch.from_numpy(t) for t in feed["fed"]]
    seen = Taps(on_layer=(lambda i, h, y: (_np(h), _np(y))) if tap else None)
    with seen:
        toks, caches, _, _ = serve(
            model, layers, torch.from_numpy(feed["tokens"]),
            TS.make_prefill_step(cfg, rc), TS.make_decode_step(cfg, rc),
            len(fed), fed)
    return {"tokens": [_np(t) for t in toks],
            "logits": [_np(g) for g in seen.logits],
            "caches": {"/".join(p): _np(a)
                       for p, a in tree_items(caches["layers"])},
            "taps": [h for h, _ in seen.layers] if tap else None,
            "layers": [y for _, y in seen.layers]}


def lm_mesh_ranks(rank, world, meshes, cases, weights, feeds, taps):
    """A rank of `tests/test_torch_lm_mesh.py`: every case on each
    ("data", "model") = (world / m, m) host mesh of `meshes` {name: m},
    and for the cases named in `taps` once more with each layer fed the
    input of the one-device run (`one_device_serve`).  Rank 0 returns
    the results by mesh (every rank computes them: the gathers are
    collectives)."""
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)          # four ranks share the host's cores
    out, taps_in = {}, {}
    for name, m in meshes.items():
        mesh = make_host_mesh(model=m, device_type="cpu")
        res = out[name] = {}
        for key, case in cases.items():
            res[key] = _mesh_serve(case, weights[case[0]], feeds[key], mesh)
            if key in taps:
                if key not in taps_in:
                    taps_in[key] = one_device_serve(
                        case, weights[case[0]], feeds[key], tap=True)["taps"]
                res[key, "taps"] = _mesh_serve(case, weights[case[0]],
                                               feeds[key], mesh,
                                               taps_in[key])
    return out if rank == 0 else None


# --------------------------------------------------------------------- #
# run_ranks itself
# --------------------------------------------------------------------- #
def _fail_or_hang(rank, world, how):
    import torch.distributed as dist
    x = torch.full((2,), float(rank))
    dist.all_reduce(x)                    # every rank joined the group
    if rank == 1 and how == "raise":
        raise ValueError("rank 1 refuses")
    if rank == 1 and how == "hang":
        time.sleep(600)
    return x.tolist()


@pytest.mark.parametrize("how", ["raise", "hang"])
def test_a_failed_rank_fails_the_run(how):
    t0 = time.monotonic()
    want = "rank 1 raised" if how == "raise" else "did not finish within"
    with pytest.raises(RuntimeError, match=want) as err:
        run_ranks(_fail_or_hang, 2, how,
                  timeout=60.0 if how == "raise" else 12.0)
    if how == "raise":
        assert "ValueError: rank 1 refuses" in str(err.value)
    else:                         # rank 1 is among those left running
        assert "1] did not finish" in str(err.value)
    assert time.monotonic() - t0 < 50


# --------------------------------------------------------------------- #
# the train step on DTensors (tests/test_torch_train_mesh.py)
# --------------------------------------------------------------------- #
def train_mesh_cfg(arch):
    """The reduced config of the train-step checks (at least 2 layers,
    a whole period), at MESH_CAPACITY."""
    cfg = mesh_cfg(arch)
    return cfg.with_layers(max(2, cfg.layer_period))


def train_mesh_runcfg(run):
    from repro_torch.configs.base import RunConfig
    return RunConfig(param_dtype="float32", activation_dtype="float32",
                     **dict(run))


def _full(t):
    return _np(t.full_tensor() if hasattr(t, "full_tensor") else t)


def _train_run(case, weights, batches, mesh=None, shape=(1, 4), feed=None,
               record=False):
    """One case's train steps from numpy `weights` on `batches`, on the
    mesh or (None) on one device with the aux of the `shape` mesh
    (`launch.taps.mesh_aux`), under `launch.taps.TrainTaps` (fed `feed`
    on the mesh): each step's loss, aux and grad_norm, the first step's
    gradients and the parameters, m and v after the last step (whole),
    the collectives by site, and with `record` the layer taps."""
    import contextlib

    from repro_torch.launch import steps as TS
    from repro_torch.launch.taps import TrainTaps, mesh_aux
    from repro_torch.models import lm as tlm
    arch, run, _ = case
    cfg, rc = train_mesh_cfg(arch), train_mesh_runcfg(run)
    model = tlm.from_numpy(weights, cfg, rc, "cpu", trainable=True,
                           mesh=mesh)
    state = TS.init_train_state(model)
    step = TS.make_train_step(cfg, rc, mesh)
    taps = TrainTaps(mesh, feed)
    aux = contextlib.nullcontext() if mesh else mesh_aux(*shape)
    with aux, taps:
        mets = [step(state, {k: torch.from_numpy(v) for k, v in b.items()})[1]
                for b in batches]
    opt = state["opt"]
    out = {"metrics": [{k: float(v) for k, v in m.items()} for m in mets],
           "grads": {n: _full(g) for n, g in taps.updates[0].items()},
           "params": {n: _full(p.detach())
                      for n, p in model.named_parameters()},
           "m": {n: _full(t) for n, t in opt["m"].items()},
           "v": {n: _full(t) for n, t in opt["v"].items()},
           "collectives": taps.collectives,
           "passes": taps.passes}
    if mesh is not None:
        out["placements"] = {n: str(p.placements)
                             for n, p in model.named_parameters()}
    if record:
        out["feed"] = (taps.inputs, taps.grads)
    return out


def _serve_context(case_serve, weights, context, tokens, fed, mesh=None,
                   feed=None):
    """A prefill with its context and decode steps of a cross-layer model
    (`launch.taps.serve`): each forward's logits, the greedy tokens, the
    caches (whole, with their placements on a mesh), the kernels' operand
    shapes.  The one-device run records its layers' inputs ("feed"),
    the mesh run is fed them (`launch.taps.TrainTaps`: random weights
    are chaotic here too, the encoder's as the decoder's)."""
    from repro_torch.launch import steps as TS
    from repro_torch.launch.taps import Taps, TrainTaps, serve
    from repro_torch.models import lm as tlm
    from repro_torch.models.common import tree_items
    from repro_torch.sharding.axes import resolve_rules
    arch, profile, B, S, cap = case_serve
    cfg, rc = train_mesh_cfg(arch), mesh_runcfg(profile)
    model = tlm.from_numpy(weights, cfg, rc, "cpu", mesh=mesh)
    layers = tlm.alloc_caches(cfg, B, cap, torch.float32, "cpu", mesh=mesh,
                              rules=resolve_rules(cfg, profile))
    ctx = {k: torch.from_numpy(v) for k, v in context.items()}
    with Taps(mesh) as seen, TrainTaps(mesh, feed) as taps:
        toks, caches, _, _ = serve(
            model, layers, torch.from_numpy(tokens),
            TS.make_prefill_step(cfg, rc, mesh),
            TS.make_decode_step(cfg, rc, mesh), len(fed),
            [torch.from_numpy(t) for t in fed], context=ctx)
    return {"tokens": [_np(t) for t in toks],
            "logits": [_full(g) for g in seen.logits],
            "caches": {"/".join(p): (_full(a), str(getattr(a, "placements",
                                                            "")))
                       for p, a in tree_items(caches["layers"])},
            "flash": seen.flash, "decode": seen.decode,
            "feed": (taps.inputs, {}) if feed is None else None}


def train_mesh_ranks(rank, world, meshes, cases, weights, batches, serves):
    """A rank of `tests/test_torch_train_mesh.py`: each case {key: (arch,
    run options, chaotic)} on each ("data", "model") host mesh of
    `meshes` {name: (data, model, keys)} against the one-device run of
    this rank with that mesh's aux; a chaotic case's mesh run is fed the
    one-device run's layer taps.  Then each serve case {arch: (serve
    case, context, tokens, fed)} on each mesh against one device.
    Rank 0 returns the results (every rank computes them: the gathers
    are collectives), the others their grad_norms by (mesh, key)."""
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)          # four ranks share the host's cores
    out = {}
    for name, (data, model_n, keys) in meshes.items():
        mesh = make_host_mesh(model=model_n, device_type="cpu")
        for key in keys:
            t0 = time.perf_counter()
            case = cases[key]
            w, b = weights[case[0]], batches[key]
            ref = _train_run(case, w, b, shape=(data, model_n),
                             record=case[2])
            out[name, key] = (ref, _train_run(
                case, w, b, mesh, feed=ref.pop("feed", None)))
            ref["seconds"] = time.perf_counter() - t0
        for arch, (sc, ctx, tokens, fed) in serves.items():
            ref = _serve_context(sc, weights[arch], ctx, tokens, fed)
            out[name, arch, "serve"] = (ref, _serve_context(
                sc, weights[arch], ctx, tokens, fed, mesh, ref.pop("feed")))
    if rank == 0:
        return out
    return {k: tuple(m["grad_norm"] for m in v[1]["metrics"])
            for k, v in out.items() if len(k) == 2}


# --------------------------------------------------------------------- #
# launch/train.py on the ranks that exist (tests/test_torch_train_dist.py)
# --------------------------------------------------------------------- #
def train_dist_runcfg():
    from repro_torch.configs.base import RunConfig
    return RunConfig(remat=False, num_microbatches=1, param_dtype="float32",
                     activation_dtype="float32")


def bf16_first_step(argv, mesh=None):
    """The trainer's first step in its own RunConfig (bfloat16 weights)
    from the float32 weights of `argv`'s `--seed` rounded to bfloat16,
    on `mesh` (placed as the trainer places them) or on one device:
    (loss, grad_norm)."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import steps as TS
    from repro_torch.launch import train as T
    from repro_torch.models import lm
    a = T.parse_args(argv)
    cfg = get_config(a.arch).reduced()
    rc = RunConfig(remat=False, num_microbatches=1)
    st = T.init_state(cfg, rc, seed=a.seed, device="cpu")
    f32 = dict(T.init_state(cfg, train_dist_runcfg(), seed=a.seed,
                            device="cpu")["params"].named_parameters())
    with torch.no_grad():
        for n, p in st["params"].named_parameters():
            p.copy_(f32[n])                # rounded to bfloat16 leaves
    if lm.on_mesh(mesh):
        st = TS.shard_state(st, cfg, rc, mesh)
    batch = TokenPipeline(DataConfig(cfg.vocab_size, a.seq, a.batch)
                          ).batch_at(0, device="cpu")
    _, m = TS.make_train_step(cfg, rc, mesh)(st, batch)
    return float(m["loss"]), float(m["grad_norm"])


def _stored(ckpt_dir, step):
    """{keystr: array} of a checkpoint's files, read with numpy."""
    import json
    import os
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        shards = json.load(f)["shards"]
    out = {}
    for i in range(shards):
        with np.load(os.path.join(d, f"shard_{i}.npz")) as z:
            out.update({k: z[k] for k in z.files})
    return out


def restored_shards_equal(store, ckpt_dir, step, like):
    """Restore checkpoint `step` of `store` onto the placements of the
    DTensor tree `like`: the keys whose restored shard on this rank is
    not bit-equal to its slice of the stored tensor (or is not placed as
    `like`), and the digest."""
    from repro_torch.checkpoint.store import _items, keystr
    from repro_torch.sharding.axes import local_part
    got, digest = store.restore(step, like)
    want = _stored(ckpt_dir, step)
    bad = []
    for (path, g), (_, w) in zip(_items(got), _items(like)):
        whole = torch.from_numpy(want[keystr(path)])
        if not hasattr(w, "placements"):        # AdamW's step count
            ok = torch.equal(g, whole)
        else:
            part = local_part(whole, w.placements, w.device_mesh)
            ok = g.placements == w.placements and tuple(g.shape) == \
                tuple(whole.shape) and torch.equal(g.to_local(), part)
        if not ok:
            bad.append(keystr(path))
    return bad, digest


def train_dist_ranks(rank, world, argv, ckpt_dir, one_dir):
    """A rank of `tests/test_torch_train_dist.py`: `launch.train.train`
    of `argv` on the (world, 1) host mesh, writing to `ckpt_dir`, with
    the initial state's digest taken where the loop places it; then the
    last mesh checkpoint and the one-device run's (in `one_dir`)
    restored onto the mesh (once the one-device run has written it),
    each rank's shards against the files;
    whether `tree_digest` refuses the DTensor state; and the first step
    in bfloat16 on the mesh (`bf16_first_step`)."""
    import os

    from repro_torch.checkpoint.store import tree_digest, whole_tree
    from repro_torch.launch import steps as TS
    from repro_torch.launch import train as T
    torch.set_num_threads(1)          # four ranks share the host's cores
    shard_state, seen = TS.shard_state, {}

    def placed(*a, **k):
        st = shard_state(*a, **k)
        seen["init_digest"] = tree_digest(whole_tree(TS.state_tree(st)))
        seen["placements"] = {n: str(p.placements)
                              for n, p in st["params"].named_parameters()}
        return st
    TS.shard_state = placed
    try:
        rep = T.train(T.parse_args(argv + ["--ckpt-dir", ckpt_dir]),
                      runcfg=train_dist_runcfg())
    finally:
        TS.shard_state = shard_state
    like = TS.state_tree(rep.state)
    last = rep.digests[-1][0]
    mesh_bad, mesh_digest = restored_shards_equal(rep.store, ckpt_dir, last,
                                                  like)
    manifest = os.path.join(one_dir, f"step_{last}", "manifest.json")
    t_end = time.monotonic() + 120.0
    while not os.path.exists(manifest):      # the store writes it last
        assert time.monotonic() < t_end, f"no checkpoint {manifest}"
        time.sleep(0.1)
    one_bad, one_digest = restored_shards_equal(
        T.CheckpointStore(one_dir), one_dir, last, like)
    try:
        tree_digest(like)
        seen["digest_refused"] = False
    except TypeError:
        seen["digest_refused"] = True
    seen["bf16"] = bf16_first_step(argv, rep.mesh)
    return {"losses": rep.losses, "grad_norms": rep.grad_norms,
            "digests": rep.digests, "membership": rep.membership,
            "commits": rep.commits, "coordinators": int(rep.coord is not None),
            "restore_mesh": (mesh_bad, mesh_digest),
            "restore_one": (one_bad, one_digest), **seen}
