"""Dry run of every (arch x shape x mesh) cell on the production meshes
(the port of `repro.launch.dryrun`), with nothing allocated.

For each cell it proves that the distribution config holds on the
production mesh before a fleet is rented: the model, its train state or
caches are built as DTensors on a mesh of 256 (16 x 16) or 512
(2 x 16 x 16) ranks, and the cell's step (`launch.steps.make_step`)
runs once as rank 0 of a fake process group of that size under
`FakeTensorMode`, so every tensor has its shape and no memory, and every
collective its operands and no traffic.  A sharding that DTensor cannot
propagate, a collective it cannot make or a data-dependent size fails
here.  The record holds what JAX's does, from the rank's own local ops
(`launch.step_cost.StepCost`): its FLOPs and bytes per device, its
collectives (`launch.comm_stats`), and the memory fields of JAX's
`memory_analysis`: the step's arguments, its outputs, the inputs it
updates in place (`alias`: a train state, the caches), and its
temporaries (the peak of live storage beyond the arguments and new
outputs), with `hbm_total_mb` = args + out + temp - alias measured
against the card's memory (`launch.mesh.HW`).  JAX's `lower_s` and
`compile_s` are `trace_s`: the port compiles nothing.

The port's steps take what JAX's take, bar three things: the model is
an `LM` whose parameters are DTensors; tokens, labels, positions and a
context are tensors every rank holds whole (JAX shards them over the
batch); and the prefill step writes caches at capacity that it is
given, where JAX's returns new ones, so they count among its arguments
and as aliased.  `input_specs` gives JAX's input trees, placements and
per-device bytes; `run_cell` what the port's step takes.

With `device_type="cuda"` (on a machine with a card) the tensors are
fake CUDA tensors and the model kernels take their fake path (checked,
counted, not launched: `kernels.COST_SINKS`); with `"cpu"` they run the
twins on fake CPU tensors, and DTensor's all-to-all is an all-gather
and a chunk (a CPU group has none), so each device type's table is its
own.  The module sets nothing at import; `run_cell` makes the fake
group of the mesh's size and ends it.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--json out.json]
      [--device cpu] [--jobs 8]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import (SHAPES_BY_NAME, ShapeConfig,
                                      shape_applicable)
from repro_torch.launch import comm_stats
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import HW, make_production_mesh
from repro_torch.launch.step_cost import (StepCost, storage_bytes,
                                          storage_key, tensors)
from repro_torch.models import common, lm
from repro_torch.models.common import DTYPES, param_count, tree_items
from repro_torch.sharding import axes as axes_mod

MB = 2 ** 20


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """The process-global default group as rank `rank` of a fake group of
    `world` ranks (collectives take their shapes and move nothing), for
    the block; destroyed after it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def local_shape(shape, spec, mesh):
    """A leaf's shape on one rank under `spec` on `mesh` (every sharded
    dim divides evenly, as `logical_to_spec` ensures): JAX's
    `NamedSharding.shard_shape`."""
    out = []
    for size, entry in zip(shape, spec):
        axes = () if entry is None else \
            entry if isinstance(entry, tuple) else (entry,)
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        out.append(size // n)
    return tuple(out)


def leaves(spec_tree, spec_shardings):
    """("a/b/c" path, ParamSpec, spec) of every leaf, in flatten order."""
    out = []
    for path, p in tree_items(spec_tree):
        spec = spec_shardings
        for k in path:
            spec = spec[k]
        out.append(("/".join(path), p, spec))
    return out


def argument_bytes(args, shardings, mesh) -> int:
    """The per-device bytes of `input_specs`' argument trees."""
    return sum(int(np.prod(local_shape(p.shape, spec, mesh)))
               * p.dtype.itemsize
               for tree, sh in zip(args, shardings)
               for _, p, spec in leaves(tree, sh))


def _specs(cfg, shape: ShapeConfig, mesh, runcfg):
    rules = axes_mod.resolve_rules(cfg, runcfg.sharding_profile)
    log = axes_mod.PruneLog()

    def shardings(spec_tree):
        return axes_mod.tree_shardings(spec_tree, rules, mesh, prune_log=log)

    bspecs = S.batch_specs(cfg, shape)
    if shape.kind != "train":
        bspecs.pop("labels", None)
    batch_sh = shardings(bspecs)
    if shape.kind == "train":
        st_specs = S.train_state_specs(cfg, runcfg)
        args = (st_specs, bspecs)
        shs = (shardings(st_specs), batch_sh)
        donate = (0,)
    elif shape.kind == "prefill":
        p_specs = S.param_specs(cfg, runcfg)
        args = (p_specs, bspecs)
        shs = (shardings(p_specs), batch_sh)
        donate = ()
    else:  # decode
        p_specs = S.param_specs(cfg, runcfg)
        d_specs = S.decode_state_specs(cfg, shape, runcfg)
        tok = S.batch_specs(cfg, shape)["tokens"]._replace(
            shape=(shape.global_batch, 1))
        tok_sh = axes_mod.tree_shardings({"t": tok}, rules, mesh,
                                         prune_log=log)["t"]
        args = (p_specs, d_specs, tok)
        shs = (shardings(p_specs), shardings(d_specs), tok_sh)
        donate = (1,)
    return shape.kind, args, shs, donate, runcfg, rules, log


def input_specs(arch: str, shape_name: str, *, mesh=None, runcfg=None):
    """The cell's inputs as JAX's dry run takes them: (step kind, the
    argument trees of `ParamSpec`s, their specs from
    `sharding.axes.tree_shardings` (one entry per dim: a mesh axis, a
    tuple of them or None), the donated argument indices, runcfg, rules,
    the `PruneLog` of dims that fell back to replication).  `mesh`
    defaults to the single-pod production mesh, which needs a group of
    256 ranks; any object with a JAX-style `shape` will do."""
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    runcfg = runcfg or S.default_runcfg(cfg, shape)
    mesh = mesh if mesh is not None else make_production_mesh()
    return _specs(cfg, shape, mesh, runcfg)


@contextlib.contextmanager
def _fake_mode():
    """`FakeTensorMode`, with the module caches that keep a tensor made
    on first use (the rope frequencies) emptied for the block and put
    back after it: no real tensor of an earlier run enters the dry run
    through them, and no fake one outlives it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    freqs = dict(common._FREQS)
    common._FREQS.clear()
    try:
        with FakeTensorMode():
            yield
    finally:
        common._FREQS.clear()
        common._FREQS.update(freqs)


def step_inputs(cfg, runcfg, kind: str, shape: ShapeConfig, mesh, device,
                cache_cap: Optional[int] = None):
    """The port's step arguments for a cell, made on `device` (under
    `FakeTensorMode` in a dry run): the model (`lm.empty_lm`) placed on
    `mesh`, with AdamW moments for a train step, or caches at
    `cache_cap` (default: the shape's length) for a prefill or decode
    step; tokens, labels, positions and the context whole."""
    B, L = shape.global_batch, shape.seq_len
    act = DTYPES[runcfg.activation_dtype]
    rules = axes_mod.resolve_rules(cfg, runcfg.sharding_profile)
    model = lm.empty_lm(cfg, runcfg, device, trainable=kind == "train",
                        mesh=mesh)
    batch = {"tokens": torch.empty((B, L), dtype=torch.int32, device=device)}
    if kind == "train":
        batch["labels"] = torch.empty((B, L), dtype=torch.int32,
                                      device=device)
    for name, p in S.batch_specs(cfg, shape, act_dtype=act).items():
        if name not in ("tokens", "labels"):
            batch[name] = torch.empty(p.shape, dtype=p.dtype, device=device)
    if kind == "train":
        state = S.init_train_state(model, DTYPES[runcfg.opt_state_dtype])
        return state, batch
    caches = lm.alloc_caches(cfg, B, cache_cap or L, act, device,
                             mesh=mesh, rules=rules)
    if kind == "prefill":
        return model, batch, caches
    st = {"pos": torch.empty((B,), dtype=torch.int32, device=device),
          "layers": caches}
    tok = torch.empty((B, 1), dtype=torch.int32, device=device)
    return model, st, tok


def measure_step(step, args) -> Dict[str, Any]:
    """Run `step(*args)` once under `StepCost` and return its accounting:
    flops, bytes, collectives, kernel calls, and the memory fields in
    bytes (arguments, outputs, aliased arguments, temporaries)."""
    arg_ts = list(tensors(args))
    with StepCost() as cost:
        n_args = cost.track(arg_ts)
        out = step(*args)
    arg_keys = {storage_key(t) for t in arg_ts}
    out_ts = list(tensors(out))
    out_b = storage_bytes(out_ts)
    alias_b = storage_bytes([t for t in out_ts
                             if storage_key(t) in arg_keys])
    temp = max(cost.peak - n_args - (out_b - alias_b), 0)
    return {"flops": cost.flops, "nbytes": cost.nbytes,
            "collectives": comm_stats.collective_stats(cost.records),
            "kernel_calls": dict(cost.kernel_calls),
            "argument": n_args, "output": out_b, "alias": alias_b,
            "temp": temp, "peak": cost.peak}


def trace_step(cfg, runcfg, kind: str, shape: ShapeConfig, mesh,
               device_type: str, cache_cap: Optional[int] = None):
    """Build the cell's inputs on `mesh` and run its step once under
    `FakeTensorMode` -> (`measure_step`'s accounting, seconds)."""
    step = S.make_step(cfg, runcfg, kind, mesh)
    t0 = time.time()
    with _fake_mode():
        args = step_inputs(cfg, runcfg, kind, shape, mesh,
                           torch.device(device_type), cache_cap)
        acc = measure_step(step, args)
    return acc, time.time() - t0


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             device_type: str = "cuda", runcfg_overrides=None,
             verbose: bool = True, layers: Optional[int] = None):
    """One cell's record, or SKIP with `shape_applicable`'s reason.
    `layers` cuts the depth traced (a whole number of layer periods; the
    record's `layers` says what ran), for a quick check.  The record's
    `launched` counts the kernel launches the cell made: none, in a dry
    run."""
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "SKIP",
                "reason": why}
    if layers is not None:
        cfg = cfg.with_layers(layers)
    runcfg = S.default_runcfg(cfg, shape, **(runcfg_overrides or {}))
    before = kernels.launch_counts()
    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=device_type)
        kind, args, shs, donate, runcfg, rules, log = _specs(
            cfg, shape, mesh, runcfg)
        acc, trace_s = trace_step(cfg, runcfg, kind, shape, mesh,
                                  device_type)
    rec = record(arch, shape_name, kind, mesh, cfg, runcfg, acc, trace_s,
                 device_type, log)
    rec["launched"] = sum(n - before[op]
                          for op, n in kernels.launch_counts().items())
    if verbose:
        print_record(rec, multi_pod)
    return rec


def record(arch, shape_name, kind, mesh, cfg, runcfg, acc, trace_s,
           device_type, log) -> Dict[str, Any]:
    """JAX's record of a cell from `measure_step`'s accounting."""
    colls = acc["collectives"]
    hbm = acc["argument"] + acc["output"] + acc["temp"] - acc["alias"]
    return {
        "arch": arch, "shape": shape_name, "kind": kind,
        "mesh": dict(mesh.shape), "status": "OK",
        "device_type": device_type, "layers": cfg.num_layers,
        "params": param_count(S.param_specs(cfg, runcfg)),
        "trace_s": round(trace_s, 1),
        "flops_per_dev": float(acc["flops"]),
        "bytes_per_dev": float(acc["nbytes"]),
        "collective_bytes_per_dev": int(
            sum(v["wire_bytes"] for v in colls.values())),
        "collectives": {k: {"count": int(v["count"]),
                            "result_mb": round(v["result_bytes"] / 1e6, 2),
                            "wire_mb": round(v["wire_bytes"] / 1e6, 2)}
                        for k, v in colls.items()},
        "memory": {
            "argument_mb": round(acc["argument"] / MB, 1),
            "output_mb": round(acc["output"] / MB, 1),
            "temp_mb": round(acc["temp"] / MB, 1),
            "alias_mb": round(acc["alias"] / MB, 1),
        },
        "memory_bytes": {k: int(acc[k]) for k in
                         ("argument", "output", "temp", "alias")},
        "hbm_total_mb": round(hbm / MB, 1),
        "fits": hbm <= HW["hbm_bytes"],
        "kernel_calls": acc["kernel_calls"],
        "sharding_fallbacks": log.entries,
    }


def print_record(rec, multi_pod: bool) -> None:
    m = rec["memory"]
    print(f"[{rec['arch']} x {rec['shape']} x {_mesh_name(multi_pod)}] OK "
          f"trace={rec['trace_s']:.1f}s ({rec['device_type']}, "
          f"{rec['layers']} layers)")
    print(f"  memory: args={m['argument_mb']}MB out={m['output_mb']}MB "
          f"temp={m['temp_mb']}MB alias={m['alias_mb']}MB "
          f"-> {rec['hbm_total_mb']}MB/dev "
          f"({'fits' if rec['fits'] else 'OVER'} "
          f"{HW['hbm_bytes'] / 2 ** 30:.0f}GB)")
    print(f"  cost: flops/dev={rec['flops_per_dev']:.3e} "
          f"bytes/dev={rec['bytes_per_dev']:.3e} "
          f"kernel calls={rec['kernel_calls']}")
    print(comm_stats.render_stats({
        k: {"count": v["count"], "result_bytes": v["result_mb"] * 1e6,
            "wire_bytes": v["wire_mb"] * 1e6}
        for k, v in rec["collectives"].items()}))


def _run_one(arch: str, shape: str, multi_pod: bool, device_type: str):
    """One cell of `main`, never raising: its record, and the traceback
    of a FAIL (a failure here is a sharding bug)."""
    try:
        return run_cell(arch, shape, multi_pod=multi_pod,
                        device_type=device_type, verbose=False), None
    except Exception as e:
        return ({"arch": arch, "shape": shape,
                 "mesh": _mesh_name(multi_pod), "status": "FAIL",
                 "error": f"{type(e).__name__}: {e}"},
                traceback.format_exc())


def run_cells(cells, device_type: str, jobs: int):
    """Each (arch, shape, multi_pod) cell in one of `jobs` worker
    processes (each its own fake group), the deepest first; yields
    (arch, shape, multi_pod, record, traceback of a FAIL or None) as
    they finish."""
    import concurrent.futures as cf
    import multiprocessing as mp
    order = sorted(cells, key=lambda c: (
        SHAPES_BY_NAME[c[1]].kind == "train", get_config(c[0]).num_layers),
        reverse=True)
    with cf.ProcessPoolExecutor(jobs, mp_context=mp.get_context("spawn"),
                                max_tasks_per_child=1) as ex:
        futs = {ex.submit(_run_one, *c, device_type): c for c in order}
        for f in cf.as_completed(futs):
            yield futs[f] + f.result()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=sorted(SHAPES_BY_NAME))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the fake tensors' device: cuda (the kernels' "
                         "fake path; needs a card's torch) or cpu (the "
                         "twins)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="trace the cells in this many worker processes "
                         "(records print as cells finish)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else (args.arch,)
    shapes = sorted(SHAPES_BY_NAME) if (args.all or not args.shape) \
        else (args.shape,)
    meshes = (False, True) if (args.both_meshes or args.all) \
        else (args.multi_pod,)
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]
    if args.jobs > 1:
        done = run_cells(cells, args.device, args.jobs)
    else:
        done = (c + _run_one(*c, args.device) for c in cells)
    records = []
    failed = 0
    for arch, shape, mp, rec, tb in done:
        if tb is not None:
            print(tb, file=sys.stderr)
            failed += 1
        elif rec["status"] == "OK":
            print_record(rec, mp)
        records.append(rec)
        sys.stdout.flush()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1, default=str)
    print(f"\n{sum(r['status'] == 'OK' for r in records)} OK, "
          f"{sum(r['status'] == 'SKIP' for r in records)} SKIP, "
          f"{failed} FAIL / {len(records)} cells")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
