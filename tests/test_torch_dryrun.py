"""The dry run (`repro_torch.launch.dryrun`, ROADMAP.md §1 item 10e part
2b) against JAX's (`repro.launch.dryrun`), and its accounting
(`launch/step_cost.py`) against real steps.

* `input_specs` over all 80 cells (10 archs x 4 shapes x the 16 x 16 and
  2 x 16 x 16 meshes): the step kind, every leaf's path, global shape
  and dtype, rank 0's local shape against JAX's `shard_shape`, the
  per-device argument bytes, the parameter count, the `PruneLog` in
  order, and the SKIP cells with their reasons.  JAX runs in one
  subprocess (its dry run sets `XLA_FLAGS` for 512 host devices at
  import), the port in another, over fake groups of 256 and 512 ranks
  (the group is process-global): `port_side` below.
* The accounting counts a rank's local work: a DTensor product over a
  fake group of 256 counts the rank's 2·1·2048·512 FLOPs, not the
  global 2·16·2048·8192 that `FlopCounterMode` counts.
* A fake run predicts a real one: a reduced llama and a reduced
  qwen2-moe prefill on a 1 x 4 mesh, traced over a fake group of 4,
  against the same step on 4 gloo CPU ranks (`launch.local_ranks`):
  collective tables, FLOPs, argument and output bytes equal.  The ranks
  import this module, which imports no JAX.
* The model kernels' fake path on fake CUDA tensors (no mesh): outputs
  of the twin's shapes and dtypes, no launch counted, `flops` equal to
  the closed forms, and the card path's errors.
* The CLI, and three cells traced at full width, each cut to one layer
  period (their records say so).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES_BY_NAME, ShapeConfig

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
MESHES = ("16x16", "2x16x16")
CELLS = [(a, s, m) for a in ARCH_IDS for s in sorted(SHAPES_BY_NAME)
         for m in MESHES]
#: cells traced at full width, each cut to one layer period
TRACED = (("llama3.2-1b", "train_4k", False),
          ("qwen2-moe-a2.7b", "decode_32k", True),
          ("mamba2-130m", "long_500k", False))
#: the prefill cells a fake run and a real run both take (reduced)
PREDICT = ("llama3.2-1b", "qwen2-moe-a2.7b")
PREDICT_SHAPE = ShapeConfig("predict", 32, 4, "prefill")
WORLD = 4

_JAX_SIDE = r"""
import json
from repro.launch import dryrun as D      # sets XLA_FLAGS before jax
import jax
import numpy as np
from repro.configs import ARCH_IDS, get_config
from repro.configs.base import SHAPES_BY_NAME, shape_applicable
from repro.launch import steps as S
from repro.launch.mesh import make_production_mesh
from repro.models.common import param_count

out = {}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    for arch in ARCH_IDS:
        for shape in sorted(SHAPES_BY_NAME):
            key = "|".join((arch, shape, "2x16x16" if mp else "16x16"))
            if not shape_applicable(get_config(arch),
                                    SHAPES_BY_NAME[shape])[0]:
                out[key] = {"skip": D.run_cell(arch, shape,
                                               multi_pod=mp)["reason"]}
                continue
            kind, args, shs, donate, runcfg, rules, log = D.input_specs(
                arch, shape, mesh=mesh)
            leaves, nbytes = [], 0
            for i, (a, sh) in enumerate(zip(args, shs)):
                flat, _ = jax.tree_util.tree_flatten_with_path(a)
                for (path, leaf), s in zip(flat,
                                           jax.tree_util.tree_leaves(sh)):
                    local = s.shard_shape(leaf.shape)
                    nbytes += int(np.prod(local)) * leaf.dtype.itemsize
                    leaves.append([f"{i}:" + "/".join(str(k.key)
                                                      for k in path),
                                   list(leaf.shape), str(leaf.dtype),
                                   list(local)])
            out[key] = {"kind": kind, "leaves": leaves, "arg_bytes": nbytes,
                        "params": param_count(S.param_specs(
                            get_config(arch), runcfg)),
                        "fallbacks": log.entries, "donate": list(donate)}
print(json.dumps(out, default=list))
"""


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), str(ROOT / "tests"), os.environ.get("PYTHONPATH", "")]))


# ---------------------------------------------------------------------------
# The port's side, run in a subprocess (`python -c "...; port_side()"`)
# ---------------------------------------------------------------------------

def _specs_of_cells(mesh, name):
    from repro_torch.configs.base import shape_applicable
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import steps as S
    from repro_torch.models.common import param_count
    from repro_torch.sharding import axes
    out = {}
    for arch in ARCH_IDS:
        for shape in sorted(SHAPES_BY_NAME):
            key = "|".join((arch, shape, name))
            if not shape_applicable(get_config(arch),
                                    SHAPES_BY_NAME[shape])[0]:
                out[key] = {"skip": D.run_cell(arch, shape)["reason"]}
                continue
            kind, args, shs, donate, runcfg, rules, log = D.input_specs(
                arch, shape, mesh=mesh)
            leaves = []
            for i, (tree, sh) in enumerate(zip(args, shs)):
                for path, p, spec in D.leaves(tree, sh):
                    rank0 = axes.local_part(
                        torch.empty(p.shape, device="meta"),
                        axes.placements(spec, mesh), mesh).shape
                    leaves.append([f"{i}:{path}", list(p.shape),
                                   str(p.dtype).replace("torch.", ""),
                                   list(D.local_shape(p.shape, spec, mesh)),
                                   list(rank0)])
            out[key] = {"kind": kind, "leaves": leaves,
                        "arg_bytes": D.argument_bytes(args, shs, mesh),
                        "params": param_count(S.param_specs(
                            get_config(arch), runcfg)),
                        "fallbacks": log.entries, "donate": list(donate)}
    return out


def _product_flops():
    """x (16, 2048) [Shard(0), Replicate()] @ w (2048, 8192) [Shard(0),
    Shard(1)] on 16 x 16, under `StepCost` and `FlopCounterMode`."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.step_cost import StepCost
    from repro_torch.sharding.axes import from_local
    mesh = make_production_mesh(device_type="cpu")
    with FakeTensorMode():
        x = from_local(torch.empty(1, 2048), [Shard(0), Replicate()], mesh,
                       (16, 2048))
        w = from_local(torch.empty(128, 512), [Shard(0), Shard(1)], mesh,
                       (2048, 8192))
        with StepCost() as cost:
            x @ w
        with FlopCounterMode(display=False) as fc:
            x @ w
    return cost.flops, fc.get_total_flops()


#: leaves a port step takes whole on every rank (JAX shards them)
WHOLE = ("tokens", "labels", "img_embeds", "frames", "pos", "")


def _expected_args(arch, shape_name, multi_pod):
    """The port's argument bytes a rank for a cell cut to one layer
    period: every leaf of `input_specs` at its local shape, bar the
    tokens, labels, context and positions, which a rank holds whole."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import Mesh
    cfg = get_config(arch)
    cfg = cfg.with_layers(cfg.layer_period)
    shape = SHAPES_BY_NAME[shape_name]
    mesh = Mesh({"pod": 2, "data": 16, "model": 16} if multi_pod
                else {"data": 16, "model": 16})
    _, args, shs, *_ = D._specs(cfg, shape, mesh,
                                S.default_runcfg(cfg, shape))
    return sum(int(np.prod(p.shape if path in WHOLE else
                           D.local_shape(p.shape, spec, mesh)))
               * p.dtype.itemsize
               for tree, sh in zip(args, shs)
               for path, p, spec in D.leaves(tree, sh))


def _predict_case(arch):
    cfg = get_config(arch).reduced()
    if cfg.moe_num_experts:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    from repro_torch.launch import steps as S
    return cfg, S.default_runcfg(cfg, PREDICT_SHAPE,
                                 param_dtype="float32",
                                 activation_dtype="float32")


def _summary(acc):
    return {"collectives": acc["collectives"], "flops": acc["flops"],
            "argument": acc["argument"], "output": acc["output"],
            "alias": acc["alias"]}


def _predict_fake():
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_host_mesh
    out = {}
    with D.fake_group(WORLD):
        mesh = make_host_mesh(model=WORLD, device_type="cpu")
        for arch in PREDICT:
            cfg, runcfg = _predict_case(arch)
            acc, _ = D.trace_step(cfg, runcfg, "prefill", PREDICT_SHAPE,
                                  mesh, "cpu")
            out[arch] = _summary(acc)
    return out


def predict_rank(rank, world):
    """A rank of the real run: the same prefill steps on real CPU
    tensors (uninitialised: the counts do not read them)."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(model=world, device_type="cpu")
    out = {}
    for arch in PREDICT:
        cfg, runcfg = _predict_case(arch)
        args = D.step_inputs(cfg, runcfg, "prefill", PREDICT_SHAPE, mesh,
                             torch.device("cpu"))
        out[arch] = _summary(D.measure_step(
            S.make_step(cfg, runcfg, "prefill", mesh), args))
    return out


def port_side():
    """Everything that needs a process-global fake group, as JSON."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh
    out = {"specs": {}}
    for name, world in (("16x16", 256), ("2x16x16", 512)):
        with D.fake_group(world):
            mesh = make_production_mesh(multi_pod=world == 512,
                                        device_type="cpu")
            out["specs"].update(_specs_of_cells(mesh, name))
            if world == 256:
                out["product"] = _product_flops()
    out["traced"] = [
        dict(D.run_cell(a, s, multi_pod=mp, device_type="cpu",
                        verbose=False, layers=get_config(a).layer_period),
             expected_args=_expected_args(a, s, mp))
        for a, s, mp in TRACED]
    out["predict"] = _predict_fake()
    print(json.dumps(out, default=list))


# ---------------------------------------------------------------------------
# Fixtures: both subprocesses, the CLI and the real ranks at once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.local_ranks import run_ranks
    out_json = tmp_path_factory.mktemp("dryrun") / "out.json"
    procs = {
        "jax": [sys.executable, "-c", _JAX_SIDE],
        "port": [sys.executable, "-c",
                 "import test_torch_dryrun as t; t.port_side()"],
        "cli": [sys.executable, "-m", "repro_torch.launch.dryrun",
                "--arch", "smollm-360m", "--shape", "decode_32k",
                "--device", "cpu", "--json", str(out_json)],
    }
    started = {k: subprocess.Popen(v, env=_env(), stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
               for k, v in procs.items()}
    real = {}
    th = threading.Thread(target=lambda: real.setdefault(
        "ranks", run_ranks(predict_rank, WORLD, timeout=240)))
    th.start()
    done = {}
    for k, p in started.items():
        stdout, stderr = p.communicate(timeout=420)
        done[k] = (p.returncode, stdout, stderr)
    th.join(timeout=300)
    for k in ("jax", "port"):
        assert done[k][0] == 0, done[k][2][-4000:]
    return {"jax": json.loads(done["jax"][1].strip().splitlines()[-1]),
            "port": json.loads(done["port"][1].strip().splitlines()[-1]),
            "cli": done["cli"],
            "cli_json": json.loads(out_json.read_text())
            if out_json.exists() else None,
            "ranks": real.get("ranks")}


# ---------------------------------------------------------------------------
# input_specs against JAX, cell by cell
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape,mesh", CELLS,
                         ids=["|".join(c) for c in CELLS])
def test_input_specs_equal_jax(runs, arch, shape, mesh):
    key = "|".join((arch, shape, mesh))
    j, t = runs["jax"][key], runs["port"]["specs"][key]
    if "skip" in j:
        assert t == j
        assert "long_500k skipped" in t["skip"]
        return
    assert t["kind"] == j["kind"]
    assert t["donate"] == j["donate"]
    assert [lf[:3] for lf in t["leaves"]] == [lf[:3] for lf in j["leaves"]]
    # the local shape by the spec, and rank 0's shard as DTensor holds it
    assert [lf[3] for lf in t["leaves"]] == [lf[3] for lf in j["leaves"]]
    assert [lf[4] for lf in t["leaves"]] == [lf[3] for lf in j["leaves"]]
    assert t["arg_bytes"] == j["arg_bytes"]
    assert t["params"] == j["params"]
    assert t["fallbacks"] == j["fallbacks"]


def test_all_cells_covered(runs):
    skips = [k for k, v in runs["jax"].items() if "skip" in v]
    assert len(runs["jax"]) == len(runs["port"]["specs"]) == 80
    assert len(skips) == 16


# ---------------------------------------------------------------------------
# The accounting
# ---------------------------------------------------------------------------

def test_flops_are_per_device(runs):
    local, dtensor = runs["port"]["product"]
    assert local == 2 * 1 * 2048 * 512 == 2_097_152
    assert dtensor == 2 * 16 * 2048 * 8192 == 536_870_912


@pytest.mark.parametrize("arch", PREDICT)
def test_fake_run_predicts_real_cpu_run(runs, arch):
    fake = runs["port"]["predict"][arch]
    ranks = runs["ranks"]
    assert ranks is not None, "the gloo ranks did not finish"
    real = json.loads(json.dumps(ranks[0][arch]))
    assert real["collectives"] == fake["collectives"]
    assert real["collectives"]["all-reduce"]["count"] > 0
    assert real["flops"] == fake["flops"] > 0
    assert real["argument"] == fake["argument"] > 0
    assert real["output"] == fake["output"] > 0
    assert real["alias"] == fake["alias"] > 0
    # every rank of the symmetric 1 x 4 mesh does the same work
    assert all(r[arch]["flops"] == ranks[0][arch]["flops"] for r in ranks)


@pytest.mark.parametrize("cell", TRACED, ids=[c[0] for c in TRACED])
def test_traced_cell(runs, cell):
    arch, shape, mp = cell
    rec = next(r for r in runs["port"]["traced"] if r["arch"] == arch)
    cfg = get_config(arch)
    assert rec["status"] == "OK" and rec["shape"] == shape
    assert rec["layers"] == cfg.layer_period < cfg.num_layers
    assert rec["mesh"] == ({"pod": 2, "data": 16, "model": 16} if mp
                           else {"data": 16, "model": 16})
    jax_keys = {"arch", "shape", "kind", "mesh", "status", "params",
                "flops_per_dev", "bytes_per_dev",
                "collective_bytes_per_dev", "collectives", "memory",
                "hbm_total_mb", "sharding_fallbacks"}
    assert jax_keys <= set(rec) and "trace_s" in rec
    assert set(rec["memory"]) == {"argument_mb", "output_mb", "temp_mb",
                                  "alias_mb"}
    m = rec["memory_bytes"]
    # each rank holds its shards and nothing more (no shard a view that
    # keeps a whole tensor's storage alive)
    assert m["argument"] == rec["expected_args"]
    assert rec["hbm_total_mb"] == round(
        (m["argument"] + m["output"] + m["temp"] - m["alias"]) / 2 ** 20, 1)
    assert m["alias"] > 0 and rec["fits"]
    assert rec["flops_per_dev"] > 0 and rec["collectives"]
    assert rec["kernel_calls"] == {}       # the CPU twins, not the kernels


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_cli(runs):
    rc, stdout, stderr = runs["cli"]
    assert rc == 0, stderr[-4000:]
    assert stdout.strip().splitlines()[-1] == "1 OK, 0 SKIP, 0 FAIL / 1 cells"
    (rec,) = runs["cli_json"]
    assert (rec["arch"], rec["shape"], rec["status"]) == \
        ("smollm-360m", "decode_32k", "OK")
    assert rec["layers"] == get_config("smollm-360m").num_layers


def test_skip_cell_carries_jax_reason(runs):
    from repro_torch.launch import dryrun as D
    rec = D.run_cell("llama3.2-1b", "long_500k", verbose=False)
    assert rec == {"arch": "llama3.2-1b", "shape": "long_500k",
                   "status": "SKIP",
                   "reason": runs["jax"]["llama3.2-1b|long_500k|16x16"][
                       "skip"]}


def test_module_sets_nothing_at_import():
    env = _env()
    env.pop("XLA_FLAGS", None)
    code = ("import os, sys, torch.distributed as dist; "
            "import repro_torch.launch.dryrun; "
            "print(os.environ.get('XLA_FLAGS'), dist.is_initialized(), "
            "any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.split() == ["None", "False", "False"]


# ---------------------------------------------------------------------------
# The kernels' fake path, on fake CUDA tensors
# ---------------------------------------------------------------------------

class _Sink:
    def __init__(self):
        self.calls = []

    def add_cost(self, op, flops, nbytes):
        self.calls.append((op, flops, nbytes))


def _fake_calls(fn, *shapes_dtypes, **kw):
    """fn on fake CUDA tensors of `shapes_dtypes` -> (outputs' (shape,
    dtype, device), the sink's calls, launch counts before and after)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import kernels as tk
    before = tk.launch_counts()
    sink = _Sink()
    tk.COST_SINKS.append(sink)
    try:
        with FakeTensorMode():
            args = [torch.empty(s, dtype=d, device="cuda")
                    for s, d in shapes_dtypes]
            out = fn(*args, **kw)
    finally:
        tk.COST_SINKS.remove(sink)
    outs = out if isinstance(out, tuple) else (out,)
    return ([(tuple(o.shape), o.dtype, o.device.type) for o in outs],
            sink.calls, before, tk.launch_counts())


def _twin(fn, *shapes_dtypes, **kw):
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(s, generator=g).to(d) if d.is_floating_point
            else torch.full(s, s[0] if len(s) else 1, dtype=d)
            for s, d in shapes_dtypes]
    out = fn(*args, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(o.shape), o.dtype, "cuda") for o in outs]


def _pairs(S, T):
    return int(np.tril(np.ones((S, T), bool), T - S).sum())


@pytest.mark.parametrize("S,T,dtype", [(64, 64, torch.bfloat16),
                                       (17, 40, torch.float32),
                                       (40, 17, torch.bfloat16)])
def test_flash_fake_path(S, T, dtype):
    from repro_torch.kernels.flash_attention import ops
    sd = [((2, S, 8, 64), dtype), ((2, T, 2, 64), dtype),
          ((2, T, 2, 64), dtype)]
    outs, calls, before, after = _fake_calls(ops.flash_attention, *sd)
    assert outs == _twin(ops.flash_attention, *sd)
    assert before == after
    assert ops.causal_pairs(S, T) == _pairs(S, T)
    flops = 4 * 2 * 8 * 64 * _pairs(S, T)
    assert calls == [("flash_attention", flops,
                      sum(int(np.prod(s)) * d.itemsize for s, d in sd)
                      + 2 * S * 8 * 64 * dtype.itemsize)]
    assert ops.flops((2, S, 8, 64), T, causal=False) == 4 * 2 * 8 * 64 * S * T


@pytest.mark.parametrize("with_lse", [False, True])
def test_decode_fake_path(with_lse):
    from repro_torch.kernels.decode_attention import ops
    sd = [((3, 1, 8, 128), torch.bfloat16), ((3, 50, 2, 128), torch.bfloat16),
          ((3, 50, 2, 128), torch.bfloat16), ((3,), torch.int32)]
    outs, calls, before, after = _fake_calls(ops.decode_attention, *sd,
                                             with_lse=with_lse)
    assert outs == _twin(ops.decode_attention, *sd, with_lse=with_lse)
    assert before == after
    assert [c[:2] for c in calls] == [("decode_attention",
                                       4 * 3 * 8 * 128 * 50)]


def test_ssd_fake_path():
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.ssd_scan import ops
    B, nc, Q, H, P, N = 2, 3, 64, 4, 64, 128
    sd = [((B, nc, Q, H, P), torch.bfloat16), ((B, nc, Q, N), torch.bfloat16),
          ((B, nc, Q, N), torch.bfloat16), ((B, nc, Q, H), torch.float32),
          ((H,), torch.float32)]
    outs, calls, before, after = _fake_calls(ops.ssd_scan, *sd)
    assert outs == _twin(ops.ssd_scan, *sd)
    assert before == after
    # the closed form counts the twin's products, chunk by chunk
    with FlopCounterMode(display=False) as fc:
        _twin(ops.ssd_scan, *sd)
    assert [c[:2] for c in calls] == [("ssd_scan", fc.get_total_flops())]
    assert ops.flops((B, nc, Q, H, P), N) == \
        2 * B * nc * Q * (Q * N + Q * H * P + 2 * H * P * N)


@pytest.mark.parametrize("case", ["head_dim", "mixed_dtype", "ssd_state"])
def test_fake_path_raises_as_the_card(case):
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    bf, f32 = torch.bfloat16, torch.float32
    if case == "head_dim":
        fn, sd, msg = fops.flash_attention, [((1, 8, 2, 48), bf)] * 3, \
            "head_dim 48 not in"
    elif case == "mixed_dtype":
        fn, msg = dops.decode_attention, "equal for q, k, v"
        sd = [((1, 1, 2, 64), bf), ((1, 8, 2, 64), f32), ((1, 8, 2, 64), f32),
              ((1,), torch.int32)]
    else:
        fn, msg = sops.ssd_scan, "not taken"
        sd = [((1, 1, 8, 2, 64), bf), ((1, 1, 8, 32), bf),
              ((1, 1, 8, 32), bf), ((1, 1, 8, 2), f32), ((2,), f32)]
    with pytest.raises(ValueError, match=msg):
        _fake_calls(fn, *sd)
