"""Ranks of one process group on one host, for the distributed checks
of the port (the expert-parallel MoE on gloo ranks, on the CPU or
sharing one card).

`run_ranks(fn, world, *args)` spawns `world` processes, joins them into
a gloo process group over a `FileStore` in a temporary directory (gloo
takes CPU tensors, and CUDA ones through the host, so ranks sharing one
card can join it, where NCCL refuses two ranks on one GPU), calls
`fn(rank, world, *args)` in each and returns the results by rank.  A
rank that raises, dies or does not finish within `timeout` fails the
run: every rank is stopped and `RuntimeError` raised, naming the rank.
`fn` and its arguments are pickled (spawn), so `fn` must be importable.

`stage_through_host()` makes the functional collectives
(`torch.ops._c10d_functional.*`, what DTensor's redistributions and the
port's explicit collectives call) run on CUDA tensors by copying them to
the host, running gloo's CPU collective and copying the result back:
for ranks sharing one card, where gloo's all-gather of CUDA tensors
kills the rank (PERF.md §6).  The compute stays on the card; only the
collective's operand and result cross.  It is process-wide and used
only in such ranks.
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback


def _rank_main(rank, world, store_path, timeout, fn, args, out):
    import faulthandler
    import torch.distributed as dist
    faulthandler.enable()        # a rank that crashes prints where
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        try:
            res = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise


#: the functional collectives `stage_through_host` stages
STAGED = ("all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor",
          "all_to_all_single", "broadcast")
_LIB: list = []


def stage_through_host() -> tuple:
    """Register, for CUDA tensors, a kernel of each functional collective
    of STAGED that runs it on a host copy of the operand (gloo's CPU
    path, which waits for it) and returns the result on the operand's
    card (once a process).  Returns STAGED."""
    import torch

    if _LIB:
        return STAGED
    _LIB.append(torch.library.Library("_c10d_functional", "IMPL"))
    ops = torch.ops._c10d_functional
    for name in STAGED:
        op = getattr(ops, name).default

        def staged(x, *args, _op=op):
            y = ops.wait_tensor.default(_op(x.cpu(), *args))
            return y.to(x.device)

        _LIB[0].impl(name, staged, "CUDA")
    return STAGED


def run_ranks(fn, world: int, *args, timeout: float = 300.0):
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    results, failed = {}, None
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, os.path.join(d, "store"),
                                   timeout, fn, args, out))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(results) < world and failed is None:
                try:
                    rank, ok, res = out.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in results and not p.is_alive()]
                    if dead:
                        failed = (f"rank {dead[0]} died (exit code "
                                  f"{procs[dead[0]].exitcode})")
                    elif time.monotonic() > deadline:
                        left = sorted(set(range(world)) - set(results))
                        failed = (f"ranks {left} did not finish within "
                                  f"{timeout:.0f} s")
                    continue
                if ok:
                    results[rank] = res
                else:
                    failed = f"rank {rank} raised:\n{res}"
        finally:
            for p in procs:
                if failed is not None and p.is_alive():
                    p.kill()
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failed is not None:
        raise RuntimeError(failed)
    return [results[r] for r in range(world)]
