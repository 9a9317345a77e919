"""Fault-tolerant training loop (the port of `repro.launch.train`).

End-to-end loop: deterministic data pipeline -> train step (autograd +
AdamW in place) -> async sharded checkpointing -> CKPT_COMMIT through
the BW-Raft control log -> straggler detection & elastic DP re-sharding
-> restart from the last *committed* checkpoint (never trusting local
disk alone).  Runs on the card unless `--device cpu`.

Usage:
  python -m repro_torch.launch.train --arch llama3.2-1b --steps 100 \
      [--reduced | --full] [--batch 8 --seq 64] [--kill-at 40] [--resume] \
      [--device cpu]

The loop is JAX `launch/train.py`'s, odd corners included: every pod reports
the same heartbeat, so the straggler detector never fires; and
`--resume` reads the last CKPT_COMMIT from a coordinator this process has
just built, whose fresh cluster holds no record, so a new process always
starts at step 0, as the JAX loop does.  `main` returns a
`TrainReport` (per-step losses, commits, the membership record, and the
run's coordinator, mesh, store and final state for a caller to
inspect).

On the ranks that exist: every rank of the default process group runs
`main` (or `train`, which takes the parsed arguments and a config the
caller has cut); the caller starts the group (`launch.local_ranks`
spawns ranks on one host; a fleet's launcher starts one process a
card), never `main`.  The step runs on the (W, 1) ("data", "model")
host mesh, each rank on `cuda:{local rank % cards}`; the weights are
drawn from `--seed` on one device and each rank keeps its shard
(`launch.steps.shard_state`), so the mesh run starts from the
one-device run's weights bit for bit.  Rank 0 alone holds the
coordinator, commits the CKPT_COMMIT and MEMBERSHIP records and prints;
what the other ranks need of the records (the committed step on a
restore, the membership) is broadcast from it.  Every rank takes part
in each save (the store gathers the shards) and rank 0 writes it, in
the one-device layout.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.coord.coordinator import ConsensusCoordinator
from repro_torch.coord.stragglers import StragglerMitigator
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm


def build(arch: str, *, reduced: bool, batch: int, seq: int,
          runcfg: Optional[RunConfig] = None,
          cfg: Optional[ModelConfig] = None, device_type: str = "cuda"):
    """(cfg, runcfg, mesh, train_step, pipeline) for `arch` (or `cfg`, a
    config the caller has cut): the step on `launch.mesh.make_host_mesh()`
    over the ranks of the default process group, ("data", "model") =
    (W, 1) for W ranks, 1 x 1 (the one-device step) without a group or
    with a group of one, as JAX's `build` makes its mesh over the devices
    that exist."""
    if cfg is None:
        cfg = get_config(arch)
        if reduced:
            cfg = cfg.reduced()
    runcfg = runcfg or RunConfig(remat=False, num_microbatches=1)
    mesh = make_host_mesh(device_type=device_type)
    train_step = S.make_train_step(cfg, runcfg, mesh)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=seq, global_batch=batch))
    return cfg, runcfg, mesh, train_step, pipe


def extras_for(cfg, batch, seq):
    ex = {}
    if cfg.family == "vlm":
        ex["img_embeds"] = np.zeros(
            (batch, cfg.num_image_tokens, cfg.d_model), np.float32)
    if cfg.family == "audio_encdec":
        ex["frames"] = np.zeros((batch, seq, cfg.d_model), np.float32)
    return ex


def init_state(cfg, runcfg, *, seed: int, device) -> Dict:
    """Random weights from `seed` (trainable) and zero AdamW moments, on
    one device (`launch.steps.shard_state` places them on a mesh)."""
    model = lm.init_lm(cfg, runcfg, seed=seed, device=device,
                       trainable=True)
    return S.init_train_state(model)


def rank_device(device=None):
    """The device of this process: `device` when given; else the card,
    on a process group `cuda:{local rank % cards}` (raises without a
    card: a rank never falls back to the CPU)."""
    if device is not None:
        return torch.device(device)
    dev = resolve_device(None)
    if not dist.is_initialized():
        return dev
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _from_rank0(obj):
    """`obj` as rank 0 holds it, on every rank of the default group."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


@dataclasses.dataclass
class TrainReport:
    start_step: int
    losses: List[float]                  # per step, from start_step
    grad_norms: List[float]
    step_ms: List[float]                 # host clock, each step synced
    commits: List[Tuple[int, str, int]]  # (step, digest, revision), rank 0
    save_ms: List[float]                 # save() + wait() per checkpoint
    commit_ticks: List[int]              # ticks per CKPT_COMMIT
    commit_ms: List[float]
    membership: int                      # the committed MEMBERSHIP record
    digests: List[Tuple[int, str]] = dataclasses.field(
        default_factory=list)            # (step, digest) a save, each rank
    coord: Any = dataclasses.field(repr=False, default=None)   # rank 0
    mesh: Any = dataclasses.field(repr=False, default=None)
    store: Any = dataclasses.field(repr=False, default=None)
    state: Any = dataclasses.field(repr=False, default=None)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--kill-at", type=int, default=-1,
                    help="simulate coordinator-pod failure at this step")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pods", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> TrainReport:
    return train(parse_args(argv))


def train(args: argparse.Namespace, cfg: Optional[ModelConfig] = None,
          runcfg: Optional[RunConfig] = None) -> TrainReport:
    """The loop of `main` on parsed arguments, with `cfg` and `runcfg`
    (when given) in place of the `--arch` config and the default run
    config.  Every rank of the default process group calls it; the
    caller starts the group (none: one device).  Only rank 0 holds the
    coordinator, commits the records and prints; every rank takes part
    in each save."""
    device = rank_device(args.device)
    if device.type == "cuda" and dist.is_initialized():
        torch.cuda.set_device(device)
    rank = _rank()
    say = print if rank == 0 else (lambda *a, **k: None)

    cfg, runcfg, mesh, train_step, pipe = build(
        args.arch, reduced=args.reduced, batch=args.batch, seq=args.seq,
        runcfg=runcfg, cfg=cfg, device_type=device.type)
    store = CheckpointStore(args.ckpt_dir)
    coord = None
    if rank == 0:
        from repro_torch.configs.bwraft_kv import CONFIG as CLUSTER
        coord = ConsensusCoordinator(CLUSTER, seed=args.seed, device=device)
        coord.wait_for_leader()
    straggler = StragglerMitigator(args.pods)

    state = init_state(cfg, runcfg, seed=args.seed, device=device)
    if lm.on_mesh(mesh):
        state = S.shard_state(state, cfg, runcfg, mesh)
    start_step = 0

    if args.resume:
        committed = _from_rank0(
            coord.last_committed_checkpoint() if coord else None)
        if committed:
            step_c, tag = committed
            tree, digest = store.restore(step_c, S.state_tree(state))
            assert int(digest[:3], 16) == tag, \
                "restored checkpoint digest does not match committed record"
            S.load_state_tree(state, tree)
            start_step = step_c
            say(f"[restore] resumed from committed step {step_c} "
                f"(digest tag {tag:03x})")

    rep = TrainReport(start_step, [], [], [], [], [], [], [], 0,
                      coord=coord, mesh=mesh, store=store, state=state)

    def save(step, blocking):
        t0 = time.perf_counter()
        digest = store.save(step, S.state_tree(state), blocking=blocking)
        store.wait()
        rep.save_ms.append((time.perf_counter() - t0) * 1e3)
        rep.digests.append((step, digest))
        if coord is None:
            return digest, None
        t0, ticks0 = time.perf_counter(), coord.ticks
        c = coord.commit_checkpoint(step, digest)
        rep.commit_ms.append((time.perf_counter() - t0) * 1e3)
        rep.commit_ticks.append(coord.ticks - ticks0)
        rep.commits.append((step, digest, c.revision))
        return digest, c

    ex = extras_for(cfg, args.batch, args.seq)
    t_last = time.time()
    for step in range(start_step, args.steps):
        # elastic DP: derive shard layout from the committed membership view
        shards = max(len(straggler.active_pods), 1)
        batch = pipe.batch_at(step, shard=0, num_shards=1, extras=ex,
                              device=device)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])          # waits for the step
        rep.step_ms.append((time.perf_counter() - t0) * 1e3)
        rep.losses.append(loss)
        rep.grad_norms.append(float(metrics["grad_norm"]))

        dt = time.time() - t_last
        t_last = time.time()
        # per-pod heartbeats (pod 0 is us; others simulated at same speed)
        hb = {p: dt for p in straggler.active_pods}
        if args.kill_at >= 0 and step == args.kill_at:
            say(f"[failure] pod 1 dies at step {step}")
            straggler.mark_failed(1)
            if coord is not None:
                coord.commit_membership(straggler.membership_bitmap())
        straggler.heartbeat(hb)

        if step % 10 == 0:
            say(f"step {step:5d} loss={loss:.4f} "
                f"gnorm={rep.grad_norms[-1]:.3f} pods={shards} "
                f"({dt*1e3:.0f} ms)")
        if step > 0 and step % args.ckpt_every == 0:
            digest, c = save(step, blocking=False)
            if c is not None:
                say(f"[ckpt] step {step} digest={digest} committed "
                    f"rev={c.revision}")
    # final checkpoint
    save(args.steps, blocking=True)
    rep.membership = _from_rank0(coord.membership() if coord else None)
    final = f"{rep.losses[-1]:.4f}" if rep.losses else "n/a"
    say(f"[done] {args.steps} steps; final loss {final}; checkpoint "
        f"committed")
    return rep


if __name__ == "__main__":
    main()
