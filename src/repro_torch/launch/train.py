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
run's coordinator, store and final state for a caller to inspect).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.coord.coordinator import ConsensusCoordinator
from repro_torch.coord.stragglers import StragglerMitigator
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import steps as S
from repro_torch.models import lm


def build(arch: str, *, reduced: bool, batch: int, seq: int,
          runcfg: Optional[RunConfig] = None):
    """(cfg, runcfg, train_step, pipeline) for `arch`."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    runcfg = runcfg or RunConfig(remat=False, num_microbatches=1)
    train_step = S.make_train_step(cfg, runcfg)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=seq, global_batch=batch))
    return cfg, runcfg, train_step, pipe


def extras_for(cfg, batch, seq):
    ex = {}
    if cfg.family == "vlm":
        ex["img_embeds"] = np.zeros(
            (batch, cfg.num_image_tokens, cfg.d_model), np.float32)
    if cfg.family == "audio_encdec":
        ex["frames"] = np.zeros((batch, seq, cfg.d_model), np.float32)
    return ex


def init_state(cfg, runcfg, *, seed: int, device) -> Dict:
    """Random weights from `seed` (trainable) and zero AdamW moments."""
    model = lm.init_lm(cfg, runcfg, seed=seed, device=device,
                       trainable=True)
    return S.init_train_state(model)


@dataclasses.dataclass
class TrainReport:
    start_step: int
    losses: List[float]                  # per step, from start_step
    grad_norms: List[float]
    step_ms: List[float]                 # host clock, each step synced
    commits: List[Tuple[int, str, int]]  # (step, digest, revision)
    save_ms: List[float]                 # save() + wait() per checkpoint
    commit_ticks: List[int]              # ticks per CKPT_COMMIT
    commit_ms: List[float]
    membership: int                      # the committed MEMBERSHIP record
    coord: Any = dataclasses.field(repr=False, default=None)
    store: Any = dataclasses.field(repr=False, default=None)
    state: Any = dataclasses.field(repr=False, default=None)


def main(argv=None) -> TrainReport:
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
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg, runcfg, train_step, pipe = build(
        args.arch, reduced=args.reduced, batch=args.batch, seq=args.seq)
    store = CheckpointStore(args.ckpt_dir)
    from repro_torch.configs.bwraft_kv import CONFIG as CLUSTER
    coord = ConsensusCoordinator(CLUSTER, seed=args.seed, device=device)
    coord.wait_for_leader()
    straggler = StragglerMitigator(args.pods)

    state = init_state(cfg, runcfg, seed=args.seed, device=device)
    start_step = 0

    if args.resume:
        committed = coord.last_committed_checkpoint()
        if committed:
            step_c, tag = committed
            tree, digest = store.restore(step_c, S.state_tree(state))
            assert int(digest[:3], 16) == tag, \
                "restored checkpoint digest does not match committed record"
            S.load_state_tree(state, tree)
            start_step = step_c
            print(f"[restore] resumed from committed step {step_c} "
                  f"(digest tag {tag:03x})")

    rep = TrainReport(start_step, [], [], [], [], [], [], [], 0,
                      coord=coord, store=store, state=state)

    def commit(step, digest):
        t0, ticks0 = time.perf_counter(), coord.ticks
        c = coord.commit_checkpoint(step, digest)
        rep.commit_ms.append((time.perf_counter() - t0) * 1e3)
        rep.commit_ticks.append(coord.ticks - ticks0)
        rep.commits.append((step, digest, c.revision))
        return c

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
            print(f"[failure] pod 1 dies at step {step}")
            straggler.mark_failed(1)
            coord.commit_membership(straggler.membership_bitmap())
        straggler.heartbeat(hb)

        if step % 10 == 0:
            print(f"step {step:5d} loss={loss:.4f} "
                  f"gnorm={rep.grad_norms[-1]:.3f} pods={shards} "
                  f"({dt*1e3:.0f} ms)")
        if step > 0 and step % args.ckpt_every == 0:
            t0 = time.perf_counter()
            digest = store.save(step, S.state_tree(state), blocking=False)
            store.wait()
            rep.save_ms.append((time.perf_counter() - t0) * 1e3)
            c = commit(step, digest)
            print(f"[ckpt] step {step} digest={digest} committed "
                  f"rev={c.revision}")
    # final checkpoint
    t0 = time.perf_counter()
    digest = store.save(args.steps, S.state_tree(state))
    rep.save_ms.append((time.perf_counter() - t0) * 1e3)
    commit(args.steps, digest)
    rep.membership = coord.membership()
    final = f"{rep.losses[-1]:.4f}" if rep.losses else "n/a"
    print(f"[done] {args.steps} steps; final loss {final}; checkpoint "
          f"committed")
    return rep


if __name__ == "__main__":
    main()
