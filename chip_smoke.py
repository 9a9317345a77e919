#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of BW-Raft on one NVIDIA GPU.

    python3 chip_smoke.py            # the smoke run on one GPU
    python3 chip_smoke.py --profile  # also profiles 10 ticks of the solo
                                     # and of the fleet path (device busy
                                     # share, kernels by name)

Phases, each fatal on failure:

1. print the card's name and power limit, build the CUDA kernels from
   `src/repro_torch/kernels/csrc/` (one nvcc per source, in parallel);
2. each of the six kernels against its plain PyTorch twin on the same
   CUDA inputs, exact equality (floats included): at the solo path's
   shapes (B=1, N=87, L=4096, K=1024, W=256, A=8), at the fleet path's
   (B=5, O=550, S=4, Fi=355 packed group lanes) and on edge cases; then
   device times of kernel, twin and (group_reduce) the nearest PyTorch
   calls, with CUDA events around launches queued behind a sleep
   kernel, median of many;
3. the solo path: `BWRaftSim(CONFIG, seed=0)`, managed, 3 epochs, then
   2 more at phi=0.02, with every launch count set to 0 just before and
   read just after (each per-tick kernel once per tick: 500); then the
   quickstart's client sequence through `BWKVService`;
4. one solo epoch from the same state and draw bundle on the card
   (kernels) and on the CPU (twins): integer and bool results equal,
   float results within rtol=1e-5 (float32 sums reduce in another order
   on the card);
5. the fleet path: one `FleetSim` of B=5 members at CONFIG — BW-Raft,
   Raft, two grouped Multi-Raft shards at chi=0.1, and BW-Raft with the
   550-slot digest-observer rack — for 3 epochs, counts set to 0 just
   before and read just after (each per-tick kernel and ae_sync 300
   launches, once per tick for the whole fleet; group_reduce 3), then a
   sync-free check over 3 batched ticks;
6. the fixed-role sweep: `FleetSim.from_sweep(CONFIG, ...)` at B=32,
   unmanaged, `run(1)`, `lease_fixed(2, 8)`, `run(2)` on the
   multi-epoch path;
7. one fleet epoch, group digest included, on the card and on the CPU
   from the same state and bundles, held as in phase 4;
8. a `kernels` JSON line, the card line, and the last line
   `{"ok": true, "device": {...}}`.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
INT_OPS_PER_S = 67e12              # non-tensor-core 32-bit rate (fp32 peak)
FLOAT_RTOL = 1e-5
REPLACES = {
    "log_match_append": "src/repro/kernels/raft_tick/kernel.py:108",
    "commit_majority": "src/repro/kernels/raft_tick/kernel.py:173",
    "apply_last_wins": "src/repro/kernels/raft_tick/kernel.py:221",
    "leader_fanout": "src/repro/kernels/leader_fanout/kernel.py:124",
    "ae_sync": "src/repro/kernels/ae_sync/kernel.py:107",
    "group_reduce": "src/repro/kernels/group_digest/kernel.py:61",
}
SOURCE = {
    "log_match_append": "src/repro_torch/kernels/csrc/raft_tick.cu",
    "commit_majority": "src/repro_torch/kernels/csrc/raft_tick.cu",
    "apply_last_wins": "src/repro_torch/kernels/csrc/raft_tick.cu",
    "leader_fanout": "src/repro_torch/kernels/csrc/leader_fanout.cu",
    "ae_sync": "src/repro_torch/kernels/csrc/ae_sync.cu",
    "group_reduce": "src/repro_torch/kernels/csrc/group_digest.cu",
}
PER_TICK = ("log_match_append", "commit_majority", "apply_last_wins",
            "leader_fanout")
FLEET_B = 5
SWEEP_B = 32


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------- #
# phase 2: kernels against their twins
# --------------------------------------------------------------------- #
def device_ms(fn, reps: int, sleep_cycles: int) -> float:
    """Median device time of `fn()` in ms: a sleep kernel holds the
    stream while the host enqueues the events and `fn`'s launches, so the
    events bracket device work only, not host overhead."""
    import torch
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def lma_case(rng, B, N, L, W, *, due_frac=0.5, empty=False):
    import numpy as np
    hi = 1 if empty else L + 1
    frm = rng.integers(0, hi, (B, N))
    return dict(
        log_term=rng.integers(0, 4, (B, N, L)),
        log_key=rng.integers(0, 8, (B, N, L)),
        log_val=rng.integers(0, 64, (B, N, L)),
        ldr_term=rng.integers(0, 4, (B, L)),
        ldr_key=rng.integers(0, 8, (B, L)),
        ldr_val=rng.integers(0, 64, (B, L)),
        log_len=rng.integers(0, hi, (B, N)), app_from_len=frm,
        app_upto=np.minimum(frm + rng.integers(-8, W + 40, (B, N)), L),
        due=rng.random((B, N)) < due_frac)


def commit_case(rng, B, N, L, *, dead_frac=0.3, majority=None):
    import numpy as np
    maj = (rng.integers(0, N + 3, B) if majority is None
           else np.full(B, majority))
    return dict(match_len=rng.integers(0, L + 1, (B, N)),
                voter_alive=rng.random((B, N)) >= dead_frac,
                ldr_term=rng.integers(0, 3, (B, L)),
                ldr_cur_term=rng.integers(0, 3, B), majority=maj)


def apply_case(rng, B, N, K, A):
    return dict(kv=rng.integers(-4, 4, (B, N, K)),
                keys=rng.integers(-K - 3, K + 3, (B, N, A)),
                vals=rng.integers(0, 2 ** 20, (B, N, A)),
                valid=rng.random((B, N, A)) < 0.7)


def fanout_case(rng, B, N, L, *, has_leader=True, alive_frac=0.8,
                warn_frac=0.3):
    import numpy as np
    warn = np.where(rng.random((B, N)) < warn_frac,
                    rng.integers(0, 5, (B, N)), -1)
    arrive = np.where(rng.random((B, N)) < 0.6, -1,
                      rng.integers(0, 40, (B, N)))
    return dict(
        role=rng.integers(0, 6, (B, N)),
        alive=rng.random((B, N)) < alive_frac,
        warn_timer=warn, sec_of=rng.integers(-1, N, (B, N)),
        match_len=rng.integers(0, L + 1, (B, N)), app_arrive_t=arrive,
        app_from_len=rng.integers(0, L + 1, (B, N)),
        app_upto=rng.integers(0, L + 1, (B, N)),
        app_term=rng.integers(0, 4, (B, N)),
        app_commit=rng.integers(0, L + 1, (B, N)),
        rtt=rng.integers(1, 20, (B, N, N)), lid_c=rng.integers(0, N, B),
        has_leader=np.full(B, has_leader), tick=rng.integers(0, 100, B),
        ldr_len=rng.integers(0, L + 1, B), ldr_term=rng.integers(0, 4, B),
        ldr_commit=rng.integers(0, L + 1, B))


def ae_case(rng, B, O, N, S, *, voter_frac=0.1, interval=4):
    import numpy as np
    return dict(
        dobs_alive=rng.random((B, O)) < 0.8,
        dobs_fol=rng.integers(-1, N + 2, (B, O)),
        dobs_applied=rng.integers(0, 4097, (B, O)),
        dobs_term=rng.integers(0, 4, (B, O)),
        dobs_digest=rng.integers(-2 ** 31, 2 ** 31, (B, O)),
        dobs_synced_t=rng.integers(-1, 400, (B, O)),
        ae_phase=rng.integers(0, 9, (B, O)),
        dobs_site=rng.integers(0, S, (B, O)),
        alive=rng.random((B, N)) < 0.8,
        is_voter=rng.random((B, N)) < voter_frac,
        applied_len=rng.integers(0, 4097, (B, N)),
        term=rng.integers(0, 4, (B, N)),
        applied_digest=rng.integers(-2 ** 31, 2 ** 31, (B, N)),
        site=rng.integers(0, S, (B, N)),
        site_rtt=rng.integers(1, 20, (B, S, S)),
        tick=rng.integers(0, 500, B), ae_interval=np.full(B, interval))


def group_case(rng, B, G, Fi, Ff, *, dropped=0.0):
    import numpy as np
    gids = np.where(rng.random(B) < dropped, G, rng.integers(0, G, B))
    return dict(gids=gids, int_mat=rng.integers(-50, 2 ** 20, (B, Fi)),
                flt_mat=(rng.standard_normal((B, Ff)) * 1e3
                         ).astype(np.float32))


def to_dev(case, dev):
    import numpy as np
    import torch
    out = {}
    for k, v in case.items():
        a = np.asarray(v)
        if a.dtype not in (bool, np.float32):
            a = a.astype(np.int32)
        out[k] = torch.as_tensor(a, device=dev)
    return out


def clone(case):
    return {k: v.clone() for k, v in case.items()}


def check_equal(name, got, want):
    import torch
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{name}: output {i} differs from the twin")


def kernel_fns():
    """{name: fn(case, twin, kw) -> outputs}: each op, or its twin, on a
    case dict whose values are its operands in order."""
    from repro_torch.kernels.ae_sync import ops as ae
    from repro_torch.kernels.ae_sync import ref as ae_ref
    from repro_torch.kernels.group_digest import ops as gd
    from repro_torch.kernels.group_digest import ref as gd_ref
    from repro_torch.kernels.leader_fanout import ops as lf
    from repro_torch.kernels.leader_fanout import ref as lf_ref
    from repro_torch.kernels.raft_tick import ops as rt
    from repro_torch.kernels.raft_tick import ref as rt_ref

    def pick(op, twin):
        return lambda t: twin if t else op

    lma = pick(rt.log_match_append, rt_ref.log_match_append_ref)
    com = pick(rt.commit_majority, rt_ref.commit_majority_ref)
    app = pick(rt.apply_last_wins, rt_ref.apply_last_wins_ref)
    fan = pick(lf.leader_fanout, lf_ref.leader_fanout_ref)
    aes = pick(ae.ae_sync, ae_ref.ae_sync_ref)
    grp = pick(gd.group_reduce, gd_ref.group_reduce_ref)
    return {
        "log_match_append": lambda c, t, kw: lma(t)(*c.values(),
                                                    w=kw["max_ship"]),
        "commit_majority": lambda c, t, kw: (com(t)(*c.values()),),
        "apply_last_wins": lambda c, t, kw: (app(t)(*c.values()),),
        "leader_fanout": lambda c, t, kw: fan(t)(
            *c.values(), msg_budget=kw["msg_budget"],
            max_ship=kw["max_ship"],
            entries_per_msg=kw["entries_per_msg"]),
        "ae_sync": lambda c, t, kw: aes(t)(*c.values()),
        "group_reduce": lambda c, t, kw: grp(t)(*c.values(),
                                                n_groups=kw["G"]),
    }


def group_library(c, G):
    """The nearest PyTorch calls to group_reduce, three of them:
    `index_add_` for the int sums and for the float sums, and
    `scatter_reduce_("amax")` for the max; dropped members land in a
    spare row G."""
    import torch
    gids = c["gids"].long()
    gids = torch.where((gids >= 0) & (gids < G), gids, G)
    B, Fi = c["int_mat"].shape
    Ff = c["flt_mat"].shape[1]
    dev = gids.device
    g_int = torch.zeros((G + 1, Fi), dtype=torch.int32, device=dev)
    g_int.index_add_(0, gids, c["int_mat"])
    g_sum = torch.zeros((G + 1, Ff), dtype=torch.float32, device=dev)
    g_sum.index_add_(0, gids, c["flt_mat"])
    g_max = torch.full((G + 1, Ff), -torch.inf, device=dev)
    g_max.scatter_reduce_(0, gids[:, None].expand(B, Ff), c["flt_mat"],
                          "amax")
    return g_int[:G], g_sum[:G], g_max[:G]


def run_kernel_checks(dev, cfg, static, fleet_shapes):
    """Every kernel == its twin on the card, at the solo path's shapes
    (B=1), at the fleet path's (B=5) and on the edge cases; then device
    times.  Returns {name: {tag: {ms, plain_ms, library_ms, bytes,
    ops}}} for tag "solo" (the four slice-1 kernels) and "fleet" (all
    six)."""
    import numpy as np
    import torch
    from repro_torch import kernels as K_

    N = static["N"]
    L, K = cfg.max_log, cfg.key_space
    W, A = static["max_ship"], static["max_apply"]
    O, S, Fi, G = (fleet_shapes["O"], fleet_shapes["S"], fleet_shapes["Fi"],
                   fleet_shapes["G"])
    kw = dict(msg_budget=static["msg_budget"], max_ship=W,
              entries_per_msg=static["entries_per_msg"], G=G)
    B = FLEET_B
    rng = np.random.default_rng(0)
    maj = static["majority"]
    # (tag or None, case, kwargs override): the tagged cases are timed
    cases = {
        "log_match_append": [
            ("solo", lma_case(rng, 1, N, L, W), {}),
            ("fleet", lma_case(rng, B, N, L, W), {}),
            (None, lma_case(rng, 1, N, L, W, due_frac=1.0), {}),
            (None, lma_case(rng, 1, N, L, W, due_frac=0.0), {}),
            (None, lma_case(rng, 1, N, L, W, empty=True, due_frac=1.0), {}),
            (None, lma_case(rng, 1, 1, 1, 1, due_frac=1.0), {}),
            (None, lma_case(rng, 3, 5, 33, 256, due_frac=1.0), {})],
        "commit_majority": [
            ("solo", commit_case(rng, 1, N, L, majority=maj), {}),
            ("fleet", commit_case(rng, B, N, L, majority=maj), {}),
            (None, commit_case(rng, B, N, L), {}),   # mixed majorities
            (None, commit_case(rng, 1, N, L, dead_frac=1.0), {}),
            (None, commit_case(rng, 1, N, L, dead_frac=0.0), {}),
            (None, commit_case(rng, 1, 9, 40, majority=0), {}),
            (None, commit_case(rng, 1, N, L, majority=N + 3), {}),
            (None, commit_case(rng, 1, 1, 16, majority=1), {})],
        "apply_last_wins": [
            ("solo", apply_case(rng, 1, N, K, A), {}),
            ("fleet", apply_case(rng, B, N, K, A), {}),
            (None, apply_case(rng, 1, 3, 5, A), {}),
            (None, apply_case(rng, 3, N, K, 1), {})],
        "leader_fanout": [
            ("solo", fanout_case(rng, 1, N, L), {}),
            ("fleet", fanout_case(rng, B, N, L), {}),
            (None, fanout_case(rng, 1, N, L, has_leader=False), {}),
            (None, fanout_case(rng, 1, N, L, alive_frac=0.0), {}),
            (None, fanout_case(rng, 1, N, L, warn_frac=1.0), {}),
            (None, fanout_case(rng, 1, N, L), dict(msg_budget=0)),
            (None, fanout_case(rng, 1, 1, 8), {}),
            (None, fanout_case(rng, 1, 1024, L), {})],
        "ae_sync": [
            ("fleet", ae_case(rng, B, O, N, S), {}),
            (None, ae_case(rng, 1, O, N, S, voter_frac=0.0), {}),
            (None, ae_case(rng, 3, 7, 9, 2, voter_frac=1.0, interval=1),
             {}),
            (None, ae_case(rng, 2, 130, 17, 3, interval=0), {})],
        "group_reduce": [
            ("fleet", group_case(rng, B, G, Fi, 3), {}),
            (None, group_case(rng, 13, 3, 40, 3, dropped=0.2), dict(G=3)),
            (None, group_case(rng, 6, 3, 5, 2, dropped=1.0), dict(G=3)),
            (None, group_case(rng, 37, 1, 1, 3), dict(G=1))],
    }
    # the warned-secretary handoff: every follower wired to an alive
    # SECRETARY, half of them warned
    c = fanout_case(rng, 1, N, L, alive_frac=1.0, warn_frac=0.0)
    c["role"][:] = 0
    c["role"][0, 7:23] = 3
    c["sec_of"][0, :7] = 7 + np.arange(7)
    c["warn_timer"][0, 7:23:2] = 2
    c["app_arrive_t"][:] = -1
    cases["leader_fanout"].append((None, c, {}))
    # the digest tier: dead observers; a dead wired follower
    c = ae_case(rng, 1, O, N, S, interval=1)
    c["dobs_alive"][:] = False
    cases["ae_sync"].append((None, c, {}))
    c = ae_case(rng, 1, 16, N, S, voter_frac=1.0, interval=1)
    c["dobs_alive"][:] = True
    c["alive"][0, :] = True
    c["alive"][0, 0] = False
    c["dobs_fol"][:] = 0
    cases["ae_sync"].append((None, c, {}))
    # an empty group among populated ones
    c = group_case(rng, 9, 4, 20, 3)
    c["gids"] = np.where(c["gids"] == 2, 0, c["gids"])
    cases["group_reduce"].append((None, c, dict(G=4)))

    fns = kernel_fns()
    results = {}
    for name, items in cases.items():
        fn = fns[name]
        for _, case, over in items:
            k = dict(kw, **over)
            t = to_dev(case, dev)
            got = fn(clone(t), False, k)
            torch.cuda.synchronize()
            want = fn(clone(t), True, k)
            check_equal(name, got, want)
        results[name] = {}
        for tag, case, over in items:
            if tag is None:
                continue
            k = dict(kw, **over)
            t = to_dev(case, dev)
            ka, kb = clone(t), clone(t)
            ms = device_ms(lambda: fn(ka, False, k), 100, 4_000_000)
            plain_ms = device_ms(lambda: fn(kb, True, k), 30, 40_000_000)
            lib_ms = None
            if name == "group_reduce":
                kc = clone(t)
                lib = group_library(kc, k["G"])
                want = fn(clone(t), True, k)
                check_equal(f"{name} library ints", lib[:1], want[:1])
                lib_ms = device_ms(lambda: group_library(kc, k["G"]), 100,
                                   4_000_000)
            nbytes, ops = work_of(name, case, static, k)
            results[name][tag] = dict(ms=ms, plain_ms=plain_ms,
                                      library_ms=lib_ms, bytes=nbytes,
                                      ops=ops)
            Bc = np.asarray(next(iter(case.values()))).shape[0]
            log(f"kernel {name} [{tag}, B={Bc}]: {ms * 1e3:.2f} us "
                f"(twin {plain_ms * 1e3:.2f} us"
                + (f", library {lib_ms * 1e3:.2f} us" if lib_ms else "")
                + f"), {nbytes} B, {ops} ops, bound "
                f"{bound_ms(nbytes, ops) * 1e3:.4f} us")
        log(f"kernel {name}: equal to twin on {len(items)} cases")
    K_.reset_launch_counts()
    return results


def work_of(name, c, static, kw):
    """Bytes the function must move (each input read once, each output
    written once) and its 32-bit operations, counted on these inputs."""
    import numpy as np
    a = lambda k: np.asarray(c[k])
    if name == "log_match_append":
        B, N, L = a("log_term").shape
        frm, up = a("app_from_len"), a("app_upto")
        prev = frm - 1
        pc = np.clip(prev, 0, L - 1)
        same = np.take_along_axis(a("log_term"), pc[..., None], 2)[..., 0] \
            == np.take_along_axis(a("ldr_term"), pc, 1)
        acc = a("due") & ((prev < 0) | same)
        win = np.clip(np.minimum(np.minimum(up, frm + static["max_ship"]), L)
                      - np.maximum(frm, 0), 0, None)
        moved = int((win * acc).sum())
        nbytes = B * N * (3 * 4 + 1 + 2 * 4) + B * N * (4 + 1) + moved * 24
        return nbytes, B * N * 8 + moved * 3
    if name == "commit_majority":
        B, N = a("match_len").shape
        L = a("ldr_term").shape[1]
        return B * (N * 5 + L * 4 + 12), B * (N * N * 2 + L)
    if name == "apply_last_wins":
        B, N, K = a("kv").shape
        keys = a("keys")
        keys = np.where(keys < 0, keys + K, keys)
        writes = int((a("valid") & (keys >= 0) & (keys < K)).sum())
        A = keys.shape[2]
        return B * N * A * 9 + writes * 4, B * N * A * 4
    if name == "leader_fanout":
        B, N = a("role").shape
        return B * (N * (9 * 4 + 1) + 2 * N * 4 + 6 * 4 + 5 * N * 4 + 4), \
            B * N * 40
    if name == "ae_sync":
        B, O = a("dobs_fol").shape
        N = a("alive").shape[1]
        S = a("site_rtt").shape[1]
        return B * (O * (1 + 7 * 4) + N * (2 + 4 * 4) + S * S * 4 + 8 +
                    O * 4 * 4), B * O * 20
    # group_reduce
    B, Fi = a("int_mat").shape
    Ff = a("flt_mat").shape[1]
    G = kw["G"]
    n_in = int(((a("gids") >= 0) & (a("gids") < G)).sum())
    return (B * 4 + B * (Fi + Ff) * 4 + G * (Fi + 2 * Ff) * 4,
            n_in * (Fi + 2 * Ff) + B * G * (Fi + Ff))


def bound_ms(nbytes, ops):
    return max(nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S) * 1e3


def bound_by(nbytes, ops):
    return ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / INT_OPS_PER_S
            else "operations")


# --------------------------------------------------------------------- #
# phase 3: the solo path
# --------------------------------------------------------------------- #
def check_report(rep, ctx):
    for k in ("reads_arrived", "writes_arrived"):
        if getattr(rep, k) <= 0:
            raise AssertionError(f"{ctx}: no {k}")
    for k in ("cost", "read_lat_mean"):
        v = getattr(rep, k)
        if not (v == v and abs(v) < 1e30):
            raise AssertionError(f"{ctx}: {k}={v} not finite")


def run_main_path(dev, cfg):
    import torch
    from repro_torch import kernels as K_
    from repro_torch.core import state as SM
    from repro_torch.core.runtime import BWRaftSim
    sim = BWRaftSim(cfg, seed=0, device=dev)
    K_.reset_launch_counts()
    ticks, wall = 0, []
    for e in range(5):
        if e == 3:
            sim.set_rates(phi=0.02)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = sim.run_epoch()          # ends in the digest fetch (a sync)
        wall.append((time.perf_counter() - t0) * 1e3)
        ticks += cfg.period_ticks
        d = {k: v for k, v in rep.__dict__.items()
             if k not in ("decision", "metrics")}
        log(f"epoch {e}: {wall[-1]:.1f} ms  {json.dumps(d)}")
        if rep.decision is not None:
            log(f"  decision {json.dumps(rep.decision.__dict__)}")
        check_report(rep, f"epoch {e}")
    counts = K_.launch_counts()
    log(f"launches over {ticks} solo ticks: {json.dumps(counts)}")
    for name, n in counts.items():
        want = ticks if name in PER_TICK else 0
        if n != want:
            raise AssertionError(f"{name} launched {n} times on the solo "
                                 f"path, expected {want}")
    if sum(r.writes_committed for r in sim.reports) <= 0:
        raise AssertionError("no write committed in 5 epochs")
    bundle = sim.draws.epoch(3, sim.state, sim.cfg_c)
    check_tick_sync_free(SM.batch1(sim.state), sim.static_t,
                         SM.batch1(sim.cfg_c),
                         {k: v.unsqueeze(1) for k, v in bundle.items()}, 3)
    steady = wall[1:]
    log(f"solo epoch wall ms: median {statistics.median(steady):.1f} "
        f"(epochs 1-4; epoch 0 {wall[0]:.1f} incl. warm-up); "
        f"ticks/s {cfg.period_ticks * 1e3 / statistics.median(steady):.1f}")
    return sim, counts, wall


def check_tick_sync_free(state, static, cfg_c, bundle, ticks):
    """The batched tick never waits for the device: any synchronizing
    call (a host read, a pageable host-to-device copy) raises here."""
    import torch
    from repro_torch.core import step as step_mod
    from repro_torch.core.draws import row
    st = {k: v.clone() for k, v in state.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(ticks):
            st, _ = step_mod.tick(st, static, cfg_c, row(bundle, t))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"tick sync check: {ticks} ticks of B={st['tick'].shape[0]} ran "
        f"with no host synchronization")


def run_quickstart(dev, cfg):
    """The quickstart's client sequence through BWKVService."""
    from repro_torch.core import state as SM
    from repro_torch.core.runtime import BWRaftSim
    from repro_torch.kvstore.service import BWKVService
    sim = BWRaftSim(cfg, write_rate=2.0, read_rate=8.0, seed=0, device=dev)
    svc = BWKVService(sim)
    t0 = time.perf_counter()
    svc._step(120)
    lid = int(SM.leader_id(sim.state))
    if lid < 0:
        raise AssertionError("no leader after 120 ticks")
    sim._lease(3, 4)
    r = svc.put("paper/title", 2022)
    v, rev = svc.get("paper/title")
    if v != 2022:
        raise AssertionError(f"get(paper/title) = {v}")
    sim.set_rates(phi=1.0)
    svc._step(5)
    alive = sim.state["alive"].cpu().numpy()
    if alive[~sim.static["is_voter"]].any():
        raise AssertionError("phi=1 left a spot node alive")
    sim.set_rates(phi=0.0)
    r2 = svc.put("paper/venue", 42)
    v2, _ = svc.get("paper/venue")
    v3, _ = svc.get("paper/title")
    if (v2, v3) != (42, 2022):
        raise AssertionError(f"after the kill: venue={v2} title={v3}")
    ms = (time.perf_counter() - t0) * 1e3
    log(f"quickstart: leader {lid}; put latencies {r.latency_ticks}, "
        f"{r2.latency_ticks} ticks; read latencies "
        f"{svc.read_latencies} ticks; {ms:.0f} ms wall for "
        f"{int(sim.state['tick'])} ticks")


# --------------------------------------------------------------------- #
# phases 4 and 7: card against CPU
# --------------------------------------------------------------------- #
def run_card_vs_cpu(tag, state, statics, cfg_c, T, gids=None, n_groups=0):
    """One epoch of a batched state on the card and on the CPU from the
    same state and the same per-member draw bundles (and, with groups,
    the group digest): int/bool leaves equal, floats within rtol."""
    import numpy as np
    import torch
    from repro_torch.core import state as SM
    from repro_torch.core.draws import TorchDraws, fleet_epoch
    from repro_torch.core.fleet import _group_digest
    from repro_torch.core.runtime import device_epoch
    cpu = torch.device("cpu")
    dev = state["tick"].device
    st_cpu = {k: v.to(cpu) for k, v in state.items()}
    st_gpu = {k: v.clone() for k, v in state.items()}
    cfg_cpu = {k: v.to(cpu) for k, v in cfg_c.items()}
    B = state["tick"].shape[0]
    bundle = fleet_epoch([TorchDraws(123 + i, cpu) for i in range(B)], T,
                         st_cpu, cfg_cpu)
    t0 = time.perf_counter()
    s_g, d_g = device_epoch(st_gpu, SM.stack_static(statics, dev), cfg_c,
                            {k: v.to(dev) for k, v in bundle.items()}, T)
    if n_groups:
        d_g["group"] = _group_digest(d_g, gids, n_groups)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    s_c, d_c = device_epoch(st_cpu, SM.stack_static(statics, cpu), cfg_cpu,
                            bundle, T)
    if n_groups:
        d_c["group"] = _group_digest(d_c, gids.cpu(), n_groups)
    t2 = time.perf_counter()
    pairs = [("digest." + k, d_g[k], d_c[k]) for k in d_g if k != "group"]
    if n_groups:
        pairs += [("group." + k, d_g["group"][k], d_c["group"][k])
                  for k in d_g["group"]]
    pairs += [("state." + k, s_g[k], s_c[k]) for k in s_g]
    n_exact = n_float = 0
    for name, a, b in pairs:
        a = a.cpu()
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       rtol=FLOAT_RTOL, err_msg=name)
            n_float += 1
        elif not torch.equal(a, b):
            raise AssertionError(f"{tag}: card and CPU differ at {name}")
        else:
            n_exact += 1
    log(f"{tag} card vs CPU, one epoch of B={B}: {n_exact} int/bool leaves "
        f"equal, {n_float} float leaves within rtol={FLOAT_RTOL}; card "
        f"{(t1 - t0) * 1e3:.0f} ms, CPU {(t2 - t1) * 1e3:.0f} ms")


# --------------------------------------------------------------------- #
# phase 5: the fleet path; phase 6: the fixed-role sweep
# --------------------------------------------------------------------- #
def slice_fleet(dev, cfg):
    """The slice's fleet: BW-Raft, Raft and a 2-shard Multi-Raft group
    (one comparison point at 8 writes / 32 reads per tick) plus BW-Raft
    with the 50X digest-observer rack."""
    from repro_torch.core.fleet import (FleetSim, digest_rack_spec,
                                        system_specs)
    specs = system_specs(cfg, write_rate=8.0, read_rate=32.0, seed=0,
                         shards=2, group_id=0) + \
        [digest_rack_spec(cfg, write_rate=8.0, read_rate=32.0, seed=0)]
    return FleetSim(specs, device=dev)


def run_fleet_path(dev, cfg):
    import torch
    from repro_torch import kernels as K_
    from repro_torch.core.draws import fleet_epoch
    fleet = slice_fleet(dev, cfg)
    B, T = fleet.shapes.B, fleet.shapes.T
    log(f"fleet: {fleet.shapes}")
    torch.cuda.reset_peak_memory_stats()
    K_.reset_launch_counts()
    wall = []
    for e in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reps = fleet.run_epoch()       # ends in the digest fetch (a sync)
        wall.append((time.perf_counter() - t0) * 1e3)
        for i, rep in enumerate(reps):
            check_report(rep, f"fleet epoch {e} member {i}")
        g = fleet.group_reports[0][-1]
        gd = {k: v for k, v in g.__dict__.items() if k != "metrics"}
        log(f"fleet epoch {e}: {wall[-1]:.1f} ms; writes committed "
            f"{[r.writes_committed for r in reps]}; multiraft group "
            f"{json.dumps(gd)}")
    counts = K_.launch_counts()
    ticks = 3 * T
    log(f"launches over {ticks} fleet ticks of B={B}: {json.dumps(counts)}")
    for name, n in counts.items():
        want = 3 if name == "group_reduce" else ticks
        if n != want:
            raise AssertionError(f"{name} launched {n} times on the fleet "
                                 f"path, expected {want}")
    obs = fleet.members[-1].reports[-1]
    log(f"digest rack member: n_obs_digest {obs.n_obs_digest}, "
        f"obs_reads_served {obs.obs_reads_served}, obs_rerouted "
        f"{obs.obs_rerouted}, obs_stale_p95 {obs.obs_stale_p95}, "
        f"obs_stale_p99 {obs.obs_stale_p99}")
    if obs.obs_reads_served <= 0 or not obs.obs_stale_p99 <= 12:
        raise AssertionError("the digest rack served no read within its "
                             "staleness bound")
    if g.writes_committed <= 0 or g.two_pc_prepares <= 0:
        raise AssertionError("the Multi-Raft group committed nothing")
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    med = statistics.median(wall)
    log(f"fleet epoch wall ms: {[round(w, 1) for w in wall]}, median "
        f"{med:.1f}; member-ticks/s {B * T * 1e3 / med:.1f}; peak device "
        f"memory {peak:.0f} MiB")
    bundle = fleet_epoch(fleet.draws, 3, fleet.state, fleet._cfg_c)
    check_tick_sync_free(fleet.state, fleet._bstatic, fleet._cfg_c, bundle,
                         3)
    return fleet, counts, wall


def run_sweep(dev, cfg):
    import torch
    from repro_torch.core.fleet import FleetSim
    writes = [4.0 * (k + 1) for k in range(8)]
    fleet = FleetSim.from_sweep(
        cfg, {"write_rate": writes, "seed": [10, 11, 12, 13]},
        manage_resources=False, read_rate=32.0, device=dev)
    B, T = fleet.shapes.B, fleet.shapes.T
    if B != SWEEP_B or not fleet.single_dispatch_eligible:
        raise AssertionError(f"sweep fleet B={B}")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fleet.run(1)
    t1 = time.perf_counter()
    fleet.lease_fixed(2, 8)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    reps = fleet.run(2)
    t3 = time.perf_counter()
    for i, r in enumerate(reps):
        for e, rep in enumerate(r):
            check_report(rep, f"sweep member {i} epoch {e}")
    if min(r[-1].writes_committed for r in reps) <= 0:
        raise AssertionError("a sweep member committed nothing")
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"sweep B={B}: run(1) {(t1 - t0) * 1e3:.1f} ms, lease_fixed "
        f"{(t2 - t1) * 1e3:.1f} ms, run(2) {(t3 - t2) * 1e3:.1f} ms "
        f"(multi-epoch path); member-ticks/s "
        f"{B * 2 * T / (t3 - t2):.1f}; peak device memory {peak:.0f} MiB")


def run_profile(tag, state, static, cfg_c, bundle, ticks):
    """Device busy share and kernel time by name over the last
    `ticks - 2` of `ticks` batched ticks."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import step as step_mod
    from repro_torch.core.draws import row
    st = {k: v.clone() for k, v in state.items()}
    for t in range(2):                                  # warm
        st, _ = step_mod.tick(st, static, cfg_c, row(bundle, t))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(2, ticks):
            st, _ = step_mod.tick(st, static, cfg_c, row(bundle, t))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    evs = [e for e in avg if e.self_device_time_total > 0
           and not e.key.startswith("aten::")]
    dev_us = sum(e.self_device_time_total for e in evs)
    n_launch = sum(e.count for e in evs)
    n = ticks - 2
    log(f"{tag} profile over {n} ticks: wall {wall * 1e3 / n:.3f} ms/tick, "
        f"device busy {dev_us / 1e3 / n:.3f} ms/tick "
        f"({100 * dev_us / 1e6 / wall:.1f}% of wall), "
        f"{n_launch / n:.0f} device kernels and copies/tick")
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:12]
    for e in top:
        log(f"  {e.self_device_time_total / n:9.2f} us/tick "
            f"{e.count / n:6.1f}/tick  {e.key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile 10 ticks of the solo and fleet paths")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 3
    sys.path.insert(0, str(src))
    from repro_torch.configs.bwraft_kv import CONFIG
    from repro_torch.core import state as SM
    from repro_torch.core.draws import fleet_epoch
    from repro_torch.core.fleet import group_digest_width, rack_voters
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    libs = build.build()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        info = path.with_suffix(".log")
        if info.exists():
            for ln in info.read_text().splitlines():
                if "registers" in ln or "spill" in ln:
                    log(f"  ptxas {name}: {ln.strip()}")
    dev = torch.device("cuda")
    static = SM.build_static(CONFIG)
    fleet_shapes = dict(O=50 * rack_voters(CONFIG), S=CONFIG.num_sites,
                        Fi=group_digest_width(CONFIG), G=1)
    results = run_kernel_checks(dev, CONFIG, static, fleet_shapes)
    sim, solo_counts, _ = run_main_path(dev, CONFIG)
    run_quickstart(dev, CONFIG)
    run_card_vs_cpu("solo", SM.batch1(sim.state), [sim.static],
                    SM.batch1(sim.cfg_c), CONFIG.period_ticks)
    fleet, fleet_counts, _ = run_fleet_path(dev, CONFIG)
    run_sweep(dev, CONFIG)
    run_card_vs_cpu("fleet", fleet.state, [m.static for m in fleet.members],
                    fleet._cfg_c, CONFIG.period_ticks, fleet._gids,
                    fleet.n_groups)
    if args.profile:
        b = sim.draws.epoch(10, sim.state, sim.cfg_c)
        run_profile("solo", SM.batch1(sim.state), sim.static_t,
                    SM.batch1(sim.cfg_c),
                    {k: v.unsqueeze(1) for k, v in b.items()}, 10)
        run_profile("fleet", fleet.state, fleet._bstatic, fleet._cfg_c,
                    fleet_epoch(fleet.draws, 10, fleet.state, fleet._cfg_c),
                    10)
    kernels = []
    for name in REPLACES:
        r = results[name]["fleet"]
        entry = {
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": fleet_counts[name],
            "max_abs_err": 0, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms(r["bytes"], r["ops"]),
            "bound_by": bound_by(r["bytes"], r["ops"]),
            "library_ms": r["library_ms"],
            "launches_solo": solo_counts[name]}
        if "solo" in results[name]:
            s = results[name]["solo"]
            entry.update(ms_solo=s["ms"], plain_ms_solo=s["plain_ms"],
                         bound_ms_solo=bound_ms(s["bytes"], s["ops"]))
        kernels.append(entry)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
