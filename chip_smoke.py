#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of BW-Raft on one NVIDIA GPU.

    python3 chip_smoke.py            # the smoke run on one GPU
    python3 chip_smoke.py --profile  # also profiles 10 ticks (device
                                     # busy share, kernels by name)

Phases, each fatal on failure:

1. print the card's name and power limit, build the CUDA kernels from
   `src/repro_torch/kernels/csrc/` (one nvcc per source, in parallel);
2. each kernel against its plain PyTorch twin on the same CUDA inputs at
   the paper's shapes (N=87, L=4096, K=1024, W=256, A=8) plus edge cases,
   exact equality, then device times of kernel and twin (CUDA events
   around a launch queued behind a sleep kernel, median of many);
3. the main path: `BWRaftSim(CONFIG, seed=0)`, managed, 3 epochs, then
   2 more at phi=0.02, with every launch count set to 0 just before and
   read just after (each kernel must run once per tick: 500); then the
   quickstart's client sequence through `BWKVService`;
4. one epoch from the same state and the same draw bundle on the card
   (kernels) and on the CPU (twins): integer and bool results equal,
   float results within rtol=1e-5 (float32 sums reduce in another order
   on the card);
5. a `kernels` JSON line, the card line, and the last line
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
}
SOURCE = {
    "log_match_append": "src/repro_torch/kernels/csrc/raft_tick.cu",
    "commit_majority": "src/repro_torch/kernels/csrc/raft_tick.cu",
    "apply_last_wins": "src/repro_torch/kernels/csrc/raft_tick.cu",
    "leader_fanout": "src/repro_torch/kernels/csrc/leader_fanout.cu",
}


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


def lma_case(rng, N, L, W, *, due_frac=0.5, empty=False):
    import numpy as np
    hi = 1 if empty else L + 1
    frm = rng.integers(0, hi, N)
    return dict(
        log_term=rng.integers(0, 4, (N, L)),
        log_key=rng.integers(0, 8, (N, L)),
        log_val=rng.integers(0, 64, (N, L)),
        ldr_term=rng.integers(0, 4, L), ldr_key=rng.integers(0, 8, L),
        ldr_val=rng.integers(0, 64, L),
        log_len=rng.integers(0, hi, N), app_from_len=frm,
        app_upto=np.minimum(frm + rng.integers(-8, W + 40, N), L),
        due=rng.random(N) < due_frac)


def commit_case(rng, N, L, *, dead_frac=0.3):
    return dict(match_len=rng.integers(0, L + 1, N),
                voter_alive=rng.random(N) >= dead_frac,
                ldr_term=rng.integers(0, 3, L),
                ldr_cur_term=rng.integers(0, 3, ()))


def apply_case(rng, N, K, A):
    return dict(kv=rng.integers(-4, 4, (N, K)),
                keys=rng.integers(-K - 3, K + 3, (N, A)),
                vals=rng.integers(0, 2 ** 20, (N, A)),
                valid=rng.random((N, A)) < 0.7)


def fanout_case(rng, N, L, *, has_leader=True, alive_frac=0.8,
                warn_frac=0.3):
    import numpy as np
    warn = np.where(rng.random(N) < warn_frac, rng.integers(0, 5, N), -1)
    arrive = np.where(rng.random(N) < 0.6, -1, rng.integers(0, 40, N))
    return dict(
        role=rng.integers(0, 6, N), alive=rng.random(N) < alive_frac,
        warn_timer=warn, sec_of=rng.integers(-1, N, N),
        match_len=rng.integers(0, L + 1, N), app_arrive_t=arrive,
        app_from_len=rng.integers(0, L + 1, N),
        app_upto=rng.integers(0, L + 1, N), app_term=rng.integers(0, 4, N),
        app_commit=rng.integers(0, L + 1, N), rtt=rng.integers(1, 20, (N, N)),
        lid_c=rng.integers(0, N, ()), has_leader=np.asarray(has_leader),
        tick=rng.integers(0, 100, ()), ldr_len=rng.integers(0, L + 1, ()),
        ldr_term=rng.integers(0, 4, ()), ldr_commit=rng.integers(0, L + 1, ()))


def to_dev(case, dev):
    import numpy as np
    import torch
    out = {}
    for k, v in case.items():
        a = np.asarray(v)
        a = a if a.dtype == bool else a.astype(np.int32)
        out[k] = torch.as_tensor(a, device=dev)
    return out


def clone(case):
    return {k: v.clone() for k, v in case.items()}


def check_equal(name, got, want):
    import torch
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{name}: output {i} differs from the twin")


def run_kernel_checks(dev, cfg, static):
    """Every kernel == its twin on the card, at CONFIG shapes and on the
    edge cases; returns {name: (max_abs_err, ms, plain_ms, bytes, ops)}."""
    import numpy as np
    import torch
    from repro_torch.kernels.leader_fanout import ops as lf
    from repro_torch.kernels.leader_fanout import ref as lf_ref
    from repro_torch.kernels.raft_tick import ops as rt
    from repro_torch.kernels.raft_tick import ref as rt_ref

    N = static["N"]
    L, K = cfg.max_log, cfg.key_space
    W, A = static["max_ship"], static["max_apply"]
    fan_kw = dict(msg_budget=static["msg_budget"],
                  max_ship=static["max_ship"],
                  entries_per_msg=static["entries_per_msg"])
    rng = np.random.default_rng(0)

    def lma(c, twin):
        f = rt_ref.log_match_append_ref if twin else rt.log_match_append
        return f(*c.values(), w=W)

    def commit(c, twin, majority=static["majority"]):
        f = rt_ref.commit_majority_ref if twin else rt.commit_majority
        return (f(*c.values(), majority),)

    def apply(c, twin):
        f = rt_ref.apply_last_wins_ref if twin else rt.apply_last_wins
        return (f(*c.values()),)

    def fan(c, twin, kw=fan_kw):
        f = lf_ref.leader_fanout_ref if twin else lf.leader_fanout
        return f(*c.values(), **kw)

    cases = {
        "log_match_append": [
            (lma, lma_case(rng, N, L, W)),
            (lma, lma_case(rng, N, L, W, due_frac=1.0)),
            (lma, lma_case(rng, N, L, W, due_frac=0.0)),
            (lma, lma_case(rng, N, L, W, empty=True, due_frac=1.0)),
            (lma, lma_case(rng, 1, 1, 1, due_frac=1.0)),
            (lma, lma_case(rng, 5, 33, 256, due_frac=1.0))],
        "commit_majority": [
            (commit, commit_case(rng, N, L)),
            (commit, commit_case(rng, N, L, dead_frac=1.0)),
            (commit, commit_case(rng, N, L, dead_frac=0.0)),
            (lambda c, t: commit(c, t, majority=0), commit_case(rng, 9, 40)),
            (lambda c, t: commit(c, t, majority=N + 3),
             commit_case(rng, N, L)),
            (lambda c, t: commit(c, t, majority=1), commit_case(rng, 1, 16))],
        "apply_last_wins": [
            (apply, apply_case(rng, N, K, A)),
            (apply, apply_case(rng, 3, 5, A)),
            (apply, apply_case(rng, N, K, 1))],
        "leader_fanout": [
            (fan, fanout_case(rng, N, L)),
            (fan, fanout_case(rng, N, L, has_leader=False)),
            (fan, fanout_case(rng, N, L, alive_frac=0.0)),
            (fan, fanout_case(rng, N, L, warn_frac=1.0)),
            (lambda c, t: fan(c, t, dict(fan_kw, msg_budget=0)),
             fanout_case(rng, N, L)),
            (fan, fanout_case(rng, 1, 8)),
            (fan, fanout_case(rng, 1024, L))],
    }
    # the warned-secretary handoff: every follower wired to an alive
    # SECRETARY, half of them warned
    c = fanout_case(rng, N, L, alive_frac=1.0, warn_frac=0.0)
    c["role"][:] = 0
    c["role"][7:23] = 3
    c["sec_of"][:7] = 7 + np.arange(7)
    c["warn_timer"][7:23:2] = 2
    c["app_arrive_t"][:] = -1
    cases["leader_fanout"].append((fan, c))

    from repro_torch import kernels as K_
    results = {}
    for name, items in cases.items():
        for fn, case in items:
            t = to_dev(case, dev)
            got = fn(clone(t), False)
            torch.cuda.synchronize()
            want = fn(clone(t), True)
            check_equal(name, got, want)
        # timing on the first (CONFIG-shaped) case
        fn, case = items[0]
        t = to_dev(case, dev)
        ka, kb = clone(t), clone(t)
        ms = device_ms(lambda: fn(ka, False), 100, 4_000_000)
        plain_ms = device_ms(lambda: fn(kb, True), 30, 20_000_000)
        nbytes, ops = work_of(name, case, static)
        results[name] = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms,
                             bytes=nbytes, ops=ops)
        log(f"kernel {name}: equal to twin on {len(items)} cases; "
            f"{ms * 1e3:.2f} us (twin {plain_ms * 1e3:.2f} us), "
            f"{nbytes} B, bound {bound_ms(nbytes, ops) * 1e3:.4f} us")
    K_.reset_launch_counts()
    return results


def work_of(name, c, static):
    """Bytes the function must move (each input read once, each output
    written once) and its 32-bit operations, counted on these inputs."""
    import numpy as np
    N = np.asarray(c[next(iter(c))]).shape[0]
    if name == "log_match_append":
        L = np.asarray(c["log_term"]).shape[1]
        frm, up = np.asarray(c["app_from_len"]), np.asarray(c["app_upto"])
        prev = frm - 1
        pc = np.clip(prev, 0, L - 1)
        same = np.asarray(c["log_term"])[np.arange(N), pc] == \
            np.asarray(c["ldr_term"])[pc]
        acc = np.asarray(c["due"]) & ((prev < 0) | same)
        win = np.clip(np.minimum(np.minimum(up, frm + static["max_ship"]), L)
                      - np.maximum(frm, 0), 0, None)
        moved = int((win * acc).sum())
        nbytes = N * (3 * 4 + 1 + 2 * 4) + N * (4 + 1) + moved * 3 * 8
        return nbytes, N * 8 + moved * 3
    if name == "commit_majority":
        L = np.asarray(c["ldr_term"]).shape[0]
        return N * 5 + L * 4 + 8, N * N * 2 + L
    if name == "apply_last_wins":
        K = np.asarray(c["kv"]).shape[1]
        keys = np.asarray(c["keys"])
        keys = np.where(keys < 0, keys + K, keys)
        writes = int((np.asarray(c["valid"]) & (keys >= 0) &
                      (keys < K)).sum())
        A = keys.shape[1]
        return N * A * 9 + writes * 4, N * A * 4
    # leader_fanout
    return N * (9 * 4 + 1) + 2 * N * 4 + 6 * 4 + 5 * N * 4 + 4, N * 40


def bound_ms(nbytes, ops):
    return max(nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S) * 1e3


def bound_by(nbytes, ops):
    return ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / INT_OPS_PER_S
            else "operations")


# --------------------------------------------------------------------- #
# phase 3: the main path
# --------------------------------------------------------------------- #
def run_main_path(dev, cfg):
    import torch
    from repro_torch import kernels as K_
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
        for k in ("reads_arrived", "writes_arrived"):
            if getattr(rep, k) <= 0:
                raise AssertionError(f"epoch {e}: no {k}")
        for k in ("cost", "read_lat_mean"):
            v = getattr(rep, k)
            if not (v == v and abs(v) < 1e30):
                raise AssertionError(f"epoch {e}: {k}={v} not finite")
    counts = K_.launch_counts()
    log(f"launches over {ticks} ticks: {json.dumps(counts)}")
    for name, n in counts.items():
        if n != ticks:
            raise AssertionError(f"{name} launched {n} times, "
                                 f"expected {ticks}")
    if sum(r.writes_committed for r in sim.reports) <= 0:
        raise AssertionError("no write committed in 5 epochs")
    check_tick_sync_free(sim)
    steady = wall[1:]
    log(f"epoch wall ms: median {statistics.median(steady):.1f} "
        f"(epochs 1-4; epoch 0 {wall[0]:.1f} incl. warm-up); "
        f"ticks/s {cfg.period_ticks * 1e3 / statistics.median(steady):.1f}")
    return sim, counts, wall


def check_tick_sync_free(sim, ticks=3):
    """The tick never waits for the device: any synchronizing call
    (a host read, a pageable host-to-device copy) raises here."""
    import torch
    from repro_torch.core import step as step_mod
    from repro_torch.core.draws import row
    bundle = sim.draws.epoch(ticks, sim.state, sim.cfg_c)
    st = {k: v.clone() for k, v in sim.state.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(ticks):
            st, _ = step_mod.tick(st, sim.static_t, sim.cfg_c,
                                  row(bundle, t))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"tick sync check: {ticks} ticks ran with no host synchronization")


def run_quickstart(dev, cfg):
    """The quickstart's client sequence through BWKVService."""
    import numpy as np
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
# phase 4: card against CPU
# --------------------------------------------------------------------- #
def run_card_vs_cpu(sim):
    import numpy as np
    import torch
    from repro_torch.core import state as SM
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.runtime import device_epoch
    T = sim.cfg.period_ticks
    cpu = torch.device("cpu")
    st_cpu = {k: v.to(cpu) for k, v in sim.state.items()}
    st_gpu = {k: v.clone() for k, v in sim.state.items()}
    cfg_cpu = {k: v.to(cpu) for k, v in sim.cfg_c.items()}
    bundle = TorchDraws(123, cpu).epoch(T, st_cpu, cfg_cpu)
    static_cpu = SM.from_numpy(sim.static, cpu)
    t0 = time.perf_counter()
    s_g, d_g = device_epoch(st_gpu, sim.static_t, sim.cfg_c,
                            {k: v.to(sim.device) for k, v in bundle.items()},
                            T)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    s_c, d_c = device_epoch(st_cpu, static_cpu, cfg_cpu, bundle, T)
    t2 = time.perf_counter()
    n_exact = n_float = 0
    for name, a, b in ([("digest." + k, d_g[k], d_c[k]) for k in d_g] +
                       [("state." + k, s_g[k], s_c[k]) for k in s_g]):
        a = a.cpu()
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       rtol=FLOAT_RTOL, err_msg=name)
            n_float += 1
        elif not torch.equal(a, b):
            raise AssertionError(f"card and CPU differ at {name}")
        else:
            n_exact += 1
    log(f"card vs CPU, one epoch: {n_exact} int/bool leaves equal, "
        f"{n_float} float leaves within rtol={FLOAT_RTOL}; card "
        f"{(t1 - t0) * 1e3:.0f} ms, CPU {(t2 - t1) * 1e3:.0f} ms")


def run_profile(sim, ticks=10):
    """Device busy share and kernel time by name over `ticks` ticks."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import step as step_mod
    from repro_torch.core.draws import row
    bundle = sim.draws.epoch(ticks, sim.state, sim.cfg_c)
    st = {k: v.clone() for k, v in sim.state.items()}
    for t in range(2):                                  # warm
        st, _ = step_mod.tick(st, sim.static_t, sim.cfg_c, row(bundle, t))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(2, ticks):
            st, _ = step_mod.tick(st, sim.static_t, sim.cfg_c,
                                  row(bundle, t))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    # device kernels and copies, not the aten ops that launch them
    evs = [e for e in avg if e.self_device_time_total > 0
           and not e.key.startswith("aten::")]
    dev_us = sum(e.self_device_time_total for e in evs)
    n_launch = sum(e.count for e in evs)
    n = ticks - 2
    syncs = {e.key: e.count / n for e in avg
             if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                          "cudaMemcpy", "cudaMemcpyAsync",
                          "aten::_local_scalar_dense", "aten::item")}
    log(f"host waits per tick (cuda API / aten): {json.dumps(syncs)}")
    log(f"profile over {n} ticks: wall {wall * 1e3 / n:.3f} ms/tick, "
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
                    help="also profile 10 ticks of the main path")
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
    from repro_torch.kernels import build

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
    results = run_kernel_checks(dev, CONFIG, static)
    sim, counts, _ = run_main_path(dev, CONFIG)
    run_quickstart(dev, CONFIG)
    run_card_vs_cpu(sim)
    if args.profile:
        run_profile(sim)
    kernels = []
    for name, r in results.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms(r["bytes"], r["ops"]),
            "bound_by": bound_by(r["bytes"], r["ops"]),
            "library_ms": None})
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
