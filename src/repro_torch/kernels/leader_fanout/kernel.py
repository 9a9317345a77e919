"""ctypes launcher for the leader fan-out CUDA kernel
(`csrc/leader_fanout.cu`), which replaces the Pallas kernel
`repro.kernels.leader_fanout.kernel.leader_fanout_kernel`.

One block per batch member, one thread per node.  About 7 KB moves at
the paper's config, so the launch and the chain inside the kernel bound
it: every load is issued in two round trips before the block's one
barrier, the budget rank is a warp scan by shuffles, and each warp
learns its offset and the block's counts by one warp reduction each
after the barrier.  The design notes are in the CUDA source.
"""
from __future__ import annotations

from repro_torch import kernels as tk
from repro_torch.kernels import build

_FNS = {}


def _fn():
    if "f" not in _FNS:
        _FNS["f"] = build.bind(build.load("leader_fanout"), "leader_fanout",
                               23, 5)
    return _FNS["f"]


def leader_fanout(rows, rtt, scalars, outs, *, msg_budget: int,
                  max_ship: int, entries_per_msg: int) -> None:
    """rows: the ten (B, N) inputs (role, alive, warn_timer, sec_of,
    match_len, app_arrive_t, app_from_len, app_upto, app_term,
    app_commit); rtt (B, N, N); scalars: the six (B,) leader tensors
    (lid_c, has_leader, tick, ldr_len, ldr_term, ldr_commit); outs: the
    five (B, N) app_* rows and the (B,) work delta."""
    B, N = rows[0].shape
    ptrs = [t.data_ptr() for t in (*rows, rtt, *scalars, *outs)]
    with tk.device_stream(rows[0]) as stream:
        rc = _fn()(*ptrs, B, N, int(msg_budget), int(max_ship),
                   int(entries_per_msg), stream)
    if rc != 0:
        raise RuntimeError(f"leader_fanout: CUDA launch failed with "
                           f"error {rc}")
