"""Public op of the leader fan-out family (DESIGN.md §8): what
`core/step.py:leader_step` calls.

The operands of `repro.kernels.leader_fanout.ops` with a leading member
axis B written out (one call serves the whole fleet; B = 1 for one
cluster).  A CPU tensor runs the twin in `ref.py`; a CUDA tensor
launches the kernel in `csrc/leader_fanout.cu` once for all B members
after the operands are checked, else the op raises.  The leaders'
scalars stay (B,) device tensors, so nothing is read on the host.  Every
launch adds one to `leader_fanout.launches`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import check, on_cpu
from repro_torch.kernels.leader_fanout import kernel as K
from repro_torch.kernels.leader_fanout import ref

_I32, _BOOL = torch.int32, torch.bool
_ROWS = ("role", "alive", "warn_timer", "sec_of", "match_len",
         "app_arrive_t", "app_from_len", "app_upto", "app_term",
         "app_commit")
_SCALARS = ("lid_c", "has_leader", "tick", "ldr_len", "ldr_term",
            "ldr_commit")


def leader_fanout(role, alive, warn_timer, sec_of, match_len,
                  app_arrive_t, app_from_len, app_upto, app_term,
                  app_commit, rtt, lid_c, has_leader, tick,
                  ldr_len, ldr_term, ldr_commit, *,
                  msg_budget: int, max_ship: int, entries_per_msg: int):
    """Fused budgeted fan-out.  Per-node rows (B, N) int32 (alive
    bool); rtt (B, N, N) int32; per-member (B,) tensors lid_c,
    has_leader (bool), tick, ldr_len, ldr_term, ldr_commit.  Returns
    (app_arrive_t, app_from_len, app_upto, app_term, app_commit) rows
    (B, N) and the (B,) leader-work delta `work`."""
    args = (role, alive, warn_timer, sec_of, match_len, app_arrive_t,
            app_from_len, app_upto, app_term, app_commit, rtt, lid_c,
            has_leader, tick, ldr_len, ldr_term, ldr_commit)
    kw = dict(msg_budget=msg_budget, max_ship=max_ship,
              entries_per_msg=entries_per_msg)
    if on_cpu(role, "leader_fanout"):
        return ref.leader_fanout_ref(*args, **kw)
    B, N = role.shape
    dev = role.device
    if N > 1024:
        raise ValueError(f"leader_fanout: N={N} exceeds one block (1024)")
    if entries_per_msg < 1:
        raise ValueError(f"leader_fanout: entries_per_msg must be >= 1")
    rows = args[:10]
    for name, t in zip(_ROWS, rows):
        check("leader_fanout", name, t, _BOOL if name == "alive" else _I32,
              (B, N), dev)
    check("leader_fanout", "rtt", rtt, _I32, (B, N, N), dev)
    scalars = args[11:]
    for name, t in zip(_SCALARS, scalars):
        check("leader_fanout", name, t,
              _BOOL if name == "has_leader" else _I32, (B,), dev)
    outs = [torch.empty((B, N), dtype=_I32, device=dev) for _ in range(5)]
    work = torch.empty((B,), dtype=_I32, device=dev)
    K.leader_fanout(rows, rtt, scalars, [*outs, work],
                    stream=torch.cuda.current_stream(dev).cuda_stream, **kw)
    leader_fanout.launches += 1
    return (*outs, work)


leader_fanout.launches = 0
