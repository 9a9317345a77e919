"""Public op of the leader fan-out family (DESIGN.md §8): what
`core/step.py:leader_step` calls.

Same unbatched signature as `repro.kernels.leader_fanout.ops`.  A CPU
tensor runs the twin in `ref.py`; a CUDA tensor launches the kernel in
`csrc/leader_fanout.cu` (batch axis B = 1) after the operands are
checked, else the op raises.  The leader's scalars stay 0-d device
tensors, so nothing is read on the host.  Every launch adds one to
`leader_fanout.launches`.
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
    """Fused budgeted fan-out.  Per-node vectors (N,) int32 (alive
    bool); rtt (N, N) int32; 0-d tensors lid_c, has_leader (bool), tick,
    ldr_len, ldr_term, ldr_commit.  Returns (app_arrive_t, app_from_len,
    app_upto, app_term, app_commit, work)."""
    args = (role, alive, warn_timer, sec_of, match_len, app_arrive_t,
            app_from_len, app_upto, app_term, app_commit, rtt, lid_c,
            has_leader, tick, ldr_len, ldr_term, ldr_commit)
    kw = dict(msg_budget=msg_budget, max_ship=max_ship,
              entries_per_msg=entries_per_msg)
    if on_cpu(role, "leader_fanout"):
        return ref.leader_fanout_ref(*args, **kw)
    N = role.shape[0]
    dev = role.device
    if N > 1024:
        raise ValueError(f"leader_fanout: N={N} exceeds one block (1024)")
    if entries_per_msg < 1:
        raise ValueError(f"leader_fanout: entries_per_msg must be >= 1")
    rows = args[:10]
    for name, t in zip(_ROWS, rows):
        check("leader_fanout", name, t, _BOOL if name == "alive" else _I32,
              (N,), dev)
    check("leader_fanout", "rtt", rtt, _I32, (N, N), dev)
    scalars = args[11:]
    for name, t in zip(_SCALARS, scalars):
        check("leader_fanout", name, t,
              _BOOL if name == "has_leader" else _I32, (), dev)
    outs = [torch.empty((1, N), dtype=_I32, device=dev) for _ in range(5)]
    work = torch.empty((1,), dtype=_I32, device=dev)
    K.leader_fanout([t.unsqueeze(0) for t in rows], rtt.unsqueeze(0),
                    [t.reshape(1) for t in scalars], [*outs, work],
                    stream=torch.cuda.current_stream(dev).cuda_stream, **kw)
    leader_fanout.launches += 1
    return (*(o[0] for o in outs), work[0])


leader_fanout.launches = 0
