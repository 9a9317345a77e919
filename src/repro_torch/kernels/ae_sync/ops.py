"""Public op of the anti-entropy family (DESIGN.md §8, §13): what
`core/step.py:anti_entropy_step` calls.

The operands of `repro.kernels.ae_sync.ops` with a leading member axis B
written out (one call serves the whole fleet; B = 1 for one cluster).
The contract is the JAX op's: `dobs_fol` is clipped to the real N,
padded slots (`dobs_alive` False) never sync, and adoption is monotone.
A CPU tensor runs the twin in `ref.py`; a CUDA tensor launches the
kernel in `csrc/ae_sync.cu` after the operands are checked, else the op
raises.  The op returns NEW rows and leaves its inputs untouched.  With
no observer slot (O = 0) there is nothing to sync: the rows come back
unchanged and nothing launches.  Every launch adds one to
`ae_sync.launches`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import check, on_cpu
from repro_torch.kernels.ae_sync import kernel as K
from repro_torch.kernels.ae_sync import ref

_I32, _BOOL = torch.int32, torch.bool
_OBS = ("dobs_alive", "dobs_fol", "dobs_applied", "dobs_term",
        "dobs_digest", "dobs_synced_t", "ae_phase", "dobs_site")
_NODE = ("alive", "is_voter", "applied_len", "term", "applied_digest",
         "site")


def ae_sync(dobs_alive, dobs_fol, dobs_applied, dobs_term, dobs_digest,
            dobs_synced_t, ae_phase, dobs_site, alive, is_voter,
            applied_len, term, applied_digest, site, site_rtt, tick,
            ae_interval):
    """Fused anti-entropy round.  Observer rows (B, O) int32
    (`dobs_alive` bool, `dobs_digest` uint32 bits as int32); node rows
    (B, N) int32 (`alive`, `is_voter` bool); site_rtt (B, S, S) int32;
    tick and ae_interval (B,) int32.  Returns (dobs_applied, dobs_term,
    dobs_digest, dobs_synced_t), four new (B, O) rows."""
    args = (dobs_alive, dobs_fol, dobs_applied, dobs_term, dobs_digest,
            dobs_synced_t, ae_phase, dobs_site, alive, is_voter,
            applied_len, term, applied_digest, site, site_rtt, tick,
            ae_interval)
    if on_cpu(dobs_fol, "ae_sync"):
        return ref.ae_sync_ref(*args)
    B, O = dobs_fol.shape
    N = alive.shape[1]
    S = site_rtt.shape[1]
    dev = dobs_fol.device
    for name, t in zip(_OBS, args[:8]):
        check("ae_sync", name, t, _BOOL if name == "dobs_alive" else _I32,
              (B, O), dev)
    for name, t in zip(_NODE, args[8:14]):
        check("ae_sync", name, t,
              _BOOL if name in ("alive", "is_voter") else _I32, (B, N), dev)
    check("ae_sync", "site_rtt", site_rtt, _I32, (B, S, S), dev)
    check("ae_sync", "tick", tick, _I32, (B,), dev)
    check("ae_sync", "ae_interval", ae_interval, _I32, (B,), dev)
    if O == 0:
        return (dobs_applied.clone(), dobs_term.clone(),
                dobs_digest.clone(), dobs_synced_t.clone())
    outs = [torch.empty((B, O), dtype=_I32, device=dev) for _ in range(4)]
    K.ae_sync(args[:8], args[8:14], site_rtt, tick, ae_interval, outs)
    ae_sync.launches += 1
    return tuple(outs)


ae_sync.launches = 0
