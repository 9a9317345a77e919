"""Plain PyTorch twin of the anti-entropy kernel, lifted from the XLA
gather form of `repro.core.step.anti_entropy_step` (the same body as
`repro.kernels.ae_sync.ref`) with the member axis B written out.  Equal,
member for member, to the JAX op and ref on the same inputs
(`tests/test_torch_kernels.py`); the uint32 digests are int32 bits.
"""
from __future__ import annotations

import torch


def ae_sync_ref(dobs_alive, dobs_fol, dobs_applied, dobs_term,
                dobs_digest, dobs_synced_t, ae_phase, dobs_site,
                alive, is_voter, applied_len, term, applied_digest,
                site, site_rtt, tick, ae_interval):
    """One anti-entropy round of every member.

    Observer rows (B, O) (dobs_alive bool); node rows (B, N) (alive,
    is_voter bool); site_rtt (B, S, S); tick / ae_interval (B,).
    Returns new (dobs_applied, dobs_term, dobs_digest, dobs_synced_t)
    rows."""
    N = alive.shape[1]
    S = site_rtt.shape[1]
    at = lambda row, idx: torch.gather(row, 1, idx)
    fol_c = dobs_fol.clamp(0, N - 1).long()
    fol_ok = (dobs_fol >= 0) & at(alive, fol_c) & at(is_voter, fol_c)
    alive_voter = is_voter & alive
    any_voter = alive_voter.any(1)
    fallback = torch.argmax(alive_voter.to(torch.int32), 1)  # first True
    eff = torch.where(fol_ok, fol_c, fallback[:, None])
    interval = ae_interval.clamp(min=1)[:, None]
    due = dobs_alive & (fol_ok | any_voter[:, None]) & \
        ((tick[:, None] + ae_phase) % interval == 0)
    src_applied = at(applied_len, eff)
    adopt = due & (src_applied >= dobs_applied)
    applied = torch.where(adopt, src_applied, dobs_applied)
    out_term = torch.where(adopt, at(term, eff), dobs_term)
    out_digest = torch.where(adopt, at(applied_digest, eff), dobs_digest)
    hop_idx = dobs_site.long() * S + at(site, eff).long()
    hop = at(site_rtt.reshape(site_rtt.shape[0], -1), hop_idx)
    synced = torch.where(due, tick[:, None] - hop, dobs_synced_t)
    return (applied.to(torch.int32), out_term.to(torch.int32),
            out_digest.to(torch.int32), synced.to(torch.int32))
