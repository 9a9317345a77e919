"""ctypes launcher for the anti-entropy CUDA kernel (`csrc/ae_sync.cu`),
which replaces the Pallas kernel
`repro.kernels.ae_sync.kernel.ae_sync_kernel`.

One thread per observer slot, one grid row per member, no block
barrier, shared memory or atomics: each warp loads the member's alive
and voter bytes with its slots and finds the first alive voter by one
warp min-reduction, a slot that is not due makes one memory round trip
and a due slot two (its source's values; the hop is a shuffle of the
site-pair matrix the warp preloads).  The library picks its instance:
one for N <= 128 and S*S <= 32 (the fleet's), one for any N and S.
About 28 KB per member at the 50X rack (O = 550), so the launch bounds
it.  The design notes are in the CUDA source.
"""
from __future__ import annotations

from repro_torch import kernels as tk
from repro_torch.kernels import build

_FNS = {}


def _fn():
    if "f" not in _FNS:
        _FNS["f"] = build.bind(build.load("ae_sync"), "ae_sync", 21, 4)
    return _FNS["f"]


def ae_sync(obs_rows, node_rows, site_rtt, tick, interval, outs) -> None:
    """obs_rows: the eight (B, O) inputs (dobs_alive, dobs_fol,
    dobs_applied, dobs_term, dobs_digest, dobs_synced_t, ae_phase,
    dobs_site); node_rows: the six (B, N) inputs (alive, is_voter,
    applied_len, term, applied_digest, site); site_rtt (B, S, S); tick
    and interval (B,); outs: the four (B, O) output rows."""
    B, O = obs_rows[0].shape
    N = node_rows[0].shape[1]
    S = site_rtt.shape[1]
    ptrs = [t.data_ptr() for t in (*obs_rows, *node_rows, site_rtt, tick,
                                   interval, *outs)]
    with tk.device_stream(site_rtt) as stream:
        rc = _fn()(*ptrs, B, O, N, S, stream)
    if rc != 0:
        raise RuntimeError(f"ae_sync: CUDA launch failed with error {rc}")
