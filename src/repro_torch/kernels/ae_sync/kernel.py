"""ctypes launcher for the anti-entropy CUDA kernel (`csrc/ae_sync.cu`),
which replaces the Pallas kernel
`repro.kernels.ae_sync.kernel.ae_sync_kernel`.

One thread per observer slot, one grid row per member; about 28 KB per
member at the 50X rack (O = 550), so the launch bounds it.  The design
notes are in the CUDA source.
"""
from __future__ import annotations

import torch

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
    rc = _fn()(*ptrs, B, O, N, S,
               torch.cuda.current_stream(site_rtt.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ae_sync: CUDA launch failed with error {rc}")
