"""ctypes launcher for the SSD-scan CUDA kernel (`csrc/ssd_scan.cu`),
which replaces the Pallas kernel
`repro.kernels.ssd_scan.kernel.ssd_scan_kernel`.

One block per (head, batch row) walks the chunks in order with the
(P,N) float32 state in shared memory; each chunk's rows go 64 at a time
against streamed 64-column tiles, so the (Q,Q) weight matrix is never
held whole.  The design notes are in the CUDA source.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.kernel import DTYPE_CODE

SHAPES = ((16, 16), (16, 128), (64, 16), (64, 128))   # compiled (P, N)
MAX_CHUNK = 256
_FNS = {}


def _fn():
    if "f" not in _FNS:
        _FNS["f"] = build.bind(build.load("ssd_scan"), "ssd_scan", 7, 8)
    return _FNS["f"]


def ssd_scan(x, Bm, Cm, dt, A, y, state) -> None:
    """x, y: (B,nc,Q,H,P); Bm, Cm: (B,nc,Q,N); dt: (B,nc,Q,H); A: (H,);
    state: (B,H,P,N) float32; checked by the op."""
    B, nc, Q, H, P = x.shape
    N = Bm.shape[-1]
    rc = _fn()(x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
               A.data_ptr(), y.data_ptr(), state.data_ptr(), B, nc, Q, H, P,
               N, DTYPE_CODE[x.dtype], DTYPE_CODE[y.dtype],
               torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan: CUDA launch failed with error {rc}")
