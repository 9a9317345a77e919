"""ctypes launcher for the SSD-scan CUDA kernel (`csrc/ssd_scan.cu`),
which replaces the Pallas kernel
`repro.kernels.ssd_scan.kernel.ssd_scan_kernel`.

Two routes, chosen by `route` from the dtype and (P, N) before the launch
(not a fallback: a failed build or launch raises):

* ``"tensor_core"`` (bfloat16 with P and N in {64, 128}: mamba2-130m,
  jamba-1.5-large): `ssd_scan_tc`, three launches on one stream — chunk
  states x^T.wB per (batch row, chunk, head), an elementwise pass over
  the chunks for each chunk's incoming state, then the outputs per
  (batch row, chunk, head group, 64-row tile) with C.B^T made once per
  block and shared by its `head_group` heads; every product on mma.sync;
* ``"scalar"`` (float32, and bfloat16 with a 16 in P or N, the reduced
  test configs): `ssd_scan`, one block per (head, batch row) walking the
  chunks with scalar FMAs.

`accepts(P, N, Q)` is the shape set both routes take.  The design notes
are in the CUDA source.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as tk
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.flash_attention.kernel import DTYPE_CODE

DIMS = (16, 64, 128)          # compiled P (head_dim) and N (state)
TC_DIMS = (64, 128)
MAX_CHUNK = 256
TILE_ROWS = 64                # output rows per block of the tensor-core route
ROUTES = ("tensor_core", "scalar")
_FNS = {}
_SCRATCH = {}                 # (device, stream) -> (states, cs)


def accepts(P: int, N: int, Q: int) -> bool:
    """Whether the kernels take head_dim P, state N and chunk Q."""
    return P in DIMS and N in DIMS and Q <= MAX_CHUNK


def route(dtype: torch.dtype, P: int, N: int) -> str:
    """The kernel route for a dtype and (P, N) the op accepts."""
    if dtype == torch.bfloat16 and P in TC_DIMS and N in TC_DIMS:
        return "tensor_core"
    return "scalar"


def head_group(B: int, nc: int, Q: int, H: int, sms: int) -> int:
    """Heads per block of the tensor-core route's output kernel, which
    share one C.B^T per (batch row, chunk, 64-row tile): the largest
    divisor of H that still gives every SM a block, B * nc * ceil(Q / 64)
    * H / G >= sms (1 if even one head per block gives fewer).  More
    heads per block share C.B^T more widely and let each warpgroup fetch
    its next head while it works on one; fewer blocks than SMs idles the
    card (tried on an H100 at the serve shape: 4 to 8 heads per block
    beat 2, and 24 lost by far).  Serve shape (B=8, nc=2, Q=256, H=24,
    132 SMs): 8; B=1 with 256 chunks: 24; jamba's 128 heads at B=1, 16
    chunks of 128: 16."""
    blocks = B * nc * -(-Q // TILE_ROWS)
    for G in range(H, 0, -1):
        if H % G == 0 and blocks * (H // G) >= sms:
            return G
    return 1


def _fn(name: str):
    if name not in _FNS:
        lib = build.load("ssd_scan")
        _FNS["scalar"] = build.bind(lib, "ssd_scan", 7, 8)
        _FNS["tensor_core"] = build.bind(lib, "ssd_scan_tc", 9, 8)
    return _FNS[name]


def _scratch(dev, stream, n_states: int, n_cs: int):
    """The chunk states (B,nc,H,P,N) and the cumsums (B,nc,H,Q), float32,
    written before they are read; kept per device and stream so that
    launches on one stream, which run in order, share them, and grown as
    needed."""
    key = (dev.index, stream)
    states, cs = _SCRATCH.get(key, (None, None))
    if states is None or states.numel() < n_states:
        states = torch.empty(n_states, dtype=torch.float32, device=dev)
    if cs is None or cs.numel() < n_cs:
        cs = torch.empty(n_cs, dtype=torch.float32, device=dev)
    _SCRATCH[key] = (states, cs)
    return states, cs


def free_scratch() -> None:
    """Drop the kept scratch, so a long scan's 201 MB does not outlive
    it (the next launch allocates what it needs)."""
    _SCRATCH.clear()


def ssd_scan(x, Bm, Cm, dt, A, y, state) -> str:
    """x, y: (B,nc,Q,H,P); Bm, Cm: (B,nc,Q,N); dt: (B,nc,Q,H); A: (H,);
    state: (B,H,P,N) float32; checked by the op.  Returns the route it
    launched."""
    B, nc, Q, H, P = x.shape
    N = Bm.shape[-1]
    r = route(x.dtype, P, N)
    ptrs = (x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
            A.data_ptr(), y.data_ptr(), state.data_ptr())
    with tk.device_stream(x) as stream:
        if r == "tensor_core":
            G = head_group(B, nc, Q, H, dk.sm_count(x.device))
            states, cs = _scratch(x.device, stream, B * nc * H * P * N,
                                  B * nc * H * Q)
            rc = _fn(r)(*ptrs, states.data_ptr(), cs.data_ptr(), B, nc, Q,
                        H, P, N, G, DTYPE_CODE[y.dtype], stream)
        else:
            rc = _fn(r)(*ptrs, B, nc, Q, H, P, N, DTYPE_CODE[x.dtype],
                        DTYPE_CODE[y.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan ({r} route): CUDA launch failed with "
                           f"error {rc}")
    return r
