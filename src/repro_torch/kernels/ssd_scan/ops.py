"""Public op of the SSD-scan family: the Mamba2 chunked scan that
`models/ssd.py:ssd_apply` runs once per SSD layer per prefill (the JAX
model computes the same function in its own jnp form in
`repro.models.ssd.ssd_apply`; the Pallas kernel
`repro.kernels.ssd_scan` is its TPU form, with the same contract as
this op bar `out_dtype`).

x (B,nc,Q,H,P) and Bm, Cm (B,nc,Q,N) in bfloat16 or float32 (one dtype),
dt (B,nc,Q,H) and A (H,) float32.  A CPU tensor runs the twin in
`ref.py`; a CUDA tensor launches the kernel in `csrc/ssd_scan.cu` after
the operands are checked (contiguous, one device, `kernel.accepts(P, N,
Q)`: P and N in {16, 64, 128}, Q <= 256; x, Bm, Cm 16-byte aligned on
the tensor-core route), else the op raises.  Every call that launches
adds one to `ssd_scan.launches` (however many CUDA kernels its route
issues) and one to `ssd_scan.route_launches[route]` (`kernel.route`:
bf16 with P, N in {64, 128} on the tensor cores, the rest scalar).  A
fake CUDA operand (a dry run) is checked the same way, bar the
alignment, and gets empty outputs, launching nothing; on the card, real
or fake, the call reports `flops` to `kernels.COST_SINKS`.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as tk
from repro_torch.kernels import check, is_fake, on_cpu
from repro_torch.kernels.ssd_scan import kernel as K
from repro_torch.kernels.ssd_scan import ref


def ssd_scan(x, Bm, Cm, dt, A, *, out_dtype=None):
    """The chunked scan from a zero state.  Returns (y (B,nc,Q,H,P) in
    `out_dtype`, x's dtype by default, final state (B,H,P,N) float32)."""
    if out_dtype is not None and out_dtype not in K.DTYPE_CODE:
        raise ValueError(f"ssd_scan: out_dtype {out_dtype} is not "
                         f"bfloat16/float32")
    if on_cpu(x, "ssd_scan"):
        return ref.ssd_scan_ref(x, Bm, Cm, dt, A, out_dtype=out_dtype)
    if x.dim() != 5 or Bm.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (B,nc,Q,H,P) and Bm "
                         f"(B,nc,Q,N), got {tuple(x.shape)} and "
                         f"{tuple(Bm.shape)}")
    B, nc, Q, H, P = x.shape
    N = Bm.shape[-1]
    if x.dtype not in K.DTYPE_CODE:
        raise ValueError(f"ssd_scan: x has dtype {x.dtype}; expected "
                         f"bfloat16 or float32")
    if not K.accepts(P, N, Q):
        raise ValueError(f"ssd_scan: (head_dim, state, chunk) = ({P}, {N}, "
                         f"{Q}) not taken: head_dim and state in {K.DIMS}, "
                         f"chunk at most {K.MAX_CHUNK}")
    dev = x.device
    check("ssd_scan", "x", x, x.dtype, (B, nc, Q, H, P), dev)
    check("ssd_scan", "Bm", Bm, x.dtype, (B, nc, Q, N), dev)
    check("ssd_scan", "Cm", Cm, x.dtype, (B, nc, Q, N), dev)
    check("ssd_scan", "dt", dt, torch.float32, (B, nc, Q, H), dev)
    check("ssd_scan", "A", A, torch.float32, (H,), dev)
    fake = is_fake(x)
    if not fake and K.route(x.dtype, P, N) == "tensor_core":
        for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
            if t.data_ptr() % 16:
                raise ValueError(f"ssd_scan: {name} must be 16-byte aligned")
    y = torch.empty(x.shape, dtype=out_dtype or x.dtype, device=dev)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    if tk.COST_SINKS:
        tk.note_cost("ssd_scan", flops(x.shape, N),
                     (x, Bm, Cm, dt, A, y, state))
    if fake:
        return y, state
    if x.numel() == 0:
        return y, state.zero_()
    r = K.ssd_scan(x, Bm, Cm, dt, A, y, state)
    ssd_scan.launches += 1
    ssd_scan.route_launches[r] += 1
    return y, state


ssd_scan.launches = 0
ssd_scan.route_launches = dict.fromkeys(K.ROUTES, 0)


def flops(x_shape, N: int) -> int:
    """The chunked scan's floating-point work, 2 per multiply-add of its
    products: per chunk C·Bᵀ (Q·Q·N), the intra-chunk output (Q·Q·H·P),
    the inter-chunk output C·h (Q·H·P·N) and the state update xᵀ·B
    (Q·H·P·N)."""
    B, nc, Q, H, P = x_shape
    return 2 * B * nc * Q * (Q * N + Q * H * P + 2 * H * P * N)
