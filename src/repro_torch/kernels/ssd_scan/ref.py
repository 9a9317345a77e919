"""Plain PyTorch twin of the SSD-scan kernel: the Mamba2 chunked scan of
`repro.kernels.ssd_scan.kernel.ssd_scan_kernel`, computed as the Pallas
kernel computes it (not the per-token oracle of
`repro.kernels.ssd_scan.ref.ssd_ref`), one chunk after another and
batched over (batch, head).

Per chunk: cs is the within-chunk cumsum of A·dt; the intra-chunk term
is ((C·Bᵀ) ⊙ L ⊙ dt_j)·x with L[i,j] = exp(cs_i − cs_j) for i ≥ j (the
exponent is masked to −inf above the diagonal before `exp`, so no inf
meets a 0), the weights rounded to x's dtype before the product with x;
the inter-chunk term is exp(cs_i)·C_i·h_prev; the state becomes
h·exp(cs_Q) + xᵀ·(B ⊙ exp(cs_Q − cs)·dt), the B weights rounded to x's
dtype.  Every product and sum in float32.
"""
from __future__ import annotations

import torch


def ssd_scan_ref(x, Bm, Cm, dt, A, *, out_dtype=None):
    """x (B,nc,Q,H,P); Bm, Cm (B,nc,Q,N); dt (B,nc,Q,H); A (H,).
    Returns (y (B,nc,Q,H,P) in `out_dtype` (default x's dtype), final
    state (B,H,P,N) float32)."""
    B, nc, Q, H, P = x.shape
    N = Bm.shape[-1]
    wdt = x.dtype
    out_dtype = out_dtype or wdt
    f32 = torch.float32
    dt, A = dt.to(f32), A.to(f32)
    above = ~torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    h = torch.zeros(B, H, P, N, dtype=f32, device=x.device)
    ys = []
    for c in range(nc):
        xc = x[:, c].to(f32)                                  # (B,Q,H,P)
        Bc, Cc = Bm[:, c].to(f32), Cm[:, c].to(f32)           # (B,Q,N)
        dtc = dt[:, c]                                        # (B,Q,H)
        cs = torch.cumsum(A * dtc, dim=1)                     # (B,Q,H)
        diff = cs[:, :, None, :] - cs[:, None, :, :]          # (B,Qi,Qj,H)
        L = diff.masked_fill(above[None, :, :, None], float("-inf")).exp()
        scores = Cc @ Bc.transpose(1, 2)                      # (B,Qi,Qj)
        w = (scores[..., None] * L * dtc[:, None]).to(wdt).to(f32)
        y_diag = torch.einsum("bijh,bjhp->bihp", w, xc)
        y_off = torch.einsum("bin,bhpn->bihp", Cc, h) * cs.exp()[..., None]
        ys.append((y_diag + y_off).to(out_dtype))
        g = (cs[:, -1:] - cs).exp() * dtc                     # (B,Q,H)
        wB = (Bc[:, :, None, :] * g[..., None]).to(wdt).to(f32)
        s = torch.einsum("bqhp,bqhn->bhpn", xc, wB)
        h = h * cs[:, -1].exp()[..., None, None] + s
    return torch.stack(ys, dim=1), h
