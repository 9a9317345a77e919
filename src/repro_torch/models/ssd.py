"""Mamba2-style SSD (state-space duality) block (the port of
`repro.models.ssd`): per-head scalar decay ``a_t = exp(-softplus(dt) *
exp(A_log))``, rank-1 state updates ``h_t = a_t h_{t-1} + dt_t (B_t ⊗
x_t)`` with shared (G=1) B/C projections, computed chunk-parallel in
prefill and one token at a time in decode (arXiv:2405.21060).

`ssd_apply` (prefill) runs the chunked scan through the `ssd_scan` op,
so on the card it is the hand-written kernel (`kernels/csrc/ssd_scan.cu`)
and on the CPU its plain twin.  The op accumulates both chunk products
in float32, as the Pallas kernel does, where the JAX `ssd_apply` rounds
its intra-chunk output and chunk states to the activation dtype; in
float32 the two agree to rounding, in bfloat16 by one bf16 rounding.
`ssd_chunked` (training) is the JAX `ssd_apply` itself in plain torch
ops under autograd, its roundings to the activation dtype included: the
JAX package trains through that jnp code, not through a kernel.
The JAX forms' `unroll` (a Python loop over chunks for the roofline
path) is dropped.  On a mesh (DESIGN.md §4) `ssd_apply`'s `cn` shards
x and dt over the SSD heads (JAX's constraint sites; the third, on the
within-chunk cumsum, is inside the kernel), the scan runs on each
rank's local heads with B and C whole, and `_gate_out`'s norm over the
whole inner dimension, sharded over "model" with the heads, takes its
mean square through DTensor's reduction over that axis.  `ssd_chunked`
does the same in training, its recurrence on the rank's heads under
autograd (B's and C's gradients partial sums over the head shards).

Parameters keep the JAX names and shapes.  The decode state is the JAX
cache, {"ssm" (B,H,P,N) float32, "conv_x" (B,W-1,DI), "conv_B",
"conv_C" (B,W-1,N)} in the activation dtype; `ssd_decode` updates it in
place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.common import ParamSpec, assign, rms_norm
from repro_torch.sharding.axes import (even_dim, even_grad, is_dtensor,
                                       split_dim)


def ssd_params(cfg, dtype=torch.bfloat16):
    D = cfg.d_model
    DI = cfg.d_inner
    N = cfg.ssm_state
    H = cfg.ssm_heads
    W = cfg.ssm_conv
    f32 = torch.float32
    return {
        "wz": ParamSpec((D, DI), dtype, ("embed", "ssm_inner")),
        "wx": ParamSpec((D, DI), dtype, ("embed", "ssm_inner")),
        "wB": ParamSpec((D, N), dtype, ("embed", "ssm_state")),
        "wC": ParamSpec((D, N), dtype, ("embed", "ssm_state")),
        "wdt": ParamSpec((D, H), dtype, ("embed", "ssm_heads")),
        "conv_x": ParamSpec((W, DI), dtype, ("conv", "ssm_inner"), "normal",
                            0.5),
        "conv_B": ParamSpec((W, N), dtype, ("conv", "ssm_state"), "normal",
                            0.5),
        "conv_C": ParamSpec((W, N), dtype, ("conv", "ssm_state"), "normal",
                            0.5),
        "A_log": ParamSpec((H,), f32, ("ssm_heads",), "zeros"),
        "D_skip": ParamSpec((H,), f32, ("ssm_heads",), "ones"),
        "dt_bias": ParamSpec((H,), f32, ("ssm_heads",), "zeros"),
        "gate_norm": ParamSpec((DI,), f32, ("ssm_inner",), "ones"),
        "out_proj": ParamSpec((DI, D), dtype, ("ssm_inner", "embed")),
        "pre_norm": ParamSpec((D,), f32, ("unsharded",), "ones"),
    }


def _pad_time(t, before: int, after: int):
    """Zeros before and after dim 1 of a (B,S,...) tensor.  A DTensor is
    padded shard by shard (its dim 1 made whole first): the card's torch
    has no working DTensor rule for `pad`."""
    pad = (0, 0) * (t.dim() - 2) + (before, after)
    if not is_dtensor(t):
        return F.pad(t, pad)
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding.axes import from_local
    pl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
          for p in t.placements]
    t = t.redistribute(t.device_mesh, pl)
    shape = (t.shape[0], t.shape[1] + before + after) + tuple(t.shape[2:])
    return from_local(F.pad(t.to_local(), pad), pl, t.device_mesh, shape)


def _causal_conv(x, w, state=None):
    """Depthwise causal conv. x:(B,S,C), w:(W,C). state:(B,W-1,C) or None
    (zero padding).  Returns (y, new_state), new_state the last W-1
    inputs."""
    W = w.shape[0]
    if state is None:
        xp = _pad_time(x, W - 1, 0)
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(W))
    return y, xp[:, xp.shape[1] - (W - 1):, :]


def _project(p, x):
    z = x @ p["wz"]
    xs = x @ p["wx"]
    Bm = x @ p["wB"]
    Cm = x @ p["wC"]
    dt = F.softplus((x @ p["wdt"]).float() + p["dt_bias"])
    return z, xs, Bm, Cm, dt


def _silu(t, dtype):
    return F.silu(t.float()).to(dtype)


def _gate_out(p, y, z, x_dtype, cfg):
    """rms_norm on gate_norm, the silu(z) gate and out_proj (y float32)."""
    y = rms_norm(y, p["gate_norm"], cfg.norm_eps)
    y = y * _silu(z, y.dtype)
    return y.to(x_dtype) @ p["out_proj"]


def _scan(xh, Bc, Cc, dtc, A):
    """The `ssd_scan` op, y in float32; with DTensor operands on each
    rank's local heads (x and dt as placed, B and C whole over the head
    axes), y placed as x and the state (B,H,P,N) over the same axes."""
    if not is_dtensor(xh):
        return ssd_scan(xh, Bc.contiguous(), Cc.contiguous(),
                        dtc.contiguous(), A, out_dtype=torch.float32)
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding.axes import from_local
    dm, xp = xh.device_mesh, xh.placements
    bc = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in xp]
    hp = [Shard(0) if isinstance(p, Shard) and p.dim == 3 else Replicate()
          for p in xp]
    y, h = ssd_scan(xh.to_local().contiguous(),
                    Bc.redistribute(dm, bc).to_local().contiguous(),
                    Cc.redistribute(dm, bc).to_local().contiguous(),
                    dtc.redistribute(dm, xp[:]).to_local().contiguous(),
                    A.redistribute(dm, hp).to_local().contiguous(),
                    out_dtype=torch.float32)
    sp = [Shard(1) if isinstance(p, Shard) and p.dim == 3 else p for p in xp]
    B, _, _, H, P = xh.shape
    return (from_local(y.contiguous(), xp, dm, xh.shape),
            from_local(h.contiguous(), sp, dm, (B, H, P, h.shape[-1])))


def ssd_apply(p, x, cfg, cn=None):
    """Prefill path from a zero state. x:(B,S,D) -> (y:(B,S,D), final
    state {"ssm", "conv_x", "conv_B", "conv_C"}).  A tail that does not
    fill a chunk is padded after the projection with dt = 0, so the
    padded steps are exact no-ops and the state is the state at S.
    `cn`, on a mesh, places x and dt over the SSD heads."""
    if cn is None:
        cn = lambda t, *a: t
    B, S, _ = x.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    Q = min(cfg.ssm_chunk, S)
    S_pad = -(-S // Q) * Q

    z, xs, Bm, Cm, dt = _project(p, x)
    xs, conv_x_st = _causal_conv(xs, p["conv_x"])
    Bm, conv_B_st = _causal_conv(Bm, p["conv_B"])
    Cm, conv_C_st = _causal_conv(Cm, p["conv_C"])
    xs, Bm, Cm = (_silu(t, x.dtype) for t in (xs, Bm, Cm))
    if S_pad != S:
        xs, Bm, Cm, dt = (_pad_time(t, 0, S_pad - S)
                          for t in (xs, Bm, Cm, dt))
    nc = S_pad // Q

    xh = cn(split_dim(xs, 2, (H, P)).reshape(B, nc, Q, H, P), "batch",
            None, None, "ssm_heads", None)
    dtc = cn(dt.reshape(B, nc, Q, H), "batch", None, None, "ssm_heads")
    A = -torch.exp(p["A_log"])
    y, h_last = _scan(xh, Bm.reshape(B, nc, Q, N), Cm.reshape(B, nc, Q, N),
                      dtc, A)
    y = y + xh.float() * p["D_skip"][:, None]
    y = y.reshape(B, S_pad, H * P)[:, :S]
    out = _gate_out(p, y, z, x.dtype, cfg)
    state = {"ssm": h_last, "conv_x": conv_x_st.to(x.dtype),
             "conv_B": conv_B_st.to(x.dtype),
             "conv_C": conv_C_st.to(x.dtype)}
    return out, state


def ssd_chunked(p, x, cfg, cn=None):
    """Training path, differentiable: the JAX `ssd_apply` op for op.
    x:(B,S,D) -> y:(B,S,D) (training keeps no state, so none is
    returned).  The intra-chunk weights and the chunk-state weights round
    to x's dtype before their products, as in JAX; the carries and the
    inter-chunk term stay float32.  On a mesh `cn` places x and dt over
    the SSD heads, as in `ssd_apply`, and the scan runs on each rank's
    local heads and batch rows with B and C whole (`_chunked_local`)."""
    if cn is None:
        cn = lambda t, *a: t
    B, S, _ = x.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    Q = min(cfg.ssm_chunk, S)
    S_pad = -(-S // Q) * Q

    z, xs, Bm, Cm, dt = _project(p, x)
    xs, Bm, Cm = (_silu(_causal_conv(t, p[k])[0], x.dtype)
                  for t, k in ((xs, "conv_x"), (Bm, "conv_B"),
                               (Cm, "conv_C")))
    if S_pad != S:
        # pad the tail after the projection with dt = 0: padded steps are
        # exact no-ops in the recurrence
        xs, Bm, Cm, dt = (_pad_time(t, 0, S_pad - S)
                          for t in (xs, Bm, Cm, dt))
    nc = S_pad // Q

    xh = split_dim(xs, 2, (H, P)).reshape(B, nc, Q, H, P)
    Bc = Bm.reshape(B, nc, Q, N)
    Cc = Cm.reshape(B, nc, Q, N)
    dtc = dt.reshape(B, nc, Q, H)
    if is_dtensor(xh):
        y = _chunked_local(xh, Bc, Cc, dtc, p["A_log"], p["D_skip"], cn)
    else:
        y = _chunked_scan(xh, Bc, Cc, dtc, p["A_log"], p["D_skip"])
    y = even_grad(y.reshape(B, S_pad, H * P), 2, H)[:, :S]
    return _gate_out(p, y, z, x.dtype, cfg)


def _chunked_local(xh, Bc, Cc, dtc, A_log, D_skip, cn):
    """`_chunked_scan` on this rank's heads and batch rows of DTensor
    operands: x and dt placed by `cn` over the SSD heads (JAX's
    constraint sites), B and C whole over the head axes, A_log and D_skip
    on the rank's heads; y (B,nc,Q,H,P) comes out placed as x."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding.axes import from_local, local_for
    xh = cn(xh, "batch", None, None, "ssm_heads", None)
    dtc = cn(dtc, "batch", None, None, "ssm_heads")
    xp = xh.placements
    bc = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in xp]
    hp = [Shard(0) if isinstance(p, Shard) and p.dim == 3 else Replicate()
          for p in xp]
    y = _chunked_scan(local_for(xh, xp, xp), local_for(Bc, bc, xp),
                      local_for(Cc, bc, xp), local_for(dtc, xp[:], xp),
                      local_for(A_log, hp, xp), local_for(D_skip, hp, xp))
    return from_local(y.contiguous(), xp, xh.device_mesh, xh.shape)


def _chunked_scan(xh, Bc, Cc, dtc, A_log, D_skip):
    """The chunked SSD recurrence of the training path: x (B,nc,Q,H,P),
    B/C (B,nc,Q,N), dt (B,nc,Q,H) -> y (B,nc,Q,H,P) float32 with the D
    skip added."""
    B, nc, Q, H, P = xh.shape
    N = Bc.shape[-1]
    loga = -torch.exp(A_log) * dtc                             # f32
    cs = torch.cumsum(loga, dim=2)                             # within-chunk

    # intra-chunk term: step j's contribution to output i >= j
    Lij = cs[:, :, :, None, :] - cs[:, :, None, :, :]          # (B,nc,Q,Q,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    Ldec = torch.where(tri[None, None, :, :, None], torch.exp(Lij), 0.0)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)           # (B,nc,Q,Q)
    w_ij = scores[..., None] * Ldec * dtc[:, :, None, :, :]
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", w_ij.to(xh.dtype), xh)

    # chunk summary states: s_c = sum_j exp(cs_Q - cs_j) dt_j B_j (x) x_j
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)            # (B,nc,Q,H)
    wB = Bc[..., None, :] * (decay_to_end * dtc)[..., :, None]
    s_chunk = torch.einsum("bcqhn,bcqhp->bchpn", wB.to(xh.dtype), xh)

    # inter-chunk recurrence over the running state
    chunk_decay = torch.exp(cs[:, :, -1, :])                   # (B,nc,H)
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device)
    hs = []
    for c in range(nc):
        hs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + s_chunk[:, c].float()
    h_prev = torch.stack(hs, dim=1)                            # (B,nc,H,P,N)

    # off-diagonal term: y_off_i = exp(cs_i) * C_i . h_prev
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cc.float(), h_prev)
    y_off = y_off * torch.exp(cs)[..., None]
    y = y_diag.float() + y_off
    return y + xh.float() * D_skip[:, None]


def ssd_init_cache(cfg, batch: int, dtype=torch.bfloat16, device=None):
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    W, DI = cfg.ssm_conv, cfg.d_inner
    z = lambda *s, dt=dtype: torch.zeros(s, dtype=dt, device=device)
    return {"ssm": z(batch, H, P, N, dt=torch.float32),
            "conv_x": z(batch, W - 1, DI), "conv_B": z(batch, W - 1, N),
            "conv_C": z(batch, W - 1, N)}


def ssd_decode(p, x, cache, cfg):
    """Single-token step in plain torch. x:(B,1,D); `cache` as from
    `ssd_init_cache`, updated in place.  Returns (y (B,1,D), cache)."""
    B = x.shape[0]
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    z, xs, Bm, Cm, dt = _project(p, x)
    xs, cx = _causal_conv(xs, p["conv_x"], cache["conv_x"])
    Bm, cb = _causal_conv(Bm, p["conv_B"], cache["conv_B"])
    Cm, cc = _causal_conv(Cm, p["conv_C"], cache["conv_C"])
    xs = F.silu(xs.float())[:, 0]                          # (B,DI)
    Bm = F.silu(Bm.float())[:, 0]                          # (B,N)
    Cm = F.silu(Cm.float())[:, 0]
    dt = even_dim(dt[:, 0], 1, H)                          # (B,H)
    xh = split_dim(xs, 1, (H, P))
    a = torch.exp(-torch.exp(p["A_log"]) * dt)             # (B,H)
    upd = (dt[..., None] * xh)[..., None] * Bm[:, None, None, :]
    h = cache["ssm"] * a[:, :, None, None] + upd           # (B,H,P,N)
    y = torch.einsum("bhpn,bn->bhp", h, Cm)
    y = y + xh * p["D_skip"][None, :, None]
    out = _gate_out(p, y.reshape(B, 1, H * P), z, x.dtype, cfg)
    assign(cache["ssm"], h)
    assign(cache["conv_x"], cx)
    assign(cache["conv_B"], cb)
    assign(cache["conv_C"], cc)
    return out, cache


def ssd_reference(p, x, cfg):
    """Sequential per-token oracle (O(S) decode steps) for tests."""
    B, S, _ = x.shape
    cache = ssd_init_cache(cfg, B, x.dtype, x.device)
    ys = []
    for t in range(S):
        y, cache = ssd_decode(p, x[:, t:t + 1], cache, cfg)
        ys.append(y)
    return torch.cat(ys, dim=1)
