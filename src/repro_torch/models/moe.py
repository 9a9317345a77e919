"""Mixture-of-Experts MLP (the port of `repro.models.moe`): a router over
the experts padded to a multiple of 16, top-k with renormalized weights,
the Switch load-balance aux loss, and shared experts as a dense SwiGLU
added on top.

On one device the JAX layer runs its dense oracle: its host mesh has a
"model" (expert) axis of 1, so `moe_apply` returns `moe_apply_dense`,
which computes every expert for every token and combines them with the
router's weights.  The port runs the same function on one card, in plain
torch products (the JAX layer reaches no Pallas kernel).  The expert
products run in the activation dtype, SiLU in float32, the combine in
float32, as in JAX.

With an expert ("model") axis above 1, `moe_apply` runs one of JAX's
two expert-parallel forms on DTensors, each rank's body mapped with
`local_map` (torch's `shard_map`):

* ``a2a`` (the sequence divides over the axis): each rank routes its
  own tokens, packs per-destination capacity buffers and exchanges them
  with an all-to-all (forward and return trip), runs its local experts
  as one batched product, and combines locally;
* ``psum`` (decode steps, where it does not): tokens are replicated
  over the axis, each rank computes only its local experts'
  contribution, and one all-reduce of (T, D) combines.

Over-capacity entries drop, as JAX's `mode="drop"` scatters do, without
reading anything on the host: they are parked in a spare row and slot
that are sliced off.

Ties in the router's top-k take the lowest expert ids first, as
`lax.top_k` does: the ids come from a stable descending sort, where
`torch.topk` promises no order among equal values.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, swiglu, upcast


EP_AXIS = "model"             # the expert axis of the mesh
DP_AXES = ("pod", "data")     # the axes the batch shards over


def padded_experts(e: int, multiple: int = 16) -> int:
    return ((e + multiple - 1) // multiple) * multiple


def moe_params(cfg, dtype=torch.bfloat16):
    D, Fe = cfg.d_model, cfg.moe_d_ff
    E = padded_experts(cfg.moe_num_experts)
    p = {
        "pre_norm": ParamSpec((D,), torch.float32, ("unsharded",), "ones"),
        "router": ParamSpec((D, E), torch.float32, ("embed", "experts")),
        "wg": ParamSpec((E, D, Fe), dtype, ("experts", "embed", "expert_mlp")),
        "wu": ParamSpec((E, D, Fe), dtype, ("experts", "embed", "expert_mlp")),
        "wd": ParamSpec((E, Fe, D), dtype, ("experts", "expert_mlp", "embed")),
    }
    if cfg.moe_shared_d_ff:
        Fs = cfg.moe_shared_d_ff
        p["shared_wg"] = ParamSpec((D, Fs), dtype, ("embed", "shared_mlp"))
        p["shared_wu"] = ParamSpec((D, Fs), dtype, ("embed", "shared_mlp"))
        p["shared_wd"] = ParamSpec((Fs, D), dtype, ("shared_mlp", "embed"))
    return p


def _route(x_flat, router, cfg):
    """x_flat: (T,D) -> top-k (weights (T,k) float32, ids (T,k) int64,
    aux loss): the padded experts masked to -1e30, a float32 softmax,
    the k largest (lowest ids first among equals), renormalized."""
    E = cfg.moe_num_experts
    logits = x_flat.to(router.dtype) @ router                # (T, E_pad)
    pad = torch.arange(logits.shape[-1], device=logits.device) >= E
    logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :cfg.moe_top_k], ids[:, :cfg.moe_top_k]
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    # Switch aux loss: E * sum_e f_e * p_e, f_e the share of tokens
    # routed to e (a k-hot row per token: a scatter, where `one_hot`
    # may read the ids on the host)
    frac = torch.zeros_like(probs).scatter_(1, ids, 1.0).mean(dim=0)
    aux = E * torch.sum(frac * probs.mean(dim=0)) / cfg.moe_top_k
    return w, ids, aux


def moe_apply_dense(p, x, cfg):
    """Every expert on every token, masked combine: x (B,S,D) -> (y, aux
    loss).  O(E·T·D·F): every decode step reads every expert."""
    B, S, D = x.shape
    xf = x.reshape(-1, D)
    w, ids, aux = _route(xf, p["router"], cfg)
    E_pad = p["wg"].shape[0]
    comb = torch.zeros((xf.shape[0], E_pad), dtype=w.dtype,
                       device=x.device).scatter_add_(1, ids, w)
    g = torch.matmul(xf, p["wg"])                            # (E, T, F)
    u = torch.matmul(xf, p["wu"])
    h = F.silu(upcast(g)).to(x.dtype) * u
    y_all = torch.matmul(h, p["wd"])                         # (E, T, D)
    y = torch.einsum("etd,te->td", y_all.to(comb.dtype), comb)
    y = y.to(x.dtype).reshape(B, S, D)
    if "shared_wg" in p:
        y = y + swiglu(x, p["shared_wg"], p["shared_wu"], p["shared_wd"])
    return y, aux


def moe_apply(p, x, cfg, mesh=None):
    """The MoE layer: x (B,S,D) -> (y, aux loss).  `mesh` is anything
    with a JAX-style `shape` mapping of axis names to sizes; with none,
    or an expert ("model") axis of 1, this is the dense path, as on the
    JAX host mesh.  Above 1, `mesh` is a `launch.mesh.Mesh` and `x` and
    `p` are DTensors on its DeviceMesh (`_moe_apply_ep`)."""
    if mesh is None or mesh.shape.get(EP_AXIS, 1) == 1:
        return moe_apply_dense(p, x, cfg)
    return _moe_apply_ep(p, x, cfg, mesh)


# --------------------------------------------------------------------- #
# expert parallelism
# --------------------------------------------------------------------- #
def _one_hot(idx, n: int):
    """(N,) ids -> (N, n) int64 one-hot, an id of n a zero row (JAX's
    `one_hot` of an out-of-range id): a scatter into a spare column,
    where `F.one_hot` checks the ids on the host."""
    out = torch.zeros((idx.shape[0], n + 1), dtype=torch.int64,
                      device=idx.device)
    return out.scatter_(1, idx.unsqueeze(1), 1)[:, :n]


def _positions_in_bins(bins_onehot):
    """bins_onehot: (N, M) 0/1 -> position of each row within its bin
    (N,); -1 for a zero row."""
    cum = torch.cumsum(bins_onehot, dim=0) * bins_onehot
    return cum.sum(dim=-1) - 1


def _expert_ffn(wg, wu, wd, xb):
    """Batched per-expert SwiGLU. xb: (E_loc, C, D)."""
    g = torch.matmul(xb, wg)
    u = torch.matmul(xb, wu)
    h = F.silu(upcast(g)).to(xb.dtype) * u
    return torch.matmul(h, wd)


def _scatter_drop(vals, rows, slots, n_rows: int, n_slots: int, fill=0):
    """JAX's `zeros.at[rows, slots].set(vals, mode="drop")` for an
    (n_rows, n_slots, ...) buffer of `fill`, where every dropped entry is
    parked at (n_rows, n_slots): the buffer gets one spare row and one
    spare slot, which are sliced off."""
    buf = torch.full((n_rows + 1, n_slots + 1) + tuple(vals.shape[1:]),
                     fill, dtype=vals.dtype, device=vals.device)
    return buf.index_put((rows, slots), vals)[:n_rows, :n_slots]


def _exchange(x, group):
    from torch.distributed._functional_collectives import (
        all_to_all_single, wait_tensor)
    return wait_tensor(all_to_all_single(x.contiguous(), None, None, group))


class _AllToAll(torch.autograd.Function):
    """JAX's tiled `all_to_all` on axis 0: chunk i of x's rows to rank i,
    the chunks received in rank order.  With equal chunks the backward is
    the same exchange of the cotangent.  (Its own Function over the
    functional collective: the autograd form of the op differs between
    torch releases.)"""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _all_to_all(x, group):
    return _AllToAll.apply(x, group)


class _Psum(torch.autograd.Function):
    """`psum`: the sum over the group.  The result is replicated, and
    each rank's term of it receives the whole (replicated) cotangent, so
    the backward passes it through unchanged, as DTensor's Partial ->
    Replicate redistribution does (funcol's `all_reduce` backward sums
    the cotangents, which would count each of them once per rank)."""

    @staticmethod
    def forward(ctx, x, group):
        from torch.distributed._functional_collectives import (
            all_reduce, wait_tensor)
        return wait_tensor(all_reduce(x.contiguous(), "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def _psum(x, group):
    return _Psum.apply(x, group)


def _moe_local_a2a(x_loc, router, wg, wu, wd, *, cfg, ep: int, group,
                   aux_scale: float = 1.0):
    """Rank-local body, tokens sharded over the expert group (size ep):
    x_loc (B, S_loc, D) -> (out, aux, route), `route` the integer
    routing: top-k ids, positions in the destination bins, kept entries,
    and at the receiving end positions in the expert bins and kept rows."""
    B, S, D = x_loc.shape
    T = B * S
    k = cfg.moe_top_k
    E_loc = wg.shape[0]
    dev = x_loc.device
    xf = x_loc.reshape(T, D)
    w, ids, aux = _route(xf, router, cfg)

    # --- pack per-destination send buffers -------------------------------
    cap = max(int(-(-T * k // ep) * cfg.moe_capacity_factor), 1)
    flat_ids = ids.reshape(T * k)
    dest = flat_ids // E_loc                                  # (T*k,)
    pos = _positions_in_bins(_one_hot(dest, ep))              # rank in dest
    valid = pos < cap
    d_idx = torch.where(valid, dest, ep)
    p_idx = torch.where(valid, pos, cap)
    src = torch.arange(T * k, device=dev) // k                # source token
    send_x = _scatter_drop(xf[src], d_idx, p_idx, ep, cap)
    send_eid = _scatter_drop((flat_ids % E_loc).to(torch.int32), d_idx,
                             p_idx, ep, cap, fill=E_loc)      # E_loc: empty

    # --- exchange, local expert compute, exchange back --------------------
    recv_x = _all_to_all(send_x, group)
    recv_eid = _all_to_all(send_eid, group)

    R = ep * cap
    rx = recv_x.reshape(R, D)
    reid = recv_eid.reshape(R).long()
    cap2 = -(-R // E_loc)
    pos2 = _positions_in_bins(_one_hot(reid, E_loc))
    ok2 = (pos2 < cap2) & (reid < E_loc)
    e_idx = torch.where(ok2, reid, E_loc)
    q_idx = torch.where(ok2, pos2, cap2)
    buf = _expert_ffn(wg, wu, wd, _scatter_drop(rx, e_idx, q_idx, E_loc,
                                                cap2))
    y = buf[torch.where(ok2, reid, 0), torch.where(ok2, pos2, 0)]
    y = torch.where(ok2[:, None], y, 0)
    y_send = _all_to_all(y.reshape(ep, cap, D), group)

    # --- combine ----------------------------------------------------------
    got = y_send[torch.where(valid, dest, 0), torch.where(valid, pos, 0)]
    got = torch.where(valid[:, None], got, 0).reshape(T, k, D)
    out = torch.einsum("tkd,tk->td", got.to(w.dtype), w).to(x_loc.dtype)
    aux = _psum(aux * (aux_scale / ep), group)
    route = {"ids": ids, "pos": pos, "keep": valid, "pos2": pos2,
             "keep2": ok2}
    return out.reshape(B, S, D), aux, route


def _moe_local_psum(x_rep, router, wg, wu, wd, *, cfg, ep: int, group,
                    aux_scale: float = 1.0):
    """Rank-local body, tokens replicated over the expert group: this
    rank's experts only, then one all-reduce of (T, D)."""
    import torch.distributed as dist

    B, S, D = x_rep.shape
    T = B * S
    k = cfg.moe_top_k
    E_loc = wg.shape[0]
    my = dist.get_rank(group)
    xf = x_rep.reshape(T, D)
    w, ids, aux = _route(xf, router, cfg)
    local = ids // E_loc == my                                # (T,k) mine?
    lids = torch.where(local, ids % E_loc, E_loc).reshape(-1)
    cap = max(int(-(-T * k // max(E_loc, 1)) * cfg.moe_capacity_factor), 1)
    pos = _positions_in_bins(_one_hot(lids, E_loc))
    ok = (pos < cap) & local.reshape(-1)
    src = torch.arange(T * k, device=x_rep.device) // k
    eidx = torch.where(ok, lids, E_loc)                      # park dropped
    pidx = torch.where(ok, pos, cap)
    buf = _expert_ffn(wg, wu, wd, _scatter_drop(xf[src], eidx, pidx, E_loc,
                                                cap))
    y = buf[torch.where(ok, lids, 0), torch.where(ok, pos, 0)]
    y = torch.where(ok[:, None], y, 0).reshape(T, k, D)
    out = torch.einsum("tkd,tk->td", y.to(w.dtype),
                       torch.where(local, w, 0)).to(x_rep.dtype)
    out = _psum(out, group)
    aux = _psum(aux * (aux_scale / ep), group)
    route = {"ids": ids, "pos": pos, "keep": ok}
    return out.reshape(B, S, D), aux, route


def _moe_apply_ep(p, x, cfg, mesh):
    """`moe_apply` on an expert axis above 1: JAX's strategy and layout.
    `a2a` when the sequence divides over the expert axis (x sharded on
    it over the sequence), else `psum` (x replicated on it); the batch
    over the data axes when it divides; the expert weights `Shard(0)` on
    the expert axis and the router replicated, each input redistributed
    to that at entry as `shard_map` does; the shared experts added after.
    aux is the mean over the expert and (batch-sharded) data ranks.  The
    gradient placements say which local gradients are partial sums: the
    router's, the psum form's input's and, with the batch sharded, every
    weight's over the data axes."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.axes import placements

    leaves = [x, p["router"], p["wg"], p["wu"], p["wd"]]
    if not all(isinstance(t, DTensor) for t in leaves):
        raise TypeError("moe_apply on an expert axis above 1 takes x and "
                        "the MoE weights as DTensors on the mesh")
    dm = mesh.device_mesh
    names = tuple(mesh.shape)
    ep = mesh.shape[EP_AXIS]
    dp = tuple(a for a in DP_AXES if a in mesh.shape)
    n_dp = 1
    for a in dp:
        n_dp *= mesh.shape[a]
    B, S, D = x.shape
    bspec = dp if dp and B % n_dp == 0 else None
    if S % ep == 0:
        body, xspec = _moe_local_a2a, (bspec, EP_AXIS, None)
    else:
        body, xspec = _moe_local_psum, (bspec, None, None)
    xpl = placements(xspec, mesh)
    wpl = placements((EP_AXIS, None, None), mesh)
    rep = [Replicate()] * len(names)
    over_dp = [bspec is not None and a in dp and mesh.shape[a] > 1
               for a in names]

    def partial_on(pl, ep_too):
        return [Partial() if (d and not pl[i].is_shard()) or
                (ep_too and a == EP_AXIS) else pl[i]
                for i, (a, d) in enumerate(zip(names, over_dp))]

    aux_pl = [Partial() if d else Replicate() for d in over_dp]
    aux_scale = 1.0 / n_dp if any(over_dp) else 1.0
    fn = local_map(
        lambda *a: body(*a, cfg=cfg, ep=ep, group=mesh.group(EP_AXIS),
                        aux_scale=aux_scale)[:2],
        out_placements=(xpl, aux_pl),
        in_placements=(xpl, rep, wpl, wpl, wpl),
        in_grad_placements=(partial_on(xpl, body is _moe_local_psum),
                            partial_on(rep, True), partial_on(wpl, False),
                            partial_on(wpl, False), partial_on(wpl, False)),
        device_mesh=dm)
    y, aux = fn(x.redistribute(dm, xpl), p["router"].redistribute(dm, rep),
                *(p[n].redistribute(dm, wpl) for n in ("wg", "wu", "wd")))
    if any(over_dp):
        aux = aux.redistribute(dm, rep)
    if "shared_wg" in p:
        # the shared experts' output reduced to x's placements, then
        # sliced to y's, each an explicit redistribution: their backward
        # returns the gradient to x's layout, where the all-to-all
        # form's sequence shards would reach the products' (B*S, D)
        # views, which the card's torch cannot flatten over a sharded dim
        s = swiglu(x, p["shared_wg"], p["shared_wu"], p["shared_wd"])
        y = y + s.redistribute(dm, x.placements).redistribute(
            dm, y.placements)
    return y, aux
