"""The LM stack (the port of `repro.models.lm`): attention or SSD mixers
(dense, mamba2, the Jamba hybrid), SwiGLU or MoE MLPs, gated
cross-attention to image embeddings (llama-3.2-vision) or to an
encoder's output (seamless-m4t), a non-causal encoder stack, a tied or
separate head, prefill and single-token decode with per-layer caches
(DESIGN.md §3).

Parameters keep the JAX package's names and shapes — wq (D,H,hd), wo
(H,hd,D), the `blocks/r{r}` groups — so JAX weights carry across
(`from_numpy`).  Where the JAX stack scans the G layers of each period
position, `LM` holds them unstacked, layer g*P + r at `blocks[g*P + r]`,
and `run_stack` is a Python loop.  Caches keep the JAX tree and layout,
{"r{r}": {"self": {"k", "v"}}} with leaves (G,B,T,KV,hd) for attention
and {"r{r}": {"ssm": {"ssm", "conv_x", "conv_B", "conv_C"}}} with leaves
(G,B,...) for SSD layers, allocated at capacity once and written in
place by prefill and decode.  A cross-attention layer adds {"cross":
{"k", "v", "len"}}: K/V (G,B,T,KV,hd) with T the image tokens, or the
capacity for an encoder's output, filled by prefill from the raw context
projections and read, never written, by decode.  Public functions keep
the JAX layout (B,S,H,hd).

The context comes in as `img_embeds` (B,T,D) or as `frames` (B,S,D),
which `encode` runs through the encoder (non-causal attention + SwiGLU
blocks, rope positions 0..S-1, a final norm), as in JAX.  The encoder
and the cross-attention prefill are non-causal and plain torch ops
(`attention.full_attention`, or `chunked_attention` past S·T = 2**22);
the decoder's causal self-attention and every decode attention, the
cross layers' included, run on the kernels.  MoE layers run
`moe.moe_apply` (the dense path on one card, expert-parallel on a mesh)
and add their Switch aux loss, which `loss_fn` weighs by 0.01.

On a mesh (`forward(..., mesh=)`; DESIGN.md §4) the parameters
and caches are DTensors (`sharding.axes.shard_lm`, `alloc_caches(...,
mesh=)`), the activations follow DTensor's sharding propagation, and
`cn` (`sharding.axes.make_constrainer`) redistributes them at JAX's
constraint sites; the kernels, the training attention, the non-causal
attention and the training SSD scan run on each rank's shard
(`models/attention.py`, `models/ssd.py`).  Each rank writes the cache
positions it holds: prefill from the K/V gathered over the sequence,
decode at cache_len[b] on the rank that owns it; a cross cache keeps its
sequence whole and its KV heads sharded as the weights' heads, so the
cross decode runs on the rank's heads.  The context enters as a tensor
every rank holds whole and is placed at JAX's constraint site (frames
as ("batch", "seq", "embed_tp"), image embeddings as ("batch",
"img_seq", "embed_tp")).  With `runcfg.zero3_at_use` on a mesh with a
"data" axis each layer's weights are redistributed from their storage
placements to those of `sharding.axes.use_rules` where the layer runs
(`_at_use`: an all-gather over "data"), inside the recomputed region
under remat, and the backward reduce-scatters their gradients back to
the storage placements, as JAX's constraint does
(`repro/models/lm.py:257-262`).  `loss_fn` on a mesh takes the
vocabulary-parallel cross entropy of the vocab-sharded logits.

Training (`forward(mode="train")`, `loss_fn`) runs the same layers with
no caches under autograd, attention through
`attention.causal_blocked_attention` and SSD layers through
`ssd.ssd_chunked` (the JAX training forms; no kernel has a backward);
`runcfg.remat` recomputes each layer period (or each block, with
`remat_policy="block"`) in the backward pass through
`torch.utils.checkpoint`, as `jax.checkpoint` does in JAX.  `leaf_names`,
`to_tree` and `from_tree` map the unstacked parameters (and anything
keyed by their names: gradients, AdamW moments) to and from the JAX
tree with stacked blocks, the layout of a checkpoint.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import RunConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.common import (DTYPES, ParamSpec, assign,
                                       cross_entropy, empty_tree, init_tree,
                                       rms_norm, swiglu, tree_items,
                                       tree_map, zeros_tree)
from repro_torch.sharding.axes import even_grad, is_dtensor


class LayerKind(NamedTuple):
    mixer: str          # "attn" | "ssd"
    ffn: str            # "mlp" | "moe" | "none"
    cross: bool = False


ENCODER_KIND = LayerKind("attn", "mlp", False)


def layer_kinds(cfg) -> Tuple[LayerKind, ...]:
    P = cfg.layer_period
    kinds = []
    for r in range(P):
        mixer = "attn" if cfg.is_attn_layer(r) else "ssd"
        ffn = "moe" if cfg.is_moe_layer(r) else ("mlp" if cfg.d_ff else "none")
        kinds.append(LayerKind(mixer, ffn, cfg.is_cross_attn_layer(r)))
    return tuple(kinds)


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------

def mlp_params(cfg, dtype):
    D, F = cfg.d_model, cfg.d_ff
    return {
        "wg": ParamSpec((D, F), dtype, ("embed", "mlp")),
        "wu": ParamSpec((D, F), dtype, ("embed", "mlp")),
        "wd": ParamSpec((F, D), dtype, ("mlp", "embed")),
        "pre_norm": ParamSpec((D,), torch.float32, ("unsharded",), "ones"),
    }


def block_params(cfg, kind: LayerKind, dtype):
    p: Dict[str, Any] = {}
    if kind.mixer == "attn":
        p["attn"] = attn_mod.attention_params(cfg, dtype=dtype)
    else:
        p["ssd"] = ssd_mod.ssd_params(cfg, dtype)
    if kind.cross:
        p["xattn"] = attn_mod.attention_params(cfg, cross=True, dtype=dtype)
        p["xattn_gate"] = ParamSpec((1,), torch.float32, ("unsharded",),
                                    "zeros")
    if kind.ffn == "mlp":
        p["mlp"] = mlp_params(cfg, dtype)
    elif kind.ffn == "moe":
        p["moe"] = moe_mod.moe_params(cfg, dtype)
    return p


def _stack(tree, n: int):
    return tree_map(lambda ps: ParamSpec((n,) + ps.shape, ps.dtype,
                                         ("layers",) + ps.axes, ps.init,
                                         ps.scale), tree)


def build_param_specs(cfg, dtype=torch.bfloat16):
    D, Vp = cfg.d_model, cfg.padded_vocab
    kinds = layer_kinds(cfg)
    P = len(kinds)
    assert cfg.num_layers % P == 0, (cfg.name, cfg.num_layers, P)
    G = cfg.num_layers // P
    params: Dict[str, Any] = {
        "embed": ParamSpec((Vp, D), dtype, ("vocab", "embed"), "normal"),
        "final_norm": ParamSpec((D,), torch.float32, ("unsharded",), "ones"),
        "blocks": {f"r{r}": _stack(block_params(cfg, k, dtype), G)
                   for r, k in enumerate(kinds)},
    }
    if not cfg.tie_embeddings:
        params["head"] = ParamSpec((D, Vp), dtype, ("embed", "vocab"))
    if cfg.encoder_layers:
        params["encoder"] = {
            "blocks": {"r0": _stack(block_params(cfg, ENCODER_KIND, dtype),
                                    cfg.encoder_layers)},
            "final_norm": ParamSpec((D,), torch.float32, ("unsharded",),
                                    "ones"),
        }
    return params


def cache_specs(cfg, batch: int, cache_cap: int, dtype=torch.bfloat16):
    """ParamSpec tree for decode caches (leading G per position): K/V at
    capacity `cache_cap` for attention layers; for SSD layers the state,
    float32 whatever `dtype`, and the conv tails in `dtype`; for cross
    layers K/V over the image tokens, or over `cache_cap` for an
    encoder's output, and the context length."""
    kinds = layer_kinds(cfg)
    G = cfg.num_layers // len(kinds)
    KV, hd = cfg.num_kv_heads, cfg.head_dim

    def spec(shape, axes, dt=dtype):
        return ParamSpec((G, batch) + shape, dt, ("layers", "batch") + axes,
                         "zeros")

    out = {}
    for r, kind in enumerate(kinds):
        c: Dict[str, Any] = {}
        if kind.mixer == "attn":
            kv = spec((cache_cap, KV, hd), ("kv_seq", "kv_heads", "head_dim"))
            c["self"] = {"k": kv, "v": kv}
        else:
            H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
            W, DI = cfg.ssm_conv, cfg.d_inner
            c["ssm"] = {
                "ssm": spec((H, P, N), ("ssm_heads", None, "ssm_state"),
                            torch.float32),
                "conv_x": spec((W - 1, DI), (None, "ssm_inner")),
                "conv_B": spec((W - 1, N), (None, "ssm_state")),
                "conv_C": spec((W - 1, N), (None, "ssm_state"))}
        if kind.cross:
            # an encoder's output is as long as the frames, so its cache
            # takes the capacity; JAX's rule (`num_image_tokens or
            # cache_cap`) gives the same T for every shipped config, but
            # `reduced()` sets 8 image tokens on the encoder-decoder too
            T = (cache_cap if cfg.encoder_layers
                 else cfg.num_image_tokens or cache_cap)
            kv = spec((T, KV, hd), (None, "kv_heads", "head_dim"))
            c["cross"] = {"k": kv, "v": kv,
                          "len": spec((), (), torch.int32)}
        out[f"r{r}"] = c
    return out


def alloc_caches(cfg, batch: int, cache_cap: int, dtype, device, *,
                 mesh=None, rules=None):
    """Zeroed decode caches at capacity, allocated once; prefill and
    decode then write into them in place.  On a mesh (of more than one
    rank) each leaf is a DTensor placed as `tree_shardings` places
    `cache_specs` under `rules`, each rank allocating its own shard:
    under the decode profile K/V shard on `kv_seq` and SSD states on
    `ssm_heads`."""
    specs = cache_specs(cfg, batch, cache_cap, dtype)
    if not on_mesh(mesh):
        return zeros_tree(specs, device)
    from repro_torch.sharding.axes import (from_local, local_part,
                                           placements, tree_shardings)
    shard = tree_shardings(specs, rules, mesh)
    out: Dict[str, Any] = {}
    for path, p in tree_items(specs):
        spec = shard
        for k in path:
            spec = spec[k]
        pl = placements(spec, mesh)
        local = local_part(torch.empty(p.shape, device="meta"), pl, mesh)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = from_local(
            torch.zeros(local.shape, dtype=p.dtype, device=device), pl,
            mesh, p.shape)
    return out


def on_mesh(mesh) -> bool:
    """A mesh of more than one rank (a 1 x 1 host mesh is one card)."""
    return mesh is not None and getattr(mesh, "device_mesh", None) is not None


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One layer: its mixer (`attn` or `ssd`), its MLP (`mlp` or `moe`)
    and, for a cross layer, `xattn` and the (1,) `xattn_gate`; each part
    maps the JAX names to parameters, an absent part is None."""

    PARTS = ("attn", "ssd", "xattn", "mlp", "moe")

    def __init__(self, kind: LayerKind, tree):
        super().__init__()
        self.kind = kind
        for part in self.PARTS:
            setattr(self, part, nn.ParameterDict(tree[part])
                    if part in tree else None)
        self.xattn_gate = (nn.Parameter(tree["xattn_gate"])
                           if "xattn_gate" in tree else None)


class Encoder(nn.Module):
    """The encoder stack: `blocks`, one attention + SwiGLU `Block` per
    encoder layer, and `final_norm`."""

    def __init__(self, tree, n_layers: int):
        super().__init__()
        self.blocks = nn.ModuleList(
            Block(ENCODER_KIND, tree_map(lambda a, g=g: a[g],
                                         tree["blocks"]["r0"]))
            for g in range(n_layers))
        self.final_norm = nn.Parameter(tree["final_norm"])


class LM(nn.Module):
    """The model: `embed` (Vp,D), `final_norm`, `head` (D,Vp) when the
    embeddings are not tied, `blocks`, one `Block` per layer, and, for
    an encoder-decoder config, `encoder`.  Frozen (no parameter takes a
    gradient) unless `trainable`, which a training run asks for; serving
    keeps it frozen.  Applied by `forward`."""

    def __init__(self, cfg, tree, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.kinds = layer_kinds(cfg)
        P = len(self.kinds)
        G = cfg.num_layers // P
        self.embed = nn.Parameter(tree["embed"])
        self.final_norm = nn.Parameter(tree["final_norm"])
        self.head = nn.Parameter(tree["head"]) if "head" in tree else None
        self.blocks = nn.ModuleList(
            Block(self.kinds[r],
                  tree_map(lambda a, g=g: a[g], tree["blocks"][f"r{r}"]))
            for g in range(G) for r in range(P))
        self.encoder = (Encoder(tree["encoder"], cfg.encoder_layers)
                        if "encoder" in tree else None)
        # the layer index a block runs at (the taps of `launch/taps.py`
        # key a layer call by it)
        for i, blk in enumerate(self.blocks):
            blk.index = i
        for i, blk in enumerate(self.encoder.blocks if self.encoder else ()):
            blk.index = i
        self.requires_grad_(trainable)


def init_lm(cfg, runcfg, *, seed: int = 0, device=None,
            trainable: bool = False) -> LM:
    """Random weights from `seed`, made on `device` by `init_tree`;
    `device` None means the card (`repro_torch.resolve_device`)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    specs = build_param_specs(cfg, DTYPES[runcfg.param_dtype])
    return LM(cfg, init_tree(gen, specs), trainable)


def empty_lm(cfg, runcfg, device=None, *, trainable: bool = False,
             mesh=None) -> LM:
    """The model with uninitialised weights (`common.empty_tree`), for
    what needs its shapes only: a dry run builds it under
    `FakeTensorMode`, where it holds no memory.  On a mesh every
    parameter is then placed as `from_numpy` places it.  `device` None
    means the card."""
    device = resolve_device(device)
    specs = build_param_specs(cfg, DTYPES[runcfg.param_dtype])
    model = LM(cfg, empty_tree(specs, device), trainable)
    if on_mesh(mesh):
        from repro_torch.sharding.axes import resolve_rules, shard_lm
        shard_lm(model, resolve_rules(cfg, runcfg.sharding_profile), mesh)
    return model


def from_numpy(params_np, cfg, runcfg, device=None,
               trainable: bool = False, *, mesh=None) -> LM:
    """The JAX parameter tree (`repro.models.common.init_tree` of
    `param_specs`) as numpy arrays -> the port's `LM` on `device`.
    bfloat16 leaves come as their uint16 bits (`a.view(np.uint16)`),
    since `torch.from_numpy` takes no bfloat16.  Every leaf is copied
    (JAX's numpy views are read-only).  The model-side
    counterpart of `core/state.from_numpy`.  `device` None means the
    card, as for `init_lm`.  On a mesh every parameter is then placed as
    a DTensor under `runcfg.sharding_profile`'s rules
    (`sharding.axes.shard_lm`)."""
    device = resolve_device(device)
    specs = build_param_specs(cfg, DTYPES[runcfg.param_dtype])
    tree: Dict[str, Any] = {}
    for path, spec in tree_items(specs):
        node = params_np
        for k in path:
            node = node[k]
        a = np.asarray(node)
        if tuple(a.shape) != tuple(spec.shape):
            raise ValueError(f"{'/'.join(path)}: shape {a.shape}, expected "
                             f"{spec.shape}")
        if spec.dtype == torch.bfloat16:
            if a.dtype != np.uint16:
                raise ValueError(f"{'/'.join(path)}: a bfloat16 leaf must "
                                 f"come as uint16 bits, got {a.dtype}")
            t = torch.from_numpy(np.array(a)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a)).to(spec.dtype)
        out = tree
        for k in path[:-1]:
            out = out.setdefault(k, {})
        out[path[-1]] = t.to(device)
    model = LM(cfg, tree, trainable)
    if on_mesh(mesh):
        from repro_torch.sharding.axes import resolve_rules, shard_lm
        shard_lm(model, resolve_rules(cfg, runcfg.sharding_profile), mesh)
    return model


def _stacked(path: Tuple[str, ...]) -> bool:
    """A leaf stacked on a leading layer axis in the JAX tree."""
    return path[0] == "blocks" or path[:2] == ("encoder", "blocks")


def leaf_names(model: LM) -> List[Tuple[Tuple[str, ...], Tuple[str, ...]]]:
    """(JAX path, parameter names): every leaf of the JAX parameter tree
    in flatten order, with the `named_parameters` names that hold it —
    its own name for an unstacked leaf ("embed", "encoder.final_norm"),
    layer g*P + r's for g = 0..G-1 for a stacked block leaf ("blocks",
    "r{r}", part[, name]), and encoder layer g's for ("encoder",
    "blocks", "r0", part, name)."""
    P = len(model.kinds)
    G = model.cfg.num_layers // P
    out = []
    for path, _ in tree_items(build_param_specs(model.cfg)):
        if path[0] == "blocks":
            r = int(path[1][1:])
            rest = ".".join(path[2:])
            names = tuple(f"blocks.{g * P + r}.{rest}" for g in range(G))
        elif _stacked(path):
            rest = ".".join(path[3:])
            names = tuple(f"encoder.blocks.{g}.{rest}"
                          for g in range(model.cfg.encoder_layers))
        else:
            names = (".".join(path),)
        out.append((path, names))
    return out


def _shift_placements(pl, by: int):
    """DTensor placements with each Shard's dim moved by `by` (a leading
    layer axis stacked on, or taken off)."""
    from torch.distributed.tensor import Shard
    return [Shard(p.dim + by) if isinstance(p, Shard) else p for p in pl]


def _stack_layers(ts):
    """The layer leaves `ts` stacked on a leading axis (a copy); DTensors
    as the DTensor whose shard is the stack of their shards."""
    if not is_dtensor(ts[0]):
        return torch.stack(ts)
    from repro_torch.sharding.axes import from_local
    t = ts[0]
    return from_local(torch.stack([x.to_local() for x in ts]),
                      _shift_placements(t.placements, 1), t.device_mesh,
                      (len(ts),) + tuple(t.shape))


def _leaf_layer(x, g: int):
    """Layer g of a stacked leaf (a view); of a DTensor, the DTensor of
    its shard's layer g."""
    if not is_dtensor(x):
        return x[g]
    from repro_torch.sharding.axes import from_local
    return from_local(x.to_local()[g], _shift_placements(x.placements, -1),
                      x.device_mesh, tuple(x.shape[1:]))


def to_tree(model: LM, named: Dict[str, torch.Tensor]) -> Dict:
    """The JAX-layout tree of tensors keyed by parameter name (the
    parameters, their gradients, AdamW moments): block leaves stacked on
    a leading G (a copy), top-level leaves as they are.  DTensor leaves
    stay DTensors, a stacked one sharded as its layers are."""
    tree: Dict[str, Any] = {}
    for path, names in leaf_names(model):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = (_stack_layers([named[n] for n in names])
                          if _stacked(path) else named[names[0]])
    return tree


def from_tree(model: LM, tree) -> Dict[str, Any]:
    """The inverse of `to_tree`: {parameter name: leaf or leaf[g]} from a
    JAX-layout tree (of tensors, DTensors or numpy arrays)."""
    out: Dict[str, Any] = {}
    for path, names in leaf_names(model):
        node = tree
        for k in path:
            node = node[k]
        if _stacked(path):
            out.update({n: _leaf_layer(node, g) for g, n in enumerate(names)})
        else:
            out[names[0]] = node
    return out


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _out_proj(o, wo):
    """einsum("bshk,hkd->bsd", o, wo) as one matrix product (on a mesh,
    each merged heads x head_dim gradient gathered where its shards do
    not divide the heads, so that its merge's backward can split it)."""
    B, S, H = o.shape[:3]
    return even_grad(o.reshape(B, S, -1), 2, H) @ \
        even_grad(wo.reshape(-1, wo.shape[-1]), 0, H)


def _noncausal_attention(q, k, v, cfg, runcfg):
    """The JAX mixer's non-causal branch: the KV heads repeated, then
    `full_attention`, or `chunked_attention` (no (S,T) scores) where S·T
    passes 2**22 (the whole call's S·T, also for a rank's share on a
    mesh)."""
    S, T = q.shape[1], k.shape[1]

    def attend(q, k, v, offset):
        H = q.shape[2]
        kk, vv = attn_mod.repeat_kv(k, H), attn_mod.repeat_kv(v, H)
        if S * T <= 2 ** 22:
            return attn_mod.full_attention(q, kk, vv, causal=False)
        B, Sl = q.shape[:2]
        qp = torch.arange(Sl, device=q.device)[None].expand(B, Sl)
        kp = torch.arange(T, device=q.device)[None].expand(B, T)
        return attn_mod.chunked_attention(
            q, kk, vv, q_pos=qp, k_pos=kp, causal=False,
            chunk_k=runcfg.attn_chunk_k,
            acc_dtype=DTYPES[runcfg.attn_acc_dtype])

    return attn_mod.local_attention(attend, q, k, v)


def _train_attention(q, k, v, runcfg):
    """The training attention (`causal_blocked_attention`, the KV heads
    repeated), on the rank's share of DTensor q/k/v on a mesh."""
    def attend(q, k, v, offset):
        H = q.shape[2]
        return attn_mod.causal_blocked_attention(
            q, attn_mod.repeat_kv(k, H), attn_mod.repeat_kv(v, H),
            chunk_q=runcfg.attn_chunk_q, chunk_k=runcfg.attn_chunk_k,
            acc_dtype=DTYPES[runcfg.attn_acc_dtype], q_offset=offset)

    return attn_mod.local_attention(attend, q, k, v)


def _no_cn(x, *axes):
    return x


def _write_prefix(cache, new):
    """cache[:, :S] = new (B,S,KV,hd).  With a DTensor cache each rank
    writes the positions its shard holds, from `new` gathered over the
    sequence."""
    S = new.shape[1]
    if not is_dtensor(cache):
        cache[:, :S] = new
        return
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding.axes import shard_index
    dm, cp = cache.device_mesh, cache.placements
    newl = new.redistribute(dm, [
        p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
        for p in cp]).to_local()
    cl = cache.to_local()
    Tl = cl.shape[1]
    lo = shard_index(cp, dm, 1)[0] * Tl
    n = max(0, min(S - lo, Tl))
    if n:
        cl[:, :n] = newl[:, lo:lo + n].to(cl.dtype)


def _write_at(cache, new, cache_len):
    """cache[b, cache_len[b]] = new[b, 0] for every row b (new (B,1,KV,hd),
    cache_len (B,) < T).  On one card an indexed write in place (the JAX
    step writes with a one-hot select over the whole cache, elementwise,
    so that a sequence-sharded cache never sees a scatter; the cache
    comes out the same).  With a DTensor cache the rank whose shard holds
    position cache_len[b] writes it; the others write back what they
    hold, so no rank reads anything on the host."""
    B = new.shape[0]
    if not is_dtensor(cache):
        rows = torch.arange(B, device=cache.device)
        cache[rows, cache_len.long()] = new[:, 0].to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding.axes import shard_index
    dm, cp = cache.device_mesh, cache.placements
    newl = new.redistribute(dm, [
        p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
        for p in cp]).to_local()
    cl = cache.to_local()
    Bl, Tl = cl.shape[:2]
    bi, _ = shard_index(cp, dm, 0)
    pos = cache_len[bi * Bl:(bi + 1) * Bl].long() - \
        shard_index(cp, dm, 1)[0] * Tl
    own = (pos >= 0) & (pos < Tl)
    pos = pos.clamp(0, Tl - 1)
    rows = torch.arange(Bl, device=cl.device)
    cl[rows, pos] = torch.where(own[:, None, None], newl[:, 0].to(cl.dtype),
                                cl[rows, pos])


def _attn_mixer(p, h, cfg, *, mode, cache, positions, cache_len=None,
                runcfg=None, ctx=None, causal=True, rope=True, gate=None,
                cn=_no_cn):
    """Attention mixer.  Causal self-attention: in prefill and decode it
    writes this layer's K/V into `cache` (a cache at capacity) in place,
    in training it takes no cache.  `causal=False` (the encoder's
    self-attention; cross-attention, with K/V projected from `ctx` and
    `rope=False`) takes no cache in any mode.  With `gate` the output is
    scaled by tanh(gate).  `cn` constrains q and the output to JAX's
    placements on a mesh.  Returns its output."""
    B, S, _ = h.shape
    x = rms_norm(h, p["pre_norm"], cfg.norm_eps)
    src = x if ctx is None else ctx
    q, k, v = attn_mod._project_qkv(p, x, src, cfg, positions, positions,
                                    rope=rope)
    q = cn(q, "batch", "seq", "heads", "head_dim")
    if not causal:
        o = _noncausal_attention(q, k, v, cfg, runcfg)
    elif mode == "train":
        if runcfg.attention_impl == "pallas":
            raise ValueError(
                "attention_impl='pallas' cannot train: the flash kernel "
                "has no backward, as JAX cannot differentiate its Pallas "
                "kernel either; train with attention_impl='xla'")
        o = _train_attention(q, k, v, runcfg)
    elif mode == "decode":
        # needs cache_len < T, as the serve loop's capacity P + G ensures
        _write_at(cache["k"], k, cache_len)
        _write_at(cache["v"], v, cache_len)
        o = attn_mod.decode_attention(q, cache["k"], cache["v"],
                                      cache_len + 1, cn=cn)
    else:
        o = attn_mod.causal_attention(q, k, v)
        _write_prefix(cache["k"], k)
        _write_prefix(cache["v"], v)
    o = cn(o, "batch", "seq", "heads", "head_dim")
    out = _out_proj(o, p["wo"])
    if gate is not None:
        out = out * torch.tanh(gate).to(out.dtype)
    return out


def _cross_mixer(p, gate, h, cfg, *, mode, cache, ctx, runcfg, cn=_no_cn):
    """The gated cross-attention of a cross layer.  Prefill and training
    attend to `ctx` (non-causal, no rope), and prefill fills `cache`
    ({"k", "v", "len"}) with the raw context projections ctx @ wk, ctx @
    wv — no bias, no k_norm, as the JAX prefill does — and the context
    length; decode attends to that cache on the decode kernel, with q
    from wq (+ bq) and no q_norm, as in JAX.  On a mesh each rank writes
    and reads its shard of the cache: its batch rows and its KV heads,
    the whole context."""
    if mode == "decode":
        x = rms_norm(h, p["pre_norm"], cfg.norm_eps)
        q = attn_mod._proj(x, p["wq"])
        if "bq" in p:
            q = q + p["bq"]
        o = attn_mod.decode_attention(q, cache["k"], cache["v"],
                                      cache["len"])
        o = _out_proj(o, p["wo"])
        return o * torch.tanh(gate).to(o.dtype)
    if ctx is None:
        raise ValueError(f"{cfg.name}: a cross-attention layer needs a "
                         f"context: img_embeds or frames")
    o = _attn_mixer(p, h, cfg, mode="train", cache=None, positions=None,
                    runcfg=runcfg, ctx=ctx, causal=False, rope=False,
                    gate=gate, cn=cn)
    if mode == "prefill":
        T = ctx.shape[1]
        _write_prefix(cache["k"], attn_mod._proj(ctx, p["wk"]))
        _write_prefix(cache["v"], attn_mod._proj(ctx, p["wv"]))
        n = cache["len"]
        (n.to_local() if is_dtensor(n) else n).fill_(T)
    return o


def _ssd_mixer(p, h, cfg, *, mode, cache, cn=_no_cn):
    """SSD mixer: prefill scans the prompt from a zero state (any state in
    `cache` is ignored, as in the JAX model) and copies the final state
    into `cache`; decode updates `cache` in place; training runs the
    differentiable chunked scan and keeps no state.  Returns its
    output."""
    x = rms_norm(h, p["pre_norm"], cfg.norm_eps)
    if mode == "train":
        return ssd_mod.ssd_chunked(p, x, cfg, cn=cn)
    if mode == "decode":
        return ssd_mod.ssd_decode(p, x, cache, cfg)[0]
    o, state = ssd_mod.ssd_apply(p, x, cfg, cn=cn)
    for k, v in state.items():
        assign(cache[k], v)
    return o


def apply_block(block: Block, h, cfg, *, mode, cache, positions,
                cache_len=None, runcfg=None, ctx=None, mesh=None,
                cn=_no_cn):
    """One layer; `cache` is its slice of the caches ({"self": {"k",
    "v"}} or {"ssm": {...}}, and {"cross": {...}} for a cross layer),
    None in training; `ctx` the cross layers' context (B,T,D); `mesh`
    and `cn` the mesh and constrainer of a forward on one.  Returns (h,
    the MoE aux loss, None without an MoE MLP)."""
    kind = block.kind
    if kind.mixer == "attn":
        h = h + _attn_mixer(block.attn, h, cfg, mode=mode,
                            cache=cache["self"] if cache else None,
                            positions=positions, cache_len=cache_len,
                            runcfg=runcfg, cn=cn)
    else:
        h = h + _ssd_mixer(block.ssd, h, cfg, mode=mode,
                           cache=cache["ssm"] if cache else None, cn=cn)
    h = cn(h, "batch", "seq", "embed_tp")
    if kind.cross:
        h = h + _cross_mixer(block.xattn, block.xattn_gate, h, cfg,
                             mode=mode, cache=cache["cross"] if cache
                             else None, ctx=ctx, runcfg=runcfg, cn=cn)
        h = cn(h, "batch", "seq", "embed_tp")
    aux = None
    if kind.ffn == "mlp":
        p = block.mlp
        x = rms_norm(h, p["pre_norm"], cfg.norm_eps)
        h = cn(h + swiglu(x, p["wg"], p["wu"], p["wd"]), "batch", "seq",
               "embed_tp")
    elif kind.ffn == "moe":
        p = block.moe
        x = rms_norm(h, p["pre_norm"], cfg.norm_eps)
        y, aux = moe_mod.moe_apply(p, x, cfg, mesh)
        h = cn(h + y, "batch", "seq", "embed_tp")
    return h, aux


def _add_aux(total, a):
    return a if total is None else (total if a is None else total + a)


class _AtUse(torch.autograd.Function):
    """A weight redistributed from its storage placements to those at use
    (ZeRO-3's all-gather over "data"); the backward brings the gradient
    back to the storage placements (`_reduce_at_use`: a reduce-scatter of
    a gradient that is a partial sum over "data")."""

    @staticmethod
    def forward(ctx, p, pl):
        ctx.src = p.placements
        return p.redistribute(p.device_mesh, pl)

    @staticmethod
    def backward(ctx, g):
        return _reduce_at_use(g, ctx.src), None


def _reduce_at_use(g, src):
    return g.redistribute(g.device_mesh, src)


class _BlockAtUse:
    """A block's view with its weights at their use placements."""

    def __init__(self, block: Block, use):
        self.kind, self.index = block.kind, block.index
        for part in Block.PARTS:
            d = getattr(block, part)
            setattr(self, part, None if d is None else
                    {n: _AtUse.apply(t, use[part][n]) for n, t in d.items()})
        self.xattn_gate = block.xattn_gate


def _at_use(block: Block, use):
    """`block` itself, or with `use` (a block's placements by part and
    name, from `_use_placements`) its weights redistributed to them."""
    return block if use is None else _BlockAtUse(block, use)


def _use_placements(model: LM, rules, mesh):
    """Per period position r, the placements of block r's weights under
    ZeRO-3's rules at use (`sharding.axes.use_rules`)."""
    from repro_torch.sharding.axes import placements, tree_shardings, \
        use_rules
    rules = use_rules(rules)
    return [tree_map(lambda spec: placements(spec, mesh),
                     tree_shardings(block_params(model.cfg, kind,
                                                 model.embed.dtype),
                                    rules, mesh))
            for kind in model.kinds]


def _apply_at_use(block, h, *, use=None, **kw):
    return apply_block(_at_use(block, use), h, **kw)


def _train_period(model: LM, g: int, h, positions, runcfg, ctx, use=None,
                  mesh=None, cn=_no_cn):
    """Layers g*P .. g*P + P-1 in training mode, each block recomputed
    in the backward pass when `runcfg.remat_policy == "block"` (with its
    weights' gather at use, under ZeRO-3).  Returns (h, aux)."""
    P = len(model.kinds)
    aux = None
    for r in range(P):
        blk = functools.partial(_apply_at_use, model.blocks[g * P + r],
                                use=None if use is None else use[r],
                                cfg=model.cfg, mode="train", cache=None,
                                positions=positions, runcfg=runcfg, ctx=ctx,
                                mesh=mesh, cn=cn)
        if runcfg.remat and runcfg.remat_policy == "block":
            h, a = checkpoint(blk, h, use_reentrant=False)
        else:
            h, a = blk(h)
        aux = _add_aux(aux, a)
    return h, aux


def _layer(a, g: int):
    """Layer g's slice of a cache leaf with a leading G: a view (of the
    rank's shard, for a DTensor leaf), so writes land in the leaf."""
    if not is_dtensor(a):
        return a[g]
    from torch.distributed.tensor import Shard

    from repro_torch.sharding.axes import from_local
    pl = []
    for p in a.placements:
        if isinstance(p, Shard):
            if p.dim == 0:
                raise ValueError("a cache leaf sharded on its layer axis")
            p = Shard(p.dim - 1)
        pl.append(p)
    return from_local(a.to_local()[g], pl, a.device_mesh, a.shape[1:])


def run_stack(model: LM, h, *, mode, caches, positions, cache_len=None,
              runcfg=None, ctx=None, mesh=None, cn=_no_cn, use=None):
    """All num_layers layers, layer g*P + r in order, each writing its
    slice of `caches` (the JAX tree with leading G) in place; training
    takes no caches and, with `runcfg.remat`, recomputes each period of
    P layers (the JAX default policy) in the backward pass.  `use`, the
    weights' placements at use by period position (ZeRO-3), gathers each
    block's weights where it runs.  Returns (h, the summed MoE aux loss,
    None without MoE layers)."""
    cfg, kinds = model.cfg, model.kinds
    P = len(kinds)
    G = cfg.num_layers // P
    aux = None
    if mode == "train":
        for g in range(G):
            if runcfg.remat and runcfg.remat_policy != "block":
                h, a = checkpoint(_train_period, model, g, h, positions,
                                  runcfg, ctx, use, mesh, cn,
                                  use_reentrant=False)
            else:
                h, a = _train_period(model, g, h, positions, runcfg, ctx,
                                     use, mesh, cn)
            aux = _add_aux(aux, a)
        return h, aux
    for g in range(G):
        for r in range(P):
            h, a = _apply_at_use(model.blocks[g * P + r], h,
                                 use=None if use is None else use[r],
                                 cfg=cfg, mode=mode,
                                 cache=tree_map(lambda a: _layer(a, g),
                                                caches[f"r{r}"]),
                                 positions=positions, cache_len=cache_len,
                                 runcfg=runcfg, ctx=ctx, mesh=mesh, cn=cn)
            aux = _add_aux(aux, a)
    return h, aux


# ---------------------------------------------------------------------------
# Whole-model forward
# ---------------------------------------------------------------------------

def _embed(model: LM, tokens, cn=_no_cn):
    if is_dtensor(model.embed):
        h = _embed_sharded(model.embed, tokens)
    else:
        h = model.embed[tokens.long()]
    return cn(h, "batch", "seq", "embed_tp")


def _embed_sharded(embed, tokens):
    """The lookup of `tokens` (every rank holds them whole) in a DTensor
    table (Vp,D) on this rank's shard: the rows it holds, zeros for the
    tokens another vocabulary shard holds, so the result (B,S,D) is a
    partial sum over the mesh dims that shard the vocabulary and sharded
    as the table's D elsewhere.  (DTensor's own vocab-parallel lookup
    takes a partial type its backward cannot reduce into.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.sharding.axes import from_local, shard_index
    dm, pl = embed.device_mesh, embed.placements
    w = embed.to_local()
    Vl = w.shape[0]
    idx = tokens.long() - shard_index(pl, dm, 0)[0] * Vl
    own = (idx >= 0) & (idx < Vl)
    h = w[idx.clamp(0, Vl - 1)] * own[..., None].to(w.dtype)
    out = [Partial() if isinstance(p, Shard) and p.dim == 0 else
           Shard(2) if isinstance(p, Shard) else Replicate() for p in pl]
    return from_local(h, out, dm, tuple(tokens.shape) + (embed.shape[1],))


def _unembed(model: LM, h, cn=_no_cn):
    h = rms_norm(h, model.final_norm, model.cfg.norm_eps)
    head = model.embed.T if model.cfg.tie_embeddings else model.head
    return cn(h @ head, "batch", "seq", "vocab")


def _encoder_block(block: Block, h, cfg, positions, runcfg, cn=_no_cn):
    h = cn(h + _attn_mixer(block.attn, h, cfg, mode="train", cache=None,
                           positions=positions, runcfg=runcfg, causal=False,
                           cn=cn), "batch", "seq", "embed_tp")
    p = block.mlp
    x = rms_norm(h, p["pre_norm"], cfg.norm_eps)
    return cn(h + swiglu(x, p["wg"], p["wu"], p["wd"]), "batch", "seq",
              "embed_tp")


def encode(model: LM, frames, runcfg, *, remat: bool = False, cn=_no_cn):
    """The encoder stack over the frontend's embeddings `frames`
    (B,S,D): non-causal attention + SwiGLU blocks at rope positions
    0..S-1, then the encoder's final norm.  With `remat` each block is
    recomputed in the backward pass.  On a mesh `frames` is a DTensor and
    `cn` constrains each block's residual stream, as JAX's encoder
    does."""
    cfg = model.cfg
    B, S, _ = frames.shape
    pos = torch.arange(S, device=frames.device)[None].expand(B, S)
    h = frames
    for block in model.encoder.blocks:
        f = functools.partial(_encoder_block, block, cfg=cfg, positions=pos,
                              runcfg=runcfg, cn=cn)
        h = checkpoint(f, h, use_reentrant=False) if remat else f(h)
    return rms_norm(h, model.encoder.final_norm, cfg.norm_eps)


def forward(model: LM, tokens, *, mode: str, caches=None, cache_len=None,
            runcfg=None, img_embeds=None, frames=None, mesh=None):
    """tokens: (B,S) int.  mode "prefill" (positions 0..S-1, K/V into
    cache positions 0..S-1, SSD states after token S-1, the cross caches
    from the context) or "decode" (S = 1 at positions cache_len) write
    `caches`, decode caches at capacity T >= S (`alloc_caches`), in
    place; mode "train" takes no caches.  Prefill and training of a
    model with cross layers take the context: `img_embeds` (B,T,D), or
    `frames` (B,S',D) for the encoder; cast to the parameters' dtype.
    `runcfg` (attention chunks and dtype, remat) defaults to
    `RunConfig()`.  Returns (logits (B,S,Vp), caches, the summed MoE aux
    loss: float32, 0 without MoE layers), as the JAX forward does.

    On a mesh of more than one rank (`launch.mesh.Mesh`) the model's
    parameters and the caches are DTensors on it (`shard_lm`,
    `alloc_caches(..., mesh=)`), the rules are
    `runcfg.sharding_profile`'s, tokens, `cache_len` and the context are
    tensors every rank holds whole, and the logits come out a DTensor
    placed (batch, seq, vocab), in every mode."""
    if mode not in ("prefill", "decode", "train"):
        raise ValueError(f"mode={mode!r}")
    runcfg = runcfg or RunConfig()
    if on_mesh(mesh):
        from torch.distributed.tensor.experimental import \
            implicit_replication

        from repro_torch.sharding.axes import make_constrainer, resolve_rules
        rules = resolve_rules(model.cfg, runcfg.sharding_profile)
        use = None
        if runcfg.zero3_at_use and "data" in mesh.shape:
            use = _use_placements(model, rules, mesh)
        with implicit_replication():
            return _forward(model, tokens, mode=mode, caches=caches,
                            cache_len=cache_len, runcfg=runcfg,
                            img_embeds=img_embeds, frames=frames, mesh=mesh,
                            cn=make_constrainer(rules, mesh), rules=rules,
                            use=use)
    return _forward(model, tokens, mode=mode, caches=caches,
                    cache_len=cache_len, runcfg=runcfg,
                    img_embeds=img_embeds, frames=frames)


def _context(x, dt, axes, rules, mesh, cn):
    """The context in the parameters' dtype; on a mesh the DTensor of a
    tensor every rank holds whole, placed at `axes` (JAX's constraint of
    the context)."""
    x = x.to(dt)
    if mesh is None:
        return x
    from repro_torch.sharding.axes import place
    return place(x, axes, rules, mesh)


def _forward(model: LM, tokens, *, mode, caches, cache_len, runcfg,
             img_embeds=None, frames=None, mesh=None, cn=_no_cn, rules=None,
             use=None):
    B, S = tokens.shape
    ctx = None
    if mode != "decode":
        dt = model.embed.dtype
        if model.encoder is not None and frames is not None:
            ctx = encode(model, _context(frames, dt, ("batch", "seq",
                                                      "embed_tp"),
                                         rules, mesh, cn), runcfg,
                         remat=mode == "train" and runcfg.remat, cn=cn)
        elif img_embeds is not None:
            ctx = _context(img_embeds, dt, ("batch", "img_seq", "embed_tp"),
                           rules, mesh, cn)
    if mode == "decode":
        positions = cache_len[:, None]
    else:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    h = _embed(model, tokens, cn)
    h, aux = run_stack(model, h, mode=mode, caches=caches,
                       positions=positions, cache_len=cache_len,
                       runcfg=runcfg, ctx=ctx, mesh=mesh, cn=cn, use=use)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return _unembed(model, h, cn), caches, aux


def loss_fn(model: LM, batch, runcfg, mesh=None):
    """Next-token cross entropy + 0.01 x the MoE aux loss.  batch:
    tokens, labels[, img_embeds | frames], tensors every rank holds
    whole on a mesh, where the cross entropy is taken over the
    vocab-sharded logits without gathering them
    (`common.cross_entropy`).  Returns (total, (loss, aux)), plain
    tensors (on a mesh, each rank's copy of the replicated value)."""
    logits, _, aux = forward(model, batch["tokens"], mode="train",
                             runcfg=runcfg,
                             img_embeds=batch.get("img_embeds"),
                             frames=batch.get("frames"), mesh=mesh)
    loss = cross_entropy(logits, batch["labels"], model.cfg.vocab_size)
    if is_dtensor(aux):
        from torch.distributed.tensor import Replicate
        aux = aux.redistribute(aux.device_mesh, [Replicate()] *
                               aux.device_mesh.ndim).to_local()
    return loss + 0.01 * aux, (loss, aux)
