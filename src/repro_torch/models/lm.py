"""The LM stack (the port of `repro.models.lm`): dense attention + SwiGLU
MLP layers and attention-free SSD layers (mamba2), a tied or separate
head, prefill and single-token decode with per-layer caches (DESIGN.md
§3).

Parameters keep the JAX package's names and shapes — wq (D,H,hd), wo
(H,hd,D), the `blocks/r{r}` groups — so JAX weights carry across
(`from_numpy`).  Where the JAX stack scans the G layers of each period
position, `LM` holds them unstacked, layer g*P + r at `blocks[g*P + r]`,
and `run_stack` is a Python loop.  Caches keep the JAX tree and layout,
{"r{r}": {"self": {"k", "v"}}} with leaves (G,B,T,KV,hd) for attention
and {"r{r}": {"ssm": {"ssm", "conv_x", "conv_B", "conv_C"}}} with leaves
(G,B,...) for SSD layers, allocated at capacity once and written in
place by prefill and decode.  Public functions keep the JAX layout
(B,S,H,hd).

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

The MoE, cross-attention and encoder branches are not ported yet and
raise `NotImplementedError` naming their ROADMAP item.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.common import (DTYPES, ParamSpec, cross_entropy,
                                       init_tree, rms_norm, swiglu,
                                       tree_items, tree_map, zeros_tree)


class LayerKind(NamedTuple):
    mixer: str          # "attn" | "ssd"
    ffn: str            # "mlp" | "moe" | "none"
    cross: bool = False


def unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet "
                               f"(ROADMAP.md §1 item {item})")


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
    if kind.cross:
        raise unported("cross-attention", "10d")
    if kind.ffn == "moe":
        raise unported("the MoE MLP", "10d")
    p: Dict[str, Any] = {}
    if kind.mixer == "attn":
        p["attn"] = attn_mod.attention_params(cfg, dtype=dtype)
    else:
        p["ssd"] = ssd_mod.ssd_params(cfg, dtype)
    if kind.ffn == "mlp":
        p["mlp"] = mlp_params(cfg, dtype)
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
    if cfg.encoder_layers:
        raise unported("the encoder stack", "10d")
    params: Dict[str, Any] = {
        "embed": ParamSpec((Vp, D), dtype, ("vocab", "embed"), "normal"),
        "final_norm": ParamSpec((D,), torch.float32, ("unsharded",), "ones"),
        "blocks": {f"r{r}": _stack(block_params(cfg, k, dtype), G)
                   for r, k in enumerate(kinds)},
    }
    if not cfg.tie_embeddings:
        params["head"] = ParamSpec((D, Vp), dtype, ("embed", "vocab"))
    return params


def cache_specs(cfg, batch: int, cache_cap: int, dtype=torch.bfloat16):
    """ParamSpec tree for decode caches (leading G per position): K/V at
    capacity `cache_cap` for attention layers; for SSD layers the state,
    float32 whatever `dtype`, and the conv tails in `dtype`."""
    kinds = layer_kinds(cfg)
    G = cfg.num_layers // len(kinds)
    KV, hd = cfg.num_kv_heads, cfg.head_dim

    def spec(shape, axes, dt=dtype):
        return ParamSpec((G, batch) + shape, dt, ("layers", "batch") + axes,
                         "zeros")

    out = {}
    for r, kind in enumerate(kinds):
        if kind.cross:
            raise unported("the cross-attention cache", "10d")
        if kind.mixer == "attn":
            kv = spec((cache_cap, KV, hd), ("kv_seq", "kv_heads", "head_dim"))
            out[f"r{r}"] = {"self": {"k": kv, "v": kv}}
            continue
        H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        W, DI = cfg.ssm_conv, cfg.d_inner
        out[f"r{r}"] = {"ssm": {
            "ssm": spec((H, P, N), ("ssm_heads", None, "ssm_state"),
                        torch.float32),
            "conv_x": spec((W - 1, DI), (None, "ssm_inner")),
            "conv_B": spec((W - 1, N), (None, "ssm_state")),
            "conv_C": spec((W - 1, N), (None, "ssm_state"))}}
    return out


def alloc_caches(cfg, batch: int, cache_cap: int, dtype, device):
    """Zeroed decode caches at capacity, allocated once; prefill and
    decode then write into them in place."""
    return zeros_tree(cache_specs(cfg, batch, cache_cap, dtype), device)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class Block(nn.Module):
    def __init__(self, kind: LayerKind, tree):
        super().__init__()
        self.kind = kind
        self.attn = nn.ParameterDict(tree["attn"]) if "attn" in tree else None
        self.ssd = nn.ParameterDict(tree["ssd"]) if "ssd" in tree else None
        self.mlp = nn.ParameterDict(tree["mlp"]) if "mlp" in tree else None


class LM(nn.Module):
    """The model: `embed` (Vp,D), `final_norm`, `head` (D,Vp) when the
    embeddings are not tied, and `blocks`, one `Block` per layer whose
    `attn` or `ssd`, and `mlp`, map the JAX names to parameters.
    Frozen (no parameter takes a gradient) unless `trainable`, which a
    training run asks for; serving keeps it frozen.  Applied by
    `forward`."""

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
        self.requires_grad_(trainable)


def init_lm(cfg, runcfg, *, seed: int = 0, device=None,
            trainable: bool = False) -> LM:
    """Random weights from `seed`, made on `device` by `init_tree`;
    `device` None means the card (`repro_torch.resolve_device`)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    specs = build_param_specs(cfg, DTYPES[runcfg.param_dtype])
    return LM(cfg, init_tree(gen, specs), trainable)


def from_numpy(params_np, cfg, runcfg, device=None,
               trainable: bool = False) -> LM:
    """The JAX parameter tree (`repro.models.common.init_tree` of
    `param_specs`) as numpy arrays -> the port's `LM` on `device`.
    bfloat16 leaves come as their uint16 bits (`a.view(np.uint16)`),
    since `torch.from_numpy` takes no bfloat16.  Every leaf is copied
    (JAX's numpy views are read-only).  The model-side
    counterpart of `core/state.from_numpy`.  `device` None means the
    card, as for `init_lm`."""
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
    return LM(cfg, tree, trainable)


def leaf_names(model: LM) -> List[Tuple[Tuple[str, ...], Tuple[str, ...]]]:
    """(JAX path, parameter names): every leaf of the JAX parameter tree
    in flatten order, with the `named_parameters` names that hold it —
    its own name for a top-level leaf, and layer g*P + r's for g = 0..G-1
    for the stacked block leaf ("blocks", "r{r}", part, name)."""
    P = len(model.kinds)
    G = model.cfg.num_layers // P
    out = []
    for path, _ in tree_items(build_param_specs(model.cfg)):
        if path[0] == "blocks":
            r = int(path[1][1:])
            names = tuple(f"blocks.{g * P + r}.{path[2]}.{path[3]}"
                          for g in range(G))
        else:
            names = (path[0],)
        out.append((path, names))
    return out


def to_tree(model: LM, named: Dict[str, torch.Tensor]) -> Dict:
    """The JAX-layout tree of tensors keyed by parameter name (the
    parameters, their gradients, AdamW moments): block leaves stacked on
    a leading G (a copy), top-level leaves as they are."""
    tree: Dict[str, Any] = {}
    for path, names in leaf_names(model):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = (torch.stack([named[n] for n in names])
                          if path[0] == "blocks" else named[names[0]])
    return tree


def from_tree(model: LM, tree) -> Dict[str, Any]:
    """The inverse of `to_tree`: {parameter name: leaf or leaf[g]} from a
    JAX-layout tree (of tensors or numpy arrays)."""
    out: Dict[str, Any] = {}
    for path, names in leaf_names(model):
        node = tree
        for k in path:
            node = node[k]
        if path[0] == "blocks":
            out.update({n: node[g] for g, n in enumerate(names)})
        else:
            out[names[0]] = node
    return out


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _attn_mixer(p, h, cfg, *, mode, cache, positions, cache_len=None,
                runcfg=None):
    """Causal self-attention mixer; in prefill and decode it writes this
    layer's K/V into `cache` (a cache at capacity) in place, in training
    it takes no cache.  Returns its output."""
    B, S, _ = h.shape
    x = rms_norm(h, p["pre_norm"], cfg.norm_eps)
    q, k, v = attn_mod._project_qkv(p, x, x, cfg, positions, positions,
                                    rope=True)
    if mode == "train":
        if runcfg.attention_impl == "pallas":
            raise ValueError(
                "attention_impl='pallas' cannot train: the flash kernel "
                "has no backward, as JAX cannot differentiate its Pallas "
                "kernel either; train with attention_impl='xla'")
        H = cfg.num_heads
        o = attn_mod.causal_blocked_attention(
            q, attn_mod.repeat_kv(k, H), attn_mod.repeat_kv(v, H),
            chunk_q=runcfg.attn_chunk_q, chunk_k=runcfg.attn_chunk_k,
            acc_dtype=DTYPES[runcfg.attn_acc_dtype])
        wo = p["wo"]
        return o.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])
    ck, cv = cache["k"], cache["v"]
    if mode == "decode":
        # The JAX step writes position cache_len[b] with a one-hot select
        # over the whole cache (elementwise, so a sequence-sharded cache
        # never sees a scatter).  On one card an indexed write in place
        # gives the same cache and moves one row per batch entry.  It
        # needs cache_len < T, as the serve loop's capacity P + G ensures.
        rows = torch.arange(B, device=h.device)
        pos = cache_len.long()
        ck[rows, pos] = k[:, 0].to(ck.dtype)
        cv[rows, pos] = v[:, 0].to(cv.dtype)
        o = attn_mod.decode_attention(q, ck, cv, cache_len + 1)
    else:
        o = attn_mod.causal_attention(q, k, v)
        ck[:, :S] = k
        cv[:, :S] = v
    wo = p["wo"]
    return o.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])


def _ssd_mixer(p, h, cfg, *, mode, cache):
    """SSD mixer: prefill scans the prompt from a zero state (any state in
    `cache` is ignored, as in the JAX model) and copies the final state
    into `cache`; decode updates `cache` in place; training runs the
    differentiable chunked scan and keeps no state.  Returns its
    output."""
    x = rms_norm(h, p["pre_norm"], cfg.norm_eps)
    if mode == "train":
        return ssd_mod.ssd_chunked(p, x, cfg)
    if mode == "decode":
        return ssd_mod.ssd_decode(p, x, cache, cfg)[0]
    o, state = ssd_mod.ssd_apply(p, x, cfg)
    for k, v in state.items():
        cache[k].copy_(v)
    return o


def apply_block(block: Block, h, cfg, *, mode, cache, positions,
                cache_len=None, runcfg=None):
    """One layer; `cache` is its {"self": {"k", "v"}} (attention) or
    {"ssm": {...}} (SSD) slice, None in training.  Returns h."""
    kind = block.kind
    if kind.mixer == "attn":
        h = h + _attn_mixer(block.attn, h, cfg, mode=mode,
                            cache=cache["self"] if cache else None,
                            positions=positions, cache_len=cache_len,
                            runcfg=runcfg)
    else:
        h = h + _ssd_mixer(block.ssd, h, cfg, mode=mode,
                           cache=cache["ssm"] if cache else None)
    if kind.ffn == "mlp":
        p = block.mlp
        x = rms_norm(h, p["pre_norm"], cfg.norm_eps)
        h = h + swiglu(x, p["wg"], p["wu"], p["wd"])
    elif kind.ffn == "moe":
        raise unported("the MoE MLP", "10d")
    return h


def _train_period(model: LM, g: int, h, positions, runcfg):
    """Layers g*P .. g*P + P-1 in training mode, each block recomputed
    in the backward pass when `runcfg.remat_policy == "block"`."""
    P = len(model.kinds)
    for r in range(P):
        blk = functools.partial(apply_block, model.blocks[g * P + r],
                                cfg=model.cfg, mode="train", cache=None,
                                positions=positions, runcfg=runcfg)
        if runcfg.remat and runcfg.remat_policy == "block":
            h = checkpoint(blk, h, use_reentrant=False)
        else:
            h = blk(h)
    return h


def run_stack(model: LM, h, *, mode, caches, positions, cache_len=None,
              runcfg=None):
    """All num_layers layers, layer g*P + r in order, each writing its
    slice of `caches` (the JAX tree with leading G) in place; training
    takes no caches and, with `runcfg.remat`, recomputes each period of
    P layers (the JAX default policy) in the backward pass."""
    cfg, kinds = model.cfg, model.kinds
    P = len(kinds)
    G = cfg.num_layers // P
    if mode == "train":
        for g in range(G):
            if runcfg.remat and runcfg.remat_policy != "block":
                h = checkpoint(_train_period, model, g, h, positions,
                               runcfg, use_reentrant=False)
            else:
                h = _train_period(model, g, h, positions, runcfg)
        return h
    for g in range(G):
        for r in range(P):
            h = apply_block(model.blocks[g * P + r], h, cfg, mode=mode,
                            cache=tree_map(lambda a: a[g], caches[f"r{r}"]),
                            positions=positions, cache_len=cache_len)
    return h


# ---------------------------------------------------------------------------
# Whole-model forward
# ---------------------------------------------------------------------------

def _embed(model: LM, tokens):
    return model.embed[tokens.long()]


def _unembed(model: LM, h):
    h = rms_norm(h, model.final_norm, model.cfg.norm_eps)
    head = model.embed.T if model.cfg.tie_embeddings else model.head
    return h @ head


def forward(model: LM, tokens, *, mode: str, caches=None, cache_len=None,
            runcfg=None):
    """tokens: (B,S) int.  mode "prefill" (positions 0..S-1, K/V into
    cache positions 0..S-1, SSD states after token S-1) or "decode" (S =
    1 at positions cache_len) write `caches`, decode caches at capacity
    T >= S (`alloc_caches`), in place; mode "train" takes no caches and
    needs `runcfg` (attention chunks and dtype, remat).  Returns (logits
    (B,S,Vp), caches)."""
    if mode not in ("prefill", "decode", "train"):
        raise ValueError(f"mode={mode!r}")
    B, S = tokens.shape
    if mode == "decode":
        positions = cache_len[:, None]
    else:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    h = _embed(model, tokens)
    h = run_stack(model, h, mode=mode, caches=caches, positions=positions,
                  cache_len=cache_len, runcfg=runcfg)
    return _unembed(model, h), caches


def loss_fn(model: LM, batch, runcfg):
    """Next-token cross entropy (+ 0.01 x the MoE aux loss, 0 for the
    ported families).  batch: tokens, labels.  Returns (total, (loss,
    aux))."""
    logits, _ = forward(model, batch["tokens"], mode="train", runcfg=runcfg)
    loss = cross_entropy(logits, batch["labels"], model.cfg.vocab_size)
    aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss + 0.01 * aux, (loss, aux)
