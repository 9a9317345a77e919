"""Step builders (the port of `repro.launch.steps`): `make_train_step`,
`make_prefill_step` and `make_decode_step`, plus the spec trees, the
train-state layout they share with the entry points and
`default_runcfg`.

Every step takes an optional mesh (`launch.mesh.Mesh`): on a mesh of
more than one rank `lm.forward` resolves the sharding rules from
`runcfg.sharding_profile`, as JAX's steps do, and runs on DTensors (the
model placed by `sharding.axes.shard_lm`, the caches by
`lm.alloc_caches(..., mesh=)`, the AdamW moments as their parameters by
`init_train_state`); tokens, labels, the context, positions and the
greedy next tokens are tensors every rank holds whole.  Without a mesh
they are the one-card steps.  The steps take the
port's `models.lm.LM` where the JAX steps take the parameter tree.  The
serving steps run without autograd and write the caches in place (the
JAX decode step donates them).  The train step's state is `{"params":
LM (trainable), "opt": AdamW state}`, updated in place (the JAX step
donates it); `state_tree` gives it the JAX train state's layout,
`{"params", "opt": {"m", "v", "step"}}` with stacked blocks, which a
checkpoint stores, and `load_state_tree` copies such a tree back in.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.models import lm
from repro_torch.models.common import DTYPES, ParamSpec
from repro_torch.sharding.axes import (all_reduce, is_dtensor, local_part,
                                       tree_shardings)
from repro_torch.optim import adamw


def param_specs(cfg: ModelConfig, runcfg: RunConfig):
    return lm.build_param_specs(cfg, DTYPES[runcfg.param_dtype])


def train_state_specs(cfg: ModelConfig, runcfg: RunConfig):
    ps = param_specs(cfg, runcfg)
    opt = adamw.abstract_opt_state(ps, DTYPES[runcfg.opt_state_dtype])
    return {"params": ps, "opt": opt}


def state_shardings(spec_tree, rules, mesh, prune_log=None):
    """The spec of every leaf of a ParamSpec tree under `rules` on `mesh`
    (`sharding.axes.tree_shardings`; JAX's gives NamedShardings of these
    specs)."""
    return tree_shardings(spec_tree, rules, mesh, prune_log=prune_log)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                act_dtype=torch.bfloat16) -> Dict[str, ParamSpec]:
    """ParamSpec tree for one input batch of the given shape."""
    B, S = shape.global_batch, shape.seq_len
    out = {
        "tokens": ParamSpec((B, S), torch.int32, ("batch", "seq")),
        "labels": ParamSpec((B, S), torch.int32, ("batch", "seq")),
    }
    if cfg.family == "vlm":
        out["img_embeds"] = ParamSpec((B, cfg.num_image_tokens, cfg.d_model),
                                      act_dtype, ("batch", "img_seq", None))
    if cfg.family == "audio_encdec":
        out["frames"] = ParamSpec((B, S, cfg.d_model), act_dtype,
                                  ("batch", "seq", None))
    return out


def init_train_state(model: lm.LM, dtype=torch.float32) -> Dict:
    """A train state around a trainable `model`: AdamW moments at zero in
    `dtype` (JAX `launch/train.py`'s `init_opt_state(params)`: float32)."""
    return {"params": model,
            "opt": adamw.init_opt_state(dict(model.named_parameters()),
                                        dtype)}


def shard_state(state, cfg: ModelConfig, runcfg: RunConfig, mesh) -> Dict:
    """A freshly initialised one-device train state (`init_train_state`)
    placed on `mesh`: the parameters as `sharding.axes.shard_lm` places
    them under the run's profile (each rank keeping its shard of the
    whole weights), the AdamW moments at zero placed as their
    parameters."""
    from repro_torch.sharding.axes import resolve_rules, shard_lm
    model = shard_lm(state["params"], resolve_rules(
        cfg, runcfg.sharding_profile), mesh)
    return init_train_state(model,
                            next(iter(state["opt"]["m"].values())).dtype)


def state_tree(state) -> Dict:
    """The train state as the JAX train state's tree of tensors (blocks
    stacked: a copy of those leaves), what a checkpoint stores; on a mesh
    a tree of DTensors, sharded as the state is."""
    model, opt = state["params"], state["opt"]
    params = {n: p.detach() for n, p in model.named_parameters()}
    return {"params": lm.to_tree(model, params),
            "opt": {"m": lm.to_tree(model, opt["m"]),
                    "v": lm.to_tree(model, opt["v"]),
                    "step": opt["step"]}}


def _copy_into(dst, src) -> None:
    """dst <- src in place; into a DTensor, this rank's shard of `src`
    (a DTensor placed as `dst` is, or a whole tensor)."""
    if is_dtensor(dst):
        src = src.to_local() if is_dtensor(src) else local_part(
            src, dst.placements, dst.device_mesh)
        dst = dst.to_local()
    dst.copy_(src)


@torch.no_grad()
def load_state_tree(state, tree) -> None:
    """Copy a JAX-layout train-state tree of tensors (`state_tree`'s
    layout, e.g. a restored checkpoint) into `state` in place; on a mesh
    each rank copies its shard, from DTensor leaves placed as the
    state's are or from whole tensors."""
    model, opt = state["params"], state["opt"]
    named = dict(model.named_parameters())
    for src, dst in ((tree["params"], named), (tree["opt"]["m"], opt["m"]),
                     (tree["opt"]["v"], opt["v"])):
        for n, t in lm.from_tree(model, src).items():
            _copy_into(dst[n], t)
    opt["step"].copy_(tree["opt"]["step"])


def decode_state_specs(cfg: ModelConfig, shape: ShapeConfig,
                       runcfg: RunConfig):
    """Serving state: KV/SSM caches + position counter."""
    B, T = shape.global_batch, shape.seq_len
    layers = lm.cache_specs(cfg, B, T, DTYPES[runcfg.activation_dtype])
    return {"pos": ParamSpec((B,), torch.int32, ("batch",), "zeros"),
            "layers": layers}


def _backward_on(mesh):
    """The context of a backward pass: on a mesh, the plain tensors the
    forward saved (rope tables, masks, positions) meet DTensors again,
    as replicated ones (`implicit_replication`, as in `lm.forward`)."""
    import contextlib
    if not lm.on_mesh(mesh):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def make_train_step(cfg: ModelConfig, runcfg: RunConfig, mesh=None):
    """train_step(state, batch) -> (state, metrics): loss and gradients
    by autograd, then AdamW in place.  With `num_microbatches` M > 1 the
    batch splits into M slices of rows; their float32 gradients
    accumulate in slice order from zero, then divide by M, and the loss
    is the slices' mean, as in the JAX scan.  Metrics: `loss`, `aux`,
    `grad_norm`, device scalars.  On a mesh the state's parameters and
    moments are DTensors, each rank slices its microbatches from the
    whole batch it holds, each gradient is brought to its parameter's
    placements as it is taken (the reductions over "data") and
    accumulates on the rank's shard, and the metrics are the replicated
    values."""
    M = runcfg.num_microbatches

    def grads_of(model, names, plist, batch):
        total, (loss, aux) = lm.loss_fn(model, batch, runcfg, mesh=mesh)
        with _backward_on(mesh):
            gs = torch.autograd.grad(total, plist)
        gs = [g.redistribute(p.device_mesh, p.placements)
              if is_dtensor(g) else g for g, p in zip(gs, plist)]
        return dict(zip(names, gs)), loss.detach(), aux.detach()

    def train_step(state, batch):
        model = state["params"]
        params = dict(model.named_parameters())
        names, plist = list(params), list(params.values())
        if M > 1:
            B = batch["tokens"].shape[0]
            grads = {n: adamw.zeros_as(p) for n, p in params.items()}
            lsum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(M):
                mb = {k: v.reshape((M, B // M) + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                g, loss, _ = grads_of(model, names, plist, mb)
                for n in names:
                    grads[n] += g[n].float()
                lsum = lsum + loss
            grads = {n: g / M for n, g in grads.items()}
            loss = lsum / M
            aux = torch.zeros_like(loss)
        else:
            grads, loss, aux = grads_of(model, names, plist, batch)
        _, _, om = adamw.adamw_update(
            params, grads, state["opt"], lr=runcfg.learning_rate,
            weight_decay=runcfg.weight_decay, grad_clip=runcfg.grad_clip)
        return state, {"loss": loss, "aux": aux, **om}

    return train_step


def next_tokens(logits):
    """Greedy tokens from the last position: argmax over the vocabulary
    of logits[:, -1], the lowest index among equal maxima, as
    `torch.argmax` -> (B,) int32.  With DTensor logits (B,S,Vp) each
    rank takes its vocabulary shard's argmax, then all-reduces the max
    and the least index reaching it over the vocabulary's axes (the last
    position comes from the rank holding it where the sequence is
    sharded, the rows from their ranks where the batch is); every rank
    gets the whole (B,)."""
    if not is_dtensor(logits):
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    from torch.distributed.tensor import Replicate

    from repro_torch.sharding.axes import shard_dims, shard_index
    dm = logits.device_mesh
    if any(p.is_partial() for p in logits.placements):
        logits = logits.redistribute(dm, [
            Replicate() if p.is_partial() else p for p in logits.placements])
    pl = logits.placements
    loc = logits.to_local()

    def groups(dim):
        return [dm.get_group(i) for i in shard_dims(pl, dim)
                if dm.size(i) > 1]

    last = loc[:, -1].float()
    si, sn = shard_index(pl, dm, 1)
    if sn > 1:
        last = all_reduce(last if si == sn - 1 else torch.zeros_like(last),
                           "sum", groups(1))
    idx = torch.argmax(last, dim=-1)
    val = last.gather(-1, idx[:, None])[:, 0]
    idx = idx + shard_index(pl, dm, 2)[0] * loc.shape[2]
    vg = groups(2)
    if vg:
        top = all_reduce(val, "max", vg)
        idx = all_reduce(torch.where(val == top, idx, logits.shape[2]),
                          "min", vg)
    bi, bn = shard_index(pl, dm, 0)
    if bn > 1:
        Bl = loc.shape[0]
        whole = torch.zeros(logits.shape[0], dtype=idx.dtype,
                            device=idx.device)
        whole[bi * Bl:(bi + 1) * Bl] = idx
        idx = all_reduce(whole, "sum", groups(0))
    return idx.to(torch.int32)


def make_prefill_step(cfg: ModelConfig, runcfg: RunConfig, mesh=None):
    @torch.no_grad()
    def prefill_step(model, batch, layers):
        """batch["tokens"]: (B,S), and the context of a model with cross
        layers, batch["img_embeds"] or batch["frames"]; `layers`: caches
        at capacity (`lm.alloc_caches`), whose first S positions take
        the prompt's K/V, whose SSM leaves take the states after the
        prompt and whose cross caches take the context's K/V.  Returns
        (next_token (B,) int32, caches {"pos", "layers"})."""
        tokens = batch["tokens"]
        logits, layer_caches, _ = lm.forward(
            model, tokens, mode="prefill", caches=layers, runcfg=runcfg,
            img_embeds=batch.get("img_embeds"), frames=batch.get("frames"),
            mesh=mesh)
        B, S = tokens.shape
        caches = {"pos": torch.full((B,), S, dtype=torch.int32,
                                    device=tokens.device),
                  "layers": layer_caches}
        return next_tokens(logits), caches

    return prefill_step


def make_decode_step(cfg: ModelConfig, runcfg: RunConfig, mesh=None):
    @torch.no_grad()
    def decode_step(model, caches, tokens):
        """tokens: (B,1) int.  Returns (next_token, new_caches); the
        layer caches are updated in place, the cross caches read only."""
        pos = caches["pos"]
        logits, new_layers, _ = lm.forward(model, tokens, mode="decode",
                                           caches=caches["layers"],
                                           cache_len=pos, runcfg=runcfg,
                                           mesh=mesh)
        return next_tokens(logits), {"pos": pos + 1, "layers": new_layers}

    return decode_step


def make_step(cfg, runcfg, kind: str, mesh=None):
    if kind == "train":
        return make_train_step(cfg, runcfg, mesh)
    if kind == "prefill":
        return make_prefill_step(cfg, runcfg, mesh)
    if kind == "decode":
        return make_decode_step(cfg, runcfg, mesh)
    raise ValueError(kind)


def default_runcfg(cfg: ModelConfig, shape: ShapeConfig, **overrides):
    """Shape-appropriate RunConfig (profile, remat) for an arch, as JAX's
    `default_runcfg`: a train shape takes the train profile with 8
    microbatches at d_model >= 8192, else 4; a prefill shape the train
    profile without remat; a decode shape the long profile at batch 1,
    else the decode profile, without remat.  The config's
    `run_overrides` come over that, the caller's `overrides` last."""
    kw: Dict = {}
    if shape.kind == "train":
        mb = 8 if cfg.d_model >= 8192 else 4
        kw.update(sharding_profile="train", num_microbatches=mb)
    elif shape.kind == "prefill":
        kw.update(sharding_profile="train", remat=False)
    else:
        prof = "long" if shape.global_batch == 1 else "decode"
        kw.update(sharding_profile=prof, remat=False)
    kw.update(dict(cfg.run_overrides))
    kw.update(overrides)
    return RunConfig(**kw)
