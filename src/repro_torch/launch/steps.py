"""Step builders for serving (the port of `repro.launch.steps`):
`make_prefill_step` and `make_decode_step`, plus the spec trees they
share with the serving entry point.

One card, so there is no mesh, no sharding rules and no constrainer.
The steps take the port's `models.lm.LM` where the JAX steps take the
parameter tree, run without autograd, and write the caches in place
(the JAX decode step donates them).  Training (`make_train_step`,
`optim/adamw`) is a later slice (ROADMAP.md §1 item 10c).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.models import lm
from repro_torch.models.common import DTYPES, ParamSpec


def param_specs(cfg: ModelConfig, runcfg: RunConfig):
    return lm.build_param_specs(cfg, DTYPES[runcfg.param_dtype])


def decode_state_specs(cfg: ModelConfig, shape: ShapeConfig,
                       runcfg: RunConfig):
    """Serving state: KV/SSM caches + position counter."""
    B, T = shape.global_batch, shape.seq_len
    layers = lm.cache_specs(cfg, B, T, DTYPES[runcfg.activation_dtype])
    return {"pos": ParamSpec((B,), torch.int32, ("batch",), "zeros"),
            "layers": layers}


def make_prefill_step(cfg: ModelConfig, runcfg: RunConfig):
    @torch.no_grad()
    def prefill_step(model, batch, layers):
        """batch["tokens"]: (B,S); `layers`: caches at capacity
        (`lm.alloc_caches`), whose first S positions take the prompt's
        K/V and whose SSM leaves take the states after the prompt.
        Returns (next_token (B,) int32, caches {"pos", "layers"})."""
        tokens = batch["tokens"]
        logits, layer_caches = lm.forward(model, tokens, mode="prefill",
                                          caches=layers)
        B, S = tokens.shape
        caches = {"pos": torch.full((B,), S, dtype=torch.int32,
                                    device=tokens.device),
                  "layers": layer_caches}
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, caches

    return prefill_step


def make_decode_step(cfg: ModelConfig, runcfg: RunConfig):
    @torch.no_grad()
    def decode_step(model, caches, tokens):
        """tokens: (B,1) int.  Returns (next_token, new_caches); the
        layer caches are updated in place."""
        pos = caches["pos"]
        logits, new_layers = lm.forward(model, tokens, mode="decode",
                                        caches=caches["layers"],
                                        cache_len=pos)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, {"pos": pos + 1, "layers": new_layers}

    return decode_step
