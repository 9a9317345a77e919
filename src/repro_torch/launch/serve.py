"""Serving entry point (the port of `repro.launch.serve`): batched prefill +
decode through the elastic observer pool (inference replicas on spot
capacity, scaled by Algorithm 1, revocation-safe by Property 3.4).

Usage:
  python -m repro_torch.launch.serve --arch smollm-360m --requests 64
  python -m repro_torch.launch.serve --no-reduced --prompt-len 512 \
      --gen-len 32                              # full width, on the card
  python -m repro_torch.launch.serve --device cpu   # the twins, on the CPU
  python -m repro_torch.launch.serve --arch mamba2-130m --no-reduced
  python -m repro_torch.launch.serve --arch mamba2-130m --device cpu

`--reduced` keeps the reference's default (the reduced model) but can be
turned off: the JAX CLI declares it `store_true` with default True and so
can never serve full width.  The loop is the reference's; `serve()` is it
as a function that takes carried weights (`models.lm.from_numpy`) and
returns what it generated and timed.  The caches (K/V for attention
layers, states and conv tails for SSD layers) are allocated at capacity
P + G once, and each batch's prefill writes into them, where the
reference pads fresh prefill caches to capacity by shape (and so, for an
SSM model, also pads the SSM state when P equals the head count, and
the conv tails when P is the conv width less one).  A cross layer's
cache holds the image tokens (vlm) or the capacity (audio_encdec), as
`models.lm.cache_specs` sets out.

The vlm and audio_encdec families get the reference's context stubs,
zero image embeddings (B, num_image_tokens, D) and zero frames (B, P, D)
in bfloat16.  With them the encoder's output and the cross-attention
K/V are zero, so the cross layers add nothing: the serve loop matches
the reference's, and the tests hold the cross and encoder paths to JAX
with seeded contexts and a drawn gate instead.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.configs.bwraft_kv import CONFIG as CLUSTER
from repro_torch.coord.elastic import ElasticObserverPool
from repro_torch.launch import steps as S
from repro_torch.models import lm
from repro_torch.models.common import DTYPES


def context_stubs(cfg, batch: int, prompt_len: int, device):
    """The reference's context stubs for a batch: zero image embeddings
    (B, num_image_tokens, D) for the vlm family, zero frames (B, P, D)
    for audio_encdec, in bfloat16; none for the other families."""
    shape = {"vlm": ("img_embeds", cfg.num_image_tokens),
             "audio_encdec": ("frames", prompt_len)}.get(cfg.family)
    if shape is None:
        return {}
    name, T = shape
    return {name: torch.zeros((batch, T, cfg.d_model), dtype=torch.bfloat16,
                              device=device)}


def draw_gates(model: lm.LM, seed: int) -> lm.LM:
    """Every `xattn_gate` of `model` drawn in place from a standard
    normal (numpy, `seed`), in layer order.  The reference initializes
    them to zero, and tanh(0) = 0 makes every cross layer add nothing,
    so each check of the cross layers draws them.  Returns `model`."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for blk in model.blocks:
            g = blk.xattn_gate
            if g is not None:
                g.copy_(torch.as_tensor(rng.standard_normal(g.shape)))
    return model


def seeded_context(cfg, batch: int, prompt_len: int, seed: int,
                   dtype=torch.float32, device="cpu"):
    """`context_stubs`' shapes drawn from a standard normal (numpy,
    `seed`): zero stubs make the encoder's output and the cross K/V
    zero, so each check of those paths seeds the context instead."""
    stubs = context_stubs(cfg, batch, prompt_len, "meta")
    rng = np.random.default_rng(seed)
    return {n: torch.as_tensor(rng.standard_normal(z.shape)).to(
        device=device, dtype=dtype) for n, z in stubs.items()}


def serve(cfg, runcfg: RunConfig, *, params: Optional[lm.LM] = None,
          device=None, requests: int = 64, batch: int = 8,
          prompt_len: int = 32, gen_len: int = 16, revoke_p: float = 0.1,
          seed: int = 0) -> Dict[str, Any]:
    """Serve `requests` random prompts in batches of `batch`: route each
    batch through the pool, revoke replicas at `revoke_p`, prefill,
    decode `gen_len` tokens, then `serve_tick` and `autoscale`, as the
    reference loop does.  `params` is an `LM` (random weights from
    `seed` when None); `device` None means the card.

    Returns the summary counts and, per batch, the generated tokens
    (B, gen_len + 1) — the prefill's token, then each decode step's —
    and the host-clock prefill and decode times in ms (the device is
    synchronized at each boundary)."""
    dev = resolve_device(device)
    model = params if params is not None else lm.init_lm(
        cfg, runcfg, seed=seed, device=dev)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    prefill = S.make_prefill_step(cfg, runcfg)
    decode = S.make_decode_step(cfg, runcfg)

    pool = ElasticObserverPool(CLUSTER, seed=seed)
    pool.set_committed(0)
    pool.add_replicas(2)

    B, P, G = batch, prompt_len, gen_len
    layers = lm.alloc_caches(cfg, B, P + G, DTYPES[runcfg.activation_dtype],
                             dev)
    stubs = context_stubs(cfg, B, P, dev)
    rng = np.random.default_rng(seed)

    generated, prefill_ms, decode_ms = [], [], []
    sync()
    t0 = time.perf_counter()
    total_tokens = done = 0
    while done < requests:
        n = min(B, requests - done)
        # route this batch through the observer pool; revocations mid-flight
        # re-route to surviving replicas (paper fault path)
        pool.route(n)
        killed = pool.revoke_random(revoke_p)
        if killed:
            pool.route(0)      # survivors pick up; queue counters keep score
        toks = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
        tokens = torch.from_numpy(toks).to(dev)
        tb = time.perf_counter()
        tok, caches = prefill(model, {"tokens": tokens, **stubs}, layers)
        sync()
        tp = time.perf_counter()
        out = [tok]
        for _ in range(G):
            tok, caches = decode(model, caches, tok[:, None])
            out.append(tok)
        generated.append(torch.stack(out, dim=1).cpu().numpy())
        td = time.perf_counter()
        prefill_ms.append((tp - tb) * 1e3)
        decode_ms.append((td - tp) * 1e3)
        pool.serve_tick()
        total_tokens += n * G
        done += n
        # autoscale each round on observed load
        pool.autoscale(reads_now=done * G, writes_now=0, budget=2.0,
                       spot_price=0.012, on_demand_price=0.042)
    dt = time.perf_counter() - t0
    return {"requests": done, "tokens": total_tokens, "seconds": dt,
            "tok_per_s": total_tokens / max(dt, 1e-9),
            "replicas": len(pool.alive), "served": pool.served,
            "rerouted": pool.rerouted, "generated": generated,
            "prefill_ms": prefill_ms, "decode_ms": decode_ms}


def summary_line(r: Dict[str, Any]) -> str:
    return (f"[serve] {r['requests']} requests, {r['tokens']} tokens in "
            f"{r['seconds']:.1f}s ({r['tok_per_s']:.1f} tok/s) "
            f"replicas={r['replicas']} served={r['served']} "
            f"rerouted={r['rerouted']}")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--revoke-p", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain twins)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    runcfg = RunConfig(remat=False)
    r = serve(cfg, runcfg, device=args.device, requests=args.requests,
              batch=args.batch, prompt_len=args.prompt_len,
              gen_len=args.gen_len, revoke_p=args.revoke_p, seed=args.seed)
    print(summary_line(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
