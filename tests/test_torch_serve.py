"""The port's serving entry point against the JAX one on the CPU: `serve()`
and a replica of the `repro.launch.serve.main` loop, given the same
float32 weights (JAX `init_tree`, carried across by
`models.lm.from_numpy`) and the same seed, on the reduced smollm-360m,
mamba2-130m, qwen2-moe-a2.7b, llama-3.2-vision-90b and
seamless-m4t-medium.  The generated tokens of every batch and
the elastic pool's `served`, `rerouted` and alive count must be equal.

The replica grows only the self-attention caches to capacity (the
port's cross caches hold the image tokens, or the capacity for an
encoder's output; JAX's grow also pads seamless's cross cache, whose
axis 2 equals the prompt length, which its `len` masks).  The
reference's `grow` pads every cache leaf whose axis 2 equals the prompt
length, which for mamba2 also catches the SSM state (G,B,H,P,N) when
the prompt length equals the head count and the conv tails (G,B,W-1,.)
when it is W-1, and its decode then fails; the mamba2 case runs at
prompt length 8, the reduced head count, to show the port has no such
fault."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.bwraft_kv import CONFIG as J_CLUSTER
from repro.coord.elastic import ElasticObserverPool as JPool
from repro.launch import steps as JS
from repro.data.pipeline import google_trace_like as j_trace
from repro.launch.mesh import make_host_mesh
from repro.models.common import init_tree
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.data.pipeline import google_trace_like as t_trace
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm

RUN = dict(remat=False, param_dtype="float32", activation_dtype="float32")


def _jax_serve(cfg, runcfg, params, *, requests, batch, prompt_len,
               gen_len, revoke_p, seed):
    """`repro.launch.serve.main`'s loop on given weights, collecting the
    tokens it generates."""
    mesh = make_host_mesh()
    prefill, _ = JS.make_prefill_step(cfg, runcfg, mesh)
    decode, _ = JS.make_decode_step(cfg, runcfg, mesh)
    prefill = jax.jit(prefill)
    decode = jax.jit(decode, donate_argnums=1)
    pool = JPool(J_CLUSTER, seed=seed)
    pool.set_committed(0)
    pool.add_replicas(2)
    B, P, G = batch, prompt_len, gen_len
    rng = np.random.default_rng(seed)
    # the reference makes its stubs bfloat16, its default run's dtype; at
    # float32 its encoder's layer scan refuses bf16 frames (the carry
    # changes dtype), so the replica makes them in the run's dtype
    act = jnp.dtype(runcfg.activation_dtype)
    done, generated = 0, []
    while done < requests:
        n = min(B, requests - done)
        pool.route(n)
        if pool.revoke_random(revoke_p):
            pool.route(0)
        toks = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
        batch = {"tokens": jnp.asarray(toks)}
        if cfg.family == "vlm":
            batch["img_embeds"] = jnp.zeros(
                (B, cfg.num_image_tokens, cfg.d_model), act)
        if cfg.family == "audio_encdec":
            batch["frames"] = jnp.zeros((B, P, cfg.d_model), act)
        tok, caches = prefill(params, batch)
        grow = lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, G), (0, 0), (0, 0)])
        caches = {"pos": caches["pos"], "layers": {
            r: dict(c, self=jax.tree.map(grow, c["self"])) if "self" in c
            else c for r, c in caches["layers"].items()}}
        out = [np.asarray(tok)]
        for _ in range(G):
            tok, caches = decode(params, caches, tok[:, None])
            out.append(np.asarray(tok))
        generated.append(np.stack(out, axis=1))
        pool.serve_tick()
        done += n
        pool.autoscale(reads_now=done * G, writes_now=0, budget=2.0,
                       spot_price=0.012, on_demand_price=0.042)
    return generated, pool


def _check_serve(arch, prompt_len):
    kw = dict(requests=20, batch=8, prompt_len=prompt_len, gen_len=6,
              revoke_p=0.5, seed=3)
    jcfg = j_get_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    params = init_tree(jax.random.PRNGKey(kw["seed"]),
                       JS.param_specs(jcfg, JRunConfig(**RUN)))
    model = tlm.from_numpy(jax.tree.map(np.asarray, params), tcfg,
                           RunConfig(**RUN), "cpu")
    want, jpool = _jax_serve(jcfg, JRunConfig(**RUN), params, **kw)
    got = tserve.serve(tcfg, RunConfig(**RUN), params=model, device="cpu",
                       **kw)
    assert len(got["generated"]) == len(want) == 3
    for i, (g, w) in enumerate(zip(got["generated"], want)):
        assert g.shape == (8, kw["gen_len"] + 1)
        np.testing.assert_array_equal(g, w, err_msg=f"batch {i}")
    assert (got["served"], got["rerouted"], got["replicas"]) == \
        (jpool.served, jpool.rerouted, len(jpool.alive))
    assert got["requests"] == 20 and got["tokens"] == 20 * kw["gen_len"]
    assert got["served"] < 20     # revoked replicas took queued requests


def test_serve_matches_the_jax_loop():
    _check_serve("smollm-360m", 16)


@pytest.mark.parametrize("prompt_len", [16, 8])
def test_mamba2_serve_matches_the_jax_loop(prompt_len):
    _check_serve("mamba2-130m", prompt_len)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "llama-3.2-vision-90b",
                                  "seamless-m4t-medium"])
def test_10d_serve_matches_the_jax_loop(arch):
    """The MoE, vision and encoder-decoder families, the context stubs
    (zero image embeddings or frames) fed as the reference loop feeds
    them.  With zero contexts the cross layers add nothing, so this
    holds the loop, the MoE layers and the caches' lifetimes to JAX;
    `test_torch_moe_cross.py` holds the cross and encoder paths with
    seeded contexts and drawn gates."""
    _check_serve(arch, 16)


def test_main_cli(capsys):
    args = tserve.parser().parse_args([])
    assert args.reduced is True and args.arch == "smollm-360m"
    assert tserve.parser().parse_args(["--no-reduced"]).reduced is False
    assert tserve.main(["--device", "cpu", "--requests", "4", "--batch",
                        "2", "--prompt-len", "8", "--gen-len", "2"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[serve] 4 requests, 8 tokens in ")



def test_request_trace_matches_jax():
    for kw in (dict(n=64, rate=8.0, seed=0), dict(n=500, burst=3.0,
                                                  key_space=77, seed=5)):
        want, got = j_trace(**kw), t_trace(**kw)
        for f in ("arrivals", "prompt_lens", "keys"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f)
