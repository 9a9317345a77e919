"""MoE, cross-attention and the encoder-decoder in the port against the
JAX model on the CPU (ROADMAP.md §1 item 10d).

- `models.moe`: `moe_apply_dense` and `moe_apply` with no mesh against
  JAX's `moe_apply` on its host mesh (expert axis 1, so the dense path),
  for the reduced qwen2-moe (shared experts) and qwen3-moe (8 experts,
  top-2): outputs and aux loss within TOL, router ids exact, a zero
  token (a uniform router row, where `lax.top_k` takes the lowest ids)
  included (the expert-parallel forms: `tests/test_torch_moe_ep.py`).
- Parameter and cache specs of the five 10d configs at full width
  (free: no tensor is made) equal JAX's leaf for leaf.
- Reduced models, float32 unless stated: prefill logits and caches,
  then 4 decode steps (tokens exact, logits and caches within TOL), for
  qwen2-moe, llama-3.2-vision and seamless-m4t; one bfloat16 prefill
  (qwen2-moe: the reduced cross-attention models are chaotic in bf16,
  as its docstring says);
  Jamba (SSD, attention and MoE layers); `loss_fn` with the 0.01-weighted
  aux loss; the non-causal attention forms, and the encoder past the
  S·T = 2**22 switch to chunked attention.

JAX initializes `xattn_gate` to zeros, and tanh(0) = 0 makes every cross
layer add nothing; zero image embeddings or frames make the encoder's
output and the cross K/V zero.  A test on those would pass with the
cross and encoder paths wrong or missing, so every model-level test here
draws the gates from a normal distribution and makes the contexts from a
seed.  TOL as in `test_torch_models.py`."""
from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import RunConfig as JRunConfig
from repro.launch import steps as JS
from repro.launch.mesh import make_host_mesh
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.sharding.axes import make_constrainer
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.launch import steps as TS
from repro_torch.launch.serve import draw_gates, seeded_context
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
TEN_D = ("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b", "llama-3.2-vision-90b",
         "seamless-m4t-medium", "jamba-1.5-large-398b")
SERVED = ("qwen2-moe-a2.7b", "llama-3.2-vision-90b", "seamless-m4t-medium")


def _np(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _models(arch, dtype="float32", seed=0, **run):
    jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    kw = dict(remat=False, param_dtype=dtype, activation_dtype=dtype, **run)
    jrun, trun = JRunConfig(**kw), RunConfig(**kw)
    params = jcommon.init_tree(jax.random.PRNGKey(seed),
                               JS.param_specs(jcfg, jrun))
    model = draw_gates(tlm.from_numpy(jax.tree.map(_np, params), tcfg,
                                      trun, "cpu"), seed + 100)
    # the drawn gates into the JAX tree, stacked as it stacks them
    tree = tlm.to_tree(model, dict(model.named_parameters()))
    for r, part in tree["blocks"].items():
        if "xattn_gate" in part:
            blk = params["blocks"][r]
            blk["xattn_gate"] = jnp.asarray(
                part["xattn_gate"].detach().float().numpy(),
                blk["xattn_gate"].dtype)
    return jcfg, jrun, params, tcfg, trun, model


def _jbatch(batch, dtype):
    return {k: jnp.asarray(v, dtype if k != "tokens" else jnp.int32)
            for k, v in batch.items()}


def _tbatch(batch, dtype):
    return {k: torch.from_numpy(v).to(dtype if k != "tokens"
                                      else torch.int32)
            for k, v in batch.items()}


# --------------------------------------------------------------------- #
# models/moe.py
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"])
def test_moe_matches_jax(arch):
    jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    assert tcfg.moe_num_experts == 8 and tcfg.moe_top_k == 2
    p = jcommon.init_tree(jax.random.PRNGKey(5),
                          jmoe.moe_params(jcfg, jnp.float32))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    assert set(tp) == set(tmoe.moe_params(tcfg, torch.float32))
    x = np.random.default_rng(6).standard_normal((2, 7, 64)).astype(
        np.float32)
    x[1, 3] = 0.0                      # a uniform router row: a k-way tie
    jy, jaux = jmoe.moe_apply(p, jnp.asarray(x), jcfg, make_host_mesh())
    jw, jids, _ = jmoe._route(jnp.asarray(x.reshape(-1, 64)), p["router"],
                              jcfg)
    xt = torch.from_numpy(x)
    tw, tids, _ = tmoe._route(xt.reshape(-1, 64), tp["router"], tcfg)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert tids[1 * 7 + 3].tolist() == [0, 1]      # lowest ids first
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL["float32"])
    host = types.SimpleNamespace(shape={"data": 1, "model": 1})
    for y, aux in (tmoe.moe_apply_dense(tp, xt, tcfg),
                   tmoe.moe_apply(tp, xt, tcfg),
                   tmoe.moe_apply(tp, xt, tcfg, host)):
        assert y.shape == (2, 7, 64) and aux.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), np.asarray(jy),
                                   **TOL["float32"])
        np.testing.assert_allclose(aux.item(), float(jaux),
                                   **TOL["float32"])


# --------------------------------------------------------------------- #
# specs at full width
# --------------------------------------------------------------------- #
def _jflat(tree):
    return [(tuple(k.key for k in path), tuple(s.shape),
             jnp.dtype(s.dtype).name)
            for path, s in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))[0]]


def _tflat(tree):
    return [(path, tuple(s.shape), str(s.dtype).replace("torch.", ""))
            for path, s in tcommon.tree_items(tree)]


@pytest.mark.parametrize("arch", TEN_D)
def test_10d_specs_and_caches_match_jax(arch):
    """Full width, specs only: every parameter leaf and every cache leaf
    (the cross caches included) has JAX's path, shape and dtype."""
    tcfg, jcfg = get_config(arch), j_get_config(arch)
    tspec = TS.param_specs(tcfg, RunConfig())
    jspec = JS.param_specs(jcfg, JRunConfig())
    assert _tflat(tspec) == _jflat(jspec)
    assert tcommon.param_count(tspec) == jcommon.param_count(jspec)
    assert _tflat(tlm.cache_specs(tcfg, 2, 96)) == \
        _jflat(jlm.cache_specs(jcfg, 2, 96))


# --------------------------------------------------------------------- #
# weights carried across
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", TEN_D)
def test_from_numpy_carries_10d_leaves(arch):
    """bfloat16 weights (float32 gates, routers and norms): every leaf of
    the JAX tree, the encoder's, the cross layers' and the experts'
    included, lands bit for bit, and `to_tree` / `from_tree` map the
    parameters to that tree and back."""
    jcfg, jrun, params, tcfg, trun, model = _models(arch, "bfloat16")
    named = dict(model.named_parameters())
    tree = tlm.to_tree(model, {n: p.detach() for n, p in named.items()})
    n_leaves = 0
    for path, spec in tcommon.tree_items(TS.param_specs(tcfg, trun)):
        want, got = params, tree
        for k in path:
            want, got = want[k], got[k]
        assert got.dtype == spec.dtype and tuple(got.shape) == spec.shape
        np.testing.assert_array_equal(_f32(got), _f32(want),
                                      err_msg="/".join(path))
        n_leaves += 1
    back = tlm.from_tree(model, tree)
    assert sorted(back) == sorted(named)
    assert all(torch.equal(back[n], named[n]) for n in named)
    assert n_leaves == len(jax.tree.leaves(params))


# --------------------------------------------------------------------- #
# prefill and decode
# --------------------------------------------------------------------- #
def _jax_steps(jcfg, jrun):
    mesh = make_host_mesh()
    rules = JS.resolve_rules(jcfg, "train")

    @jax.jit
    def prefill(p, b):
        return jlm.forward(p, b["tokens"], jcfg, jrun, mesh, rules,
                           mode="prefill", img_embeds=b.get("img_embeds"),
                           frames=b.get("frames"))

    @jax.jit
    def decode(p, layers, pos, t):
        return jlm.forward(p, t, jcfg, jrun, mesh, rules, mode="decode",
                           caches=layers, cache_len=pos)[:2]
    return prefill, decode


def _caches_close(got, want, dtype):
    """Every leaf of the JAX caches against the port's, the port's
    longer cross cache (the capacity, for an encoder's output) compared
    over JAX's length and zero past it."""
    n = 0
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for k in path:
            g = g[k.key]
        w = np.asarray(w)
        if g.shape != w.shape:
            assert path[1].key == "cross" and g.shape[2] > w.shape[2]
            assert not _f32(g[:, :, w.shape[2]:]).any()
            g = g[:, :, :w.shape[2]]
        np.testing.assert_allclose(_f32(g), w.astype(np.float32),
                                   **TOL[dtype],
                                   err_msg="/".join(k.key for k in path))
        n += 1
    return n


@pytest.mark.parametrize("arch", SERVED + ("jamba-1.5-large-398b",))
def test_prefill_and_decode_match_jax(arch):
    """Prefill (B = 2, P = 12) with a seeded context, then 4 decode steps
    fed the port's greedy tokens: logits and every cache leaf within
    TOL, tokens equal, at every step."""
    jcfg, jrun, params, tcfg, trun, model = _models(arch)
    B, P, G = 2, 12, 4
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, 256, (B, P)).astype(np.int32),
             **{n: c.numpy() for n, c in
                seeded_context(tcfg, B, P, 8).items()}}
    jpre, jdec = _jax_steps(jcfg, jrun)
    jlogits, jlayers, jaux = jpre(params, _jbatch(batch, jnp.float32))
    # the JAX serve loop's growth of the self caches to capacity
    jlayers = {r: {n: (jax.tree.map(lambda x: jnp.pad(
        x, [(0, 0), (0, 0), (0, G), (0, 0), (0, 0)]), c)
        if n == "self" else c) for n, c in cs.items()}
        for r, cs in jlayers.items()}
    layers = tlm.alloc_caches(tcfg, B, P + G, torch.float32, "cpu")
    with torch.no_grad():
        logits, _, aux = tlm.forward(
            model, torch.from_numpy(batch["tokens"]), mode="prefill",
            caches=layers, cache_len=None, runcfg=trun,
            img_embeds=_tbatch(batch, torch.float32).get("img_embeds"),
            frames=_tbatch(batch, torch.float32).get("frames"))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **TOL["float32"])
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL["float32"])
    if tcfg.moe_num_experts:
        assert aux.item() > 0
    assert _caches_close(layers, jlayers, "float32") >= 2
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    assert np.array_equal(tok.numpy(), np.asarray(jnp.argmax(jlogits[:, -1],
                                                             -1)))
    jpos = jnp.full((B,), P, jnp.int32)
    pos = torch.full((B,), P, dtype=torch.int32)
    for _ in range(G):
        jlogits, jlayers = jdec(params, jlayers, jpos,
                                jnp.asarray(tok.numpy())[:, None])
        with torch.no_grad():
            logits, _, _ = tlm.forward(model, tok[:, None], mode="decode",
                                       caches=layers, cache_len=pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL["float32"])
        tok = logits[:, -1].argmax(-1).to(torch.int32)
        assert np.array_equal(tok.numpy(),
                              np.asarray(jnp.argmax(jlogits[:, -1], -1)))
        _caches_close(layers, jlayers, "float32")
        jpos, pos = jpos + 1, pos + 1


def test_moe_prefill_matches_jax_bf16():
    """The reduced qwen2-moe in bfloat16 (weights, activations; the
    router in float32 as in JAX), JAX's causal attention on its Pallas
    kernel (interpret mode) as in `test_torch_models.py`'s bf16 case:
    prefill logits, the aux loss and the caches within the bf16 TOL.

    The reduced cross-attention models are not held to JAX in bfloat16:
    JAX's own bfloat16 prefill of them lands up to 1.17 (vision, 5
    layers) and 1.38 (seamless, the 2-layer encoder) from its float32
    prefill of the same weights, the port's as far, and the two bf16
    runs up to 0.48 and 0.21 apart: the JAX fan-in rule gives wq a std
    of 1/sqrt(H), so random attention is nearly one-hot and a bf16
    rounding moves which key a row attends to.  They are held to JAX in
    float32 above, and on the card against the CPU in bfloat16."""
    arch = "qwen2-moe-a2.7b"
    jcfg, jrun, params, tcfg, trun, model = _models(
        arch, "bfloat16", attention_impl="pallas")
    toks = np.random.default_rng(8).integers(0, 256, (2, 16)).astype(
        np.int32)
    jpre, _ = _jax_steps(jcfg, jrun)
    jlogits, jlayers, jaux = jpre(params, {"tokens": jnp.asarray(toks)})
    layers = tlm.alloc_caches(tcfg, 2, 16, torch.bfloat16, "cpu")
    with torch.no_grad():
        logits, _, aux = tlm.forward(model, torch.from_numpy(toks),
                                     mode="prefill", caches=layers,
                                     cache_len=None, runcfg=trun,
                                     img_embeds=None, frames=None)
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(logits), _f32(jlogits),
                               **TOL["bfloat16"])
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL["bfloat16"])
    assert _caches_close(layers, jlayers, "bfloat16") == 2


def test_moe_loss_fn_matches_jax():
    """`loss_fn` of the reduced qwen2-moe: total = loss + 0.01 aux, each
    of the three within TOL of JAX's."""
    arch = "qwen2-moe-a2.7b"
    jcfg, jrun, params, tcfg, trun, model = _models(arch)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, 256, (2, 16)).astype(np.int32)
    labels = rng.integers(0, 256, (2, 16)).astype(np.int32)
    rules = JS.resolve_rules(jcfg, "train")
    jtot, (jloss, jaux) = jax.jit(lambda p, b: jlm.loss_fn(
        p, b, jcfg, jrun, make_host_mesh(), rules))(
        params, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    tot, (loss, aux) = tlm.loss_fn(model, {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)},
        trun)
    for got, want in ((tot, jtot), (loss, jloss), (aux, jaux)):
        np.testing.assert_allclose(got.item(), float(want), **TOL["float32"])
    assert aux.item() > 0
    np.testing.assert_allclose(tot.item(), loss.item() + 0.01 * aux.item(),
                               rtol=1e-6)


# --------------------------------------------------------------------- #
# non-causal attention
# --------------------------------------------------------------------- #
def test_noncausal_attention_forms_match_jax():
    """`full_attention` (not causal; causal with the bottom-right mask at
    S < T; causal by positions) and `chunked_attention(causal=False)`
    over a ragged last chunk, against JAX's."""
    rng = np.random.default_rng(10)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    v = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    qp = np.array([[4, 5, 6, 7, 8], [0, 2, 4, 6, 8]], np.int32)
    kp = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    T = lambda a: torch.from_numpy(a)
    J = jnp.asarray
    for kw in (dict(causal=False), dict(causal=True),
               dict(causal=True, q_pos=qp, k_pos=kp),
               dict(causal=False, q_pos=qp, k_pos=kp)):
        tkw = {n: T(a) if isinstance(a, np.ndarray) else a
               for n, a in kw.items()}
        jkw = {n: J(a) if isinstance(a, np.ndarray) else a
               for n, a in kw.items()}
        np.testing.assert_allclose(
            tattn.full_attention(T(q), T(k), T(v), **tkw).numpy(),
            np.asarray(jattn.full_attention(J(q), J(k), J(v), **jkw)),
            rtol=1e-5, atol=1e-5, err_msg=str(kw))
    np.testing.assert_allclose(
        tattn.chunked_attention(T(q), T(k), T(v), q_pos=T(qp), k_pos=T(kp),
                                causal=False, chunk_k=4).numpy(),
        np.asarray(jattn.chunked_attention(J(q), J(k), J(v), q_pos=J(qp),
                                           k_pos=J(kp), causal=False,
                                           chunk_k=4)),
        rtol=1e-5, atol=1e-5)


def test_encoder_past_the_chunked_switch_matches_jax():
    """The reduced seamless encoder over 2,100 seeded frames: S·S =
    4,410,000 > 2**22, so both sides take chunked attention (chunks of
    1,024 keys, the last ragged).  Softmax over thousands of keys of
    this random model's nearly one-hot attention magnifies float32
    rounding: JAX's own float32 encoder lands 2.1e-4 from a float64 run
    of the port's (the port's 1.3e-4), so the two are held to 5e-4 of
    each other, and the port to no further from float64 than twice
    JAX's distance."""
    import copy
    arch = "seamless-m4t-medium"
    jcfg, jrun, params, tcfg, trun, model = _models(arch)
    jrun, trun = jrun.replace(attn_chunk_k=1024), trun.replace(
        attn_chunk_k=1024)
    frames = np.random.default_rng(11).standard_normal((1, 2100, 64))
    mesh = make_host_mesh()
    cn = make_constrainer(JS.resolve_rules(jcfg, "train"), mesh)
    want = np.asarray(jax.jit(
        lambda p, f: jlm.encode(p, f, jcfg, jrun, mesh, cn))(
        params, jnp.asarray(frames, jnp.float32)))
    with torch.no_grad():
        got = tlm.encode(model, torch.from_numpy(frames).float(),
                         trun).numpy()
        exact = tlm.encode(copy.deepcopy(model).double(),
                           torch.from_numpy(frames), trun).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)
    assert np.abs(got - exact).max() <= 2 * np.abs(want - exact).max()
