"""The port's LM against the JAX model on the CPU: the shared layer math,
weights carried across (`models.lm.from_numpy`, float32 and bfloat16
through the uint16 view), prefill logits and caches against JAX
`lm.forward(mode="prefill")` (for the dense model with
`attention_impl="pallas"` in interpret mode and `"xla"`), and decode
steps' logits and caches.

The dense model is smollm-360m reduced to 2 layers, with its heads set
to 6 over 2 KV heads so that the GQA group is 3, as at full width (15
over 5); the SSM model is mamba2-130m reduced to 2 layers (8 SSD heads
of 16 over a state of 16, chunk 16).  float32: logits within rtol/atol
1e-4 and greedy tokens equal; bfloat16: 3e-2, and for mamba2's logits
at most a share of 2e-3 outside 3e-2 and none beyond 0.1 (JAX's own
bf16 forward of these weights lands that far from its float32 forward:
up to 16 of 20,480 logits outside 3e-2, the largest 0.062, where the
port's `ssd_apply` keeps two products in float32 that JAX rounds to
bf16)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import RunConfig as JRunConfig
from repro.launch import steps as JS
from repro.launch.mesh import make_host_mesh
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.launch import steps as TS
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm

F32 = dict(param_dtype="float32", activation_dtype="float32")
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


MAMBA = "mamba2-130m"


def _cfgs(arch="smollm-360m"):
    kw = dict(num_heads=6, num_kv_heads=2) if arch == "smollm-360m" else {}
    j = dataclasses.replace(j_get_config(arch).reduced().with_layers(2), **kw)
    t = dataclasses.replace(get_config(arch).reduced().with_layers(2), **kw)
    return j, t


def _np_tree(tree):
    """A JAX tree as numpy, bfloat16 leaves as their uint16 bits."""
    def leaf(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a
    return jax.tree.map(leaf, tree)


def _models(dtype, seed=0, arch="smollm-360m", **run):
    jcfg, tcfg = _cfgs(arch)
    kw = dict(remat=False, param_dtype=dtype, activation_dtype=dtype, **run)
    jrun, trun = JRunConfig(**kw), RunConfig(**kw)
    params = jcommon.init_tree(jax.random.PRNGKey(seed),
                               JS.param_specs(jcfg, jrun))
    model = tlm.from_numpy(_np_tree(params), tcfg, trun, "cpu")
    return jcfg, jrun, params, tcfg, trun, model


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def test_layer_math_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    g = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(g))),
        rtol=1e-6, atol=1e-6)
    pos = np.array([[0, 3, 7, 100, 2047]] * 2, np.int32)
    np.testing.assert_allclose(
        tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           10_000.0).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      10_000.0)), rtol=1e-5, atol=1e-5)
    h = rng.standard_normal((3, 7, 32)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.2
          for s in ((32, 48), (32, 48), (48, 32))]
    np.testing.assert_allclose(
        tcommon.swiglu(torch.from_numpy(h),
                       *map(torch.from_numpy, ws)).numpy(),
        np.asarray(jcommon.swiglu(jnp.asarray(h), *map(jnp.asarray, ws))),
        rtol=1e-5, atol=1e-5)


def _check_carried(dtype, arch):
    jcfg, jrun, params, tcfg, trun, model = _models(dtype, arch=arch)
    specs = TS.param_specs(tcfg, trun)
    assert tcommon.param_count(specs) == jcommon.param_count(
        JS.param_specs(jcfg, jrun))
    assert tcommon.param_bytes(specs) == jcommon.param_bytes(
        JS.param_specs(jcfg, jrun))
    G = tcfg.num_layers
    for path, spec in tcommon.tree_items(specs):
        want = params
        for k in path:
            want = want[k]
        if path[0] == "blocks":
            got = torch.stack([getattr(getattr(model.blocks[g], path[2]),
                                       path[3]) for g in range(G)])
        else:
            got = getattr(model, path[0])
        assert got.dtype == spec.dtype, path
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32),
                                      err_msg="/".join(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_numpy_carries_jax_weights_exactly(dtype):
    _check_carried(dtype, "smollm-360m")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_from_numpy_carries_jax_weights_exactly(dtype):
    _check_carried(dtype, MAMBA)


def test_init_lm_fan_in_rule():
    _, tcfg = _cfgs()
    model = tlm.init_lm(tcfg, RunConfig(**F32), seed=3, device="cpu")
    wq = model.blocks[0].attn.wq
    assert wq.shape == (64, 6, 16) and wq.dtype == torch.float32
    assert abs(wq.std().item() - 1 / np.sqrt(6)) < 0.02     # fan-in = H
    assert abs(model.embed.std().item() - 1 / np.sqrt(256)) < 0.01
    assert torch.equal(model.final_norm, torch.ones(64))
    again = tlm.init_lm(tcfg, RunConfig(**F32), seed=3, device="cpu")
    assert torch.equal(again.embed, model.embed)


def _jax_prefill(jcfg, jrun, params, toks):
    mesh = make_host_mesh()
    rules = JS.resolve_rules(jcfg, "train")
    return jax.jit(lambda p, t: jlm.forward(p, t, jcfg, jrun, mesh, rules,
                                            mode="prefill"))(params, toks)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_prefill_logits_match_jax_f32(impl):
    jcfg, jrun, params, tcfg, trun, model = _models(
        "float32", attention_impl=impl)
    toks = np.random.default_rng(1).integers(0, 256, (2, 16)).astype(np.int32)
    jlogits, jcaches, _ = _jax_prefill(jcfg, jrun, params, jnp.asarray(toks))
    caches = tlm.alloc_caches(tcfg, 2, 16, torch.float32, "cpu")
    with torch.no_grad():
        logits, out, _ = tlm.forward(model, torch.from_numpy(toks),
                                     mode="prefill", caches=caches)
    assert out is caches                         # written in place
    assert logits.shape == (2, 16, tcfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **TOL["float32"])
    assert np.array_equal(logits.argmax(-1).numpy(),
                          np.asarray(jnp.argmax(jlogits, -1)))
    for n in ("k", "v"):
        np.testing.assert_allclose(caches["r0"]["self"][n].numpy(),
                                   np.asarray(jcaches["r0"]["self"][n]),
                                   **TOL["float32"])


def test_prefill_logits_match_jax_bf16():
    jcfg, jrun, params, tcfg, trun, model = _models(
        "bfloat16", attention_impl="pallas")
    toks = np.random.default_rng(2).integers(0, 256, (2, 16)).astype(np.int32)
    jlogits, jcaches, _ = _jax_prefill(jcfg, jrun, params, jnp.asarray(toks))
    caches = tlm.alloc_caches(tcfg, 2, 16, torch.bfloat16, "cpu")
    with torch.no_grad():
        logits, _, _ = tlm.forward(model, torch.from_numpy(toks),
                                   mode="prefill", caches=caches)
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(logits), _f32(jlogits),
                               **TOL["bfloat16"])
    # layer 0's K/V come straight from the carried weights; a deeper
    # layer's inherit the bf16 rounding of the attention under them (one
    # element in 2048 of layer 1 lands 0.035 off), which the logits'
    # tolerance above covers
    for n in ("k", "v"):
        np.testing.assert_allclose(_f32(caches["r0"]["self"][n][0]),
                                   _f32(jcaches["r0"]["self"][n][0]),
                                   **TOL["bfloat16"])


def test_decode_steps_match_jax_f32():
    """Prefill, grow to capacity, then three decode steps: logits, caches
    and greedy tokens against the JAX steps at every step.  The port
    writes its caches at capacity in place."""
    jcfg, jrun, params, tcfg, trun, model = _models("float32")
    mesh = make_host_mesh()
    jpre, _ = JS.make_prefill_step(jcfg, jrun, mesh)
    rules = JS.resolve_rules(jcfg, jrun.sharding_profile)
    B, P, G = 2, 12, 3
    toks = np.random.default_rng(4).integers(0, 256, (B, P)).astype(np.int32)
    jtok, jc = jax.jit(jpre)(params, {"tokens": jnp.asarray(toks)})
    jc = {"pos": jc["pos"], "layers": jax.tree.map(
        lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, G), (0, 0), (0, 0)]),
        jc["layers"])}

    @jax.jit
    def jdecode(p, c, t):
        logits, layers, _ = jlm.forward(p, t, jcfg, jrun, mesh, rules,
                                        mode="decode", caches=c["layers"],
                                        cache_len=c["pos"])
        return logits, {"pos": c["pos"] + 1, "layers": layers}

    layers = tlm.alloc_caches(tcfg, B, P + G, torch.float32, "cpu")
    ttok, tc = TS.make_prefill_step(tcfg, trun)(
        model, {"tokens": torch.from_numpy(toks)}, layers)
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    for _ in range(G):
        jlogits, jc = jdecode(params, jc, jnp.asarray(ttok.numpy())[:, None])
        with torch.no_grad():
            logits, tlayers, _ = tlm.forward(model, ttok[:, None].long(),
                                             mode="decode",
                                             caches=tc["layers"],
                                             cache_len=tc["pos"])
        tc = {"pos": tc["pos"] + 1, "layers": tlayers}
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL["float32"])
        ttok = logits[:, -1].argmax(-1).to(torch.int32)
        assert np.array_equal(ttok.numpy(),
                              np.asarray(jnp.argmax(jlogits[:, -1], -1)))
        for n in ("k", "v"):
            np.testing.assert_allclose(
                tc["layers"]["r0"]["self"][n].numpy(),
                np.asarray(jc["layers"]["r0"]["self"][n]), **TOL["float32"])
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_every_dense_config_builds_specs_like_jax():
    """Full width, specs only: the dense configs and the five of ROADMAP
    item 10d (MoE, cross-attention, the encoder-decoder, the Jamba
    hybrid): parameter count and leaf paths, and the caches' leaf paths
    and shapes (the cross caches included) equal JAX's."""
    for arch in ("llama3.2-1b", "qwen2.5-3b", "smollm-360m", "qwen3-8b",
                 "qwen2-moe-a2.7b", "qwen3-moe-30b-a3b",
                 "llama-3.2-vision-90b", "seamless-m4t-medium",
                 "jamba-1.5-large-398b"):
        tspec = TS.param_specs(get_config(arch), RunConfig())
        jspec = JS.param_specs(j_get_config(arch), JRunConfig())
        assert tcommon.param_count(tspec) == jcommon.param_count(jspec), arch
        assert [p for p, _ in tcommon.tree_items(tspec)] == \
            [tuple(k.key for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(
                 jspec, is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))[0]]
        tcache = tlm.cache_specs(get_config(arch), 2, 96)
        jcache = jlm.cache_specs(j_get_config(arch), 2, 96)
        assert [(p, s.shape) for p, s in tcommon.tree_items(tcache)] == \
            [(tuple(k.key for k in path), tuple(s.shape)) for path, s in
             jax.tree_util.tree_flatten_with_path(
                 jcache, is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))[0]]


def test_decode_state_specs_match_jax():
    from repro.configs.base import SHAPES_BY_NAME as J_SHAPES
    from repro_torch.configs import SHAPES_BY_NAME
    tcfg, jcfg = get_config("smollm-360m"), j_get_config("smollm-360m")
    got = TS.decode_state_specs(tcfg, SHAPES_BY_NAME["decode_32k"],
                                RunConfig())
    want = JS.decode_state_specs(jcfg, J_SHAPES["decode_32k"], JRunConfig())
    assert got["pos"].shape == want["pos"].shape
    assert got["layers"]["r0"]["self"]["k"].shape == \
        want["layers"]["r0"]["self"]["k"].shape == (32, 128, 32768, 5, 64)
    assert got["layers"]["r0"]["self"]["v"].dtype == torch.bfloat16


# --------------------------------------------------------------------- #
# mamba2: SSD layers, no MLP, a separate head
# --------------------------------------------------------------------- #
SSM_LEAVES = ("ssm", "conv_x", "conv_B", "conv_C")


def _ssm_caches_close(got, want, **tol):
    for n in SSM_LEAVES:
        a, b = got["r0"]["ssm"][n], want["r0"]["ssm"][n]
        assert a.shape == b.shape, n
        np.testing.assert_allclose(_f32(a), _f32(b), **tol, err_msg=n)


def _bf16_logits_close(got, want):
    """At most a share of 2e-3 of the logits outside 3e-2, none beyond
    0.1 (the module docstring gives the reason)."""
    a, b = _f32(got), _f32(want)
    tol = TOL["bfloat16"]["atol"]
    outside = np.abs(a - b) > tol + tol * np.abs(b)
    assert outside.mean() <= 2e-3, (outside.sum(), outside.size)
    assert np.abs(a - b).max() <= 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_prefill_matches_jax(dtype):
    """A 40-token prompt (chunk 16: two full chunks and a ragged one):
    logits and every cache leaf against JAX's prefill."""
    jcfg, jrun, params, tcfg, trun, model = _models(dtype, arch=MAMBA)
    toks = np.random.default_rng(2).integers(0, 256, (2, 40)).astype(np.int32)
    jlogits, jcaches, _ = _jax_prefill(jcfg, jrun, params, jnp.asarray(toks))
    caches = tlm.alloc_caches(tcfg, 2, 40, DTYPE[dtype], "cpu")
    assert caches["r0"]["ssm"]["ssm"].dtype == torch.float32
    assert caches["r0"]["ssm"]["conv_x"].dtype == DTYPE[dtype]
    with torch.no_grad():
        logits, out, _ = tlm.forward(model, torch.from_numpy(toks),
                                     mode="prefill", caches=caches)
    assert out is caches and logits.dtype == DTYPE[dtype]
    assert logits.shape == (2, 40, tcfg.padded_vocab)
    if dtype == "float32":
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL["float32"])
        assert np.array_equal(logits.argmax(-1).numpy(),
                              np.asarray(jnp.argmax(jlogits, -1)))
    else:
        _bf16_logits_close(logits, jlogits)
    _ssm_caches_close(caches, jcaches, **TOL[dtype])


def test_mamba2_decode_steps_match_jax_f32():
    """Prefill, then three decode steps from the prefill's states (the
    SSM caches have no sequence axis, so nothing grows): logits, greedy
    tokens and every cache leaf against the JAX steps at every step."""
    jcfg, jrun, params, tcfg, trun, model = _models("float32", arch=MAMBA)
    mesh = make_host_mesh()
    jpre, _ = JS.make_prefill_step(jcfg, jrun, mesh)
    jdec, _ = JS.make_decode_step(jcfg, jrun, mesh)
    B, P, G = 2, 21, 3
    toks = np.random.default_rng(4).integers(0, 256, (B, P)).astype(np.int32)
    jtok, jc = jax.jit(jpre)(params, {"tokens": jnp.asarray(toks)})
    rules = JS.resolve_rules(jcfg, jrun.sharding_profile)

    @jax.jit
    def jlogits_of(p, c, t):
        return jlm.forward(p, t, jcfg, jrun, mesh, rules, mode="decode",
                           caches=c["layers"], cache_len=c["pos"])[0]

    layers = tlm.alloc_caches(tcfg, B, P + G, torch.float32, "cpu")
    ttok, tc = TS.make_prefill_step(tcfg, trun)(
        model, {"tokens": torch.from_numpy(toks)}, layers)
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    _ssm_caches_close(tc["layers"], jc["layers"], **TOL["float32"])
    for _ in range(G):
        t_in = jnp.asarray(ttok.numpy())[:, None]
        jlogits = jlogits_of(params, jc, t_in)
        jtok, jc = jax.jit(jdec)(params, jc, t_in)
        with torch.no_grad():              # updates the caches in place
            logits, layers, _ = tlm.forward(model, ttok[:, None].long(),
                                            mode="decode",
                                            caches=tc["layers"],
                                            cache_len=tc["pos"])
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL["float32"])
        ttok = logits[:, -1].argmax(-1).to(torch.int32)
        tc = {"pos": tc["pos"] + 1, "layers": layers}
        assert np.array_equal(ttok.numpy(), np.asarray(jtok))
        _ssm_caches_close(tc["layers"], jc["layers"], **TOL["float32"])
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_mamba2_specs_match_jax():
    """Full width: the parameter tree (167,788,992 parameters) and the
    decode-state tree match JAX's leaf for leaf."""
    from repro.configs.base import SHAPES_BY_NAME as J_SHAPES
    from repro_torch.configs import SHAPES_BY_NAME
    tcfg, jcfg = get_config(MAMBA), j_get_config(MAMBA)
    tspec = TS.param_specs(tcfg, RunConfig())
    jspec = JS.param_specs(jcfg, JRunConfig())
    assert tcommon.param_count(tspec) == jcommon.param_count(jspec) == \
        167_788_992
    assert tcommon.param_bytes(tspec) == jcommon.param_bytes(jspec)
    got = TS.decode_state_specs(tcfg, SHAPES_BY_NAME["decode_32k"],
                                RunConfig())
    want = JS.decode_state_specs(jcfg, J_SHAPES["decode_32k"], JRunConfig())
    flat = lambda t: [(p, s.shape) for p, s in tcommon.tree_items(t)]
    jflat = [(tuple(k.key for k in path), tuple(s.shape)) for path, s in
             jax.tree_util.tree_flatten_with_path(
                 want, is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))[0]]
    assert flat(got) == jflat
    assert got["layers"]["r0"]["ssm"]["ssm"].dtype == torch.float32
    assert got["layers"]["r0"]["ssm"]["conv_x"].dtype == torch.bfloat16
