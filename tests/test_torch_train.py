"""The port's training path against the JAX package's on the CPU: the
token pipeline and `rw_mix` (bit for bit: one numpy generator),
`cross_entropy` over a padded vocab, AdamW, the training attention with
its input gradients, and `make_train_step` from the same carried weights
and optimizer state (`from_numpy`, `opt_from_numpy`).

Tolerances, float32: `cross_entropy` and the attention rtol/atol 1e-5;
AdamW's grad_norm and float32 parameters rtol 1e-6, m and v rtol 1e-5
(the clip scale divides by a norm whose sum XLA orders otherwise) and
its bfloat16 parameters within one bf16 rounding (2**-8 relative; XLA
and torch may round a float32 value on a rounding edge apart); the train
step's loss rtol 1e-5 and grad_norm 1e-4, each gradient leaf within 2e-4
of its largest magnitude (the reduced dense models' random attention is
peaked and amplifies float32 rounding: up to 7e-5 of a leaf's largest
gradient, 1.3e-5 of the norm), and the parameters
after 2 steps within 2e-5 except where AdamW's normalized first step
flips with the sign of a gradient of rounding size: at most 1e-3 of a
leaf's elements, and none beyond 4 x lr.  bfloat16: see
`test_train_step_bfloat16_equals_jax`.  remat must not change a number: the port's steps with remat on
and off are equal bit for bit.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import RunConfig as JRunConfig
from repro.data import pipeline as jpipe
from repro.launch import steps as JS
from repro.launch.mesh import make_host_mesh
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.optim import adamw as jadamw
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import steps as TS
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as tadamw

LR = RunConfig().learning_rate


def np_tree(tree):
    """A JAX tree as numpy, bfloat16 leaves as their uint16 bits."""
    def leaf(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a
    return jax.tree.map(leaf, tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k]
    return tree


# --------------------------------------------------------------------- #
# data/pipeline.py
# --------------------------------------------------------------------- #
def test_token_pipeline_equals_jax():
    """Steps 0-3 over 1 and 2 shards, with an extra, bit for bit."""
    cfg = dict(vocab_size=300, seq_len=17, global_batch=4, seed=3)
    j = jpipe.TokenPipeline(jpipe.DataConfig(**cfg))
    t = tpipe.TokenPipeline(tpipe.DataConfig(**cfg))
    ex = {"frames": np.linspace(0, 1, 24, dtype=np.float32).reshape(2, 12)}
    for step in range(4):
        for n in (1, 2):
            for shard in range(n):
                jb = j.batch_at(step, shard=shard, num_shards=n, extras=ex)
                tb = t.batch_at(step, shard=shard, num_shards=n, extras=ex,
                                device="cpu")
                assert set(jb) == set(tb)
                for k in jb:
                    a, b = np.asarray(jb[k]), tb[k].numpy()
                    assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_rw_mix_equals_jax():
    jt = jpipe.google_trace_like(500, seed=2)
    tt = tpipe.google_trace_like(500, seed=2)
    for alpha, seed in ((0.0, 0), (0.3, 1), (0.9, 7), (1.0, 2)):
        a, b = jpipe.rw_mix(jt, alpha, seed), tpipe.rw_mix(tt, alpha, seed)
        assert a.dtype == b.dtype and np.array_equal(a, b)


# --------------------------------------------------------------------- #
# models/common.py, models/attention.py
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("vocab,padded", [(200, 256), (256, 256)])
def test_cross_entropy_equals_jax(vocab, padded):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 7, padded)) * 3).astype(np.float32)
    labels = rng.integers(0, vocab, (2, 7)).astype(np.int32)
    jl, jg = jax.value_and_grad(jcommon.cross_entropy)(
        jnp.asarray(logits), jnp.asarray(labels), vocab)
    x = torch.tensor(logits, requires_grad=True)
    tl = tcommon.cross_entropy(x, torch.from_numpy(labels), vocab)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)
    assert not x.grad[..., vocab:].any()


@pytest.mark.parametrize("S,cq,ck,dtype,acc", [
    (40, 2048, 2048, "float32", "float32"),
    (40, 16, 16, "float32", "float32"),     # neither chunk divides S
    (40, 24, 16, "float32", "float32"),
    (40, 16, 32, "float32", "float32"),
    (33, 16, 8, "bfloat16", "float32"),
    (33, 16, 8, "float32", "bfloat16"),
])
def test_causal_blocked_attention_equals_jax(S, cq, ck, dtype, acc):
    """Output and q/k/v gradients (of a random projection of the output)
    against `jax.grad`; bfloat16 inputs or intermediates within 2e-2."""
    rng = np.random.default_rng(1)
    B, H, hd = 2, 4, 16
    q, k, v, w = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
                  for _ in range(4))
    jdt = jnp.dtype(dtype)
    jin = [jnp.asarray(a, jdt) for a in (q, k, v)]

    def jf(q, k, v):
        o = jattn.causal_blocked_attention(q, k, v, chunk_q=cq, chunk_k=ck,
                                           acc_dtype=jnp.dtype(acc))
        return jnp.sum(o.astype(jnp.float32) * w), o

    (_, jo), jg = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                     has_aux=True)(*jin)
    tdt = tcommon.DTYPES[dtype]
    tin = [torch.tensor(a).to(tdt).requires_grad_() for a in (q, k, v)]
    to = tattn.causal_blocked_attention(*tin, chunk_q=cq, chunk_k=ck,
                                        acc_dtype=tcommon.DTYPES[acc])
    tg = torch.autograd.grad((to.float() * torch.from_numpy(w)).sum(), tin)
    tol = 1e-5 if dtype == acc == "float32" else 2e-2
    assert to.dtype == tdt
    np.testing.assert_allclose(_f32(to), _f32(jo), rtol=tol, atol=tol)
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(_f32(b), _f32(a), rtol=tol, atol=tol)


@pytest.mark.parametrize("S,dtype", [(40, "float32"), (16, "float32"),
                                     (40, "bfloat16")])
def test_ssd_chunked_equals_jax(S, dtype):
    """The training scan against JAX's `ssd_apply` (reduced mamba2-130m
    widths, chunk 16; S = 40 pads a ragged last chunk): output and the
    gradients of every SSD parameter and of x, float32 rtol/atol 1e-5,
    bfloat16 3e-2 (one bf16 rounding of a product apart)."""
    from repro.models import ssd as jssd
    from repro_torch.models import ssd as tssd
    jcfg = j_get_config("mamba2-130m").reduced()
    tcfg = get_config("mamba2-130m").reduced()
    jdt = jnp.dtype(dtype)
    specs = jssd.ssd_params(jcfg, jdt)
    params = _init_params(specs, seed=2)
    params["A_log"] = jnp.asarray(np.linspace(-1, 1, jcfg.ssm_heads),
                                  jnp.float32)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)

    def jf(p, x):
        y = jssd.ssd_apply(p, x, jcfg)[0]
        return jnp.sum(y.astype(jnp.float32) * w), y
    (_, jy), jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1),
                                             has_aux=True))(
        params, jnp.asarray(x, jdt))
    tp = {k: torch.from_numpy(np.array(_f32(v))).to(
        tcommon.DTYPES[jnp.dtype(v.dtype).name]).requires_grad_()
        for k, v in params.items()}
    tx = torch.tensor(x).to(tcommon.DTYPES[dtype]).requires_grad_()
    ty = tssd.ssd_chunked(tp, tx, tcfg)
    keys = sorted(k for k in tp if k != "pre_norm")   # the caller's norm
    tg = torch.autograd.grad((ty.float() * torch.from_numpy(w)).sum(),
                             [tp[k] for k in keys] + [tx])
    tol = 1e-5 if dtype == "float32" else 3e-2
    assert ty.dtype == tx.dtype
    np.testing.assert_allclose(_f32(ty), _f32(jy), rtol=tol, atol=tol)
    for a, b in zip([jg[0][k] for k in keys] + [jg[1]], tg):
        scale = np.abs(_f32(a)).max()
        np.testing.assert_allclose(_f32(b), _f32(a), rtol=tol,
                                   atol=tol * max(scale, 1.0))


def test_pallas_attention_cannot_train():
    cfg = get_config("smollm-360m").reduced()
    run = RunConfig(attention_impl="pallas", param_dtype="float32",
                    activation_dtype="float32")
    model = tlm.init_lm(cfg, run, device="cpu", trainable=True)
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32),
             "labels": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(ValueError, match="no backward"):
        tlm.loss_fn(model, batch, run)


# --------------------------------------------------------------------- #
# optim/adamw.py
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_adamw_equals_jax(clip):
    """3 steps over a mixed float32/bfloat16 tree (one leaf's gradient
    large enough to clip), the same gradients on both sides: params, m,
    v, step and grad_norm."""
    rng = np.random.default_rng(4)
    shapes = {"a": (5, 7), "b": (13,), "c": (3, 4, 2)}
    dts = {"a": jnp.float32, "b": jnp.bfloat16, "c": jnp.bfloat16}
    jp = {n: jnp.asarray(rng.standard_normal(s), dts[n])
          for n, s in shapes.items()}
    tp = {n: torch.from_numpy(np.array(_f32(a))).to(
        tcommon.DTYPES[jnp.dtype(dts[n]).name]) for n, a in jp.items()}
    jo, to = jadamw.init_opt_state(jp), tadamw.init_opt_state(tp)
    kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=clip)
    for i in range(3):
        g = {n: rng.standard_normal(s) * (4.0 if n == "a" else 0.3)
             for n, s in shapes.items()}
        jg = {n: jnp.asarray(a, dts[n]) for n, a in g.items()}
        tg = {n: torch.from_numpy(np.array(_f32(a))).to(tp[n].dtype)
              for n, a in jg.items()}
        jp, jo, jm = jadamw.adamw_update(jp, jg, jo, **kw)
        tp, to, tm = tadamw.adamw_update(tp, tg, to, **kw)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert int(to["step"]) == int(jo["step"]) == i + 1
        for n in shapes:
            assert tp[n].dtype == tcommon.DTYPES[jnp.dtype(dts[n]).name]
            rt = 1e-6 if dts[n] == jnp.float32 else 2 ** -8
            np.testing.assert_allclose(_f32(tp[n]), _f32(jp[n]), rtol=rt,
                                       atol=1e-7, err_msg=f"{n} step {i}")
            for mv in ("m", "v"):
                np.testing.assert_allclose(_f32(to[mv][n]), _f32(jo[mv][n]),
                                           rtol=1e-5, atol=1e-12)
    if clip:
        assert float(jm["grad_norm"]) > clip


# --------------------------------------------------------------------- #
# launch/steps.py: make_train_step
# --------------------------------------------------------------------- #
def _init_params(specs, seed=0):
    """JAX `init_tree`'s fan-in rule with numpy's generator (no XLA
    compile per leaf shape)."""
    rng = np.random.default_rng(seed)

    def one(p):
        if p.init in ("zeros", "ones"):
            return jnp.full(p.shape, p.init == "ones", p.dtype)
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        a = rng.standard_normal(p.shape).astype(np.float32)
        return jnp.asarray(a * np.float32(p.scale / np.sqrt(fan_in)),
                           p.dtype)
    return jax.tree.map(one, specs,
                        is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))


def _setup(arch, dtype, M, **run):
    """2 layers, or one period where a period is longer (the vision
    model's 5); the cross layers' gates drawn (zero gates leave the
    cross and encoder paths dead)."""
    n = max(2, get_config(arch).layer_period)
    jcfg = j_get_config(arch).reduced().with_layers(n)
    tcfg = get_config(arch).reduced().with_layers(n)
    kw = dict(remat=False, param_dtype=dtype, activation_dtype=dtype,
              num_microbatches=M)
    kw.update(run)
    jrun, trun = JRunConfig(**kw), RunConfig(**kw)
    params = _init_params(JS.param_specs(jcfg, jrun))
    rng = np.random.default_rng(9)
    for r, blk in params["blocks"].items():
        if "xattn_gate" in blk:
            blk["xattn_gate"] = jnp.asarray(rng.standard_normal(
                blk["xattn_gate"].shape), jnp.float32)
    jstate = {"params": params, "opt": jadamw.init_opt_state(params)}
    return jcfg, jrun, tcfg, trun, jstate


def _port_state(jstate, tcfg, trun):
    model = tlm.from_numpy(np_tree(jstate["params"]), tcfg, trun, "cpu",
                           trainable=True)
    return {"params": model,
            "opt": tadamw.opt_from_numpy(np_tree(jstate["opt"]), model)}


def _batches(cfg, n=2):
    """Token batches, and for a model with cross layers its context
    drawn from a seed (zero stubs make the encoder's output and the
    cross K/V zero)."""
    from repro_torch.launch.serve import seeded_context
    pipe = tpipe.TokenPipeline(tpipe.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=24, global_batch=4))
    return [dict(pipe.batch_at(i, device="cpu"),
                 **seeded_context(cfg, 4, 24, 11 + i))
            for i in range(n)]


def _check_params(jtree, ttree, spread=None):
    """At most a share 1e-3 of a leaf past 2e-5, none past 4 x lr.  For
    an ill-conditioned model, whose port's float64 run is `spread`, the
    count allowed past 2e-5 adds 4 times that run's count past 2e-5 from
    the float32 one, and is at least 4 elements (a norm's 128 have no
    room for a share of 1e-3)."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        t = _f32(_leaf(ttree, path))
        d = np.abs(_f32(leaf) - t)
        name = jax.tree_util.keystr(path)
        allowed = 1e-3 * d.size
        if spread is not None:
            allowed = max(4, allowed + 4 * int(
                (np.abs(t - _f32(_leaf(spread, path))) > 2e-5).sum()))
        assert (d > 2e-5).sum() <= allowed, (name, int((d > 2e-5).sum()))
        assert d.max() <= 4 * LR, (name, float(d.max()))


# the reduced models whose float32 train step rounding moves by more
# than the tolerances below: the port's own float32 gradients lie up to
# 1.1e-3 (seamless, gates drawn) and 1.1e-3 (vision, 5 layers) from its
# float64 run of the same step, where llama3.2-1b's lie 1.8e-5
ILL_CONDITIONED = ("seamless-m4t-medium", "llama-3.2-vision-90b")


def _port_run(jstate, tcfg, tr, batches, M, f64=False):
    """The port's two steps from JAX's state: (the first step's
    gradients, the mean over the M row slices, as a JAX-layout tree; the
    steps' metrics; the state tree after them).  `f64` runs the model,
    its moments and the context in float64 (AdamW's update stays
    float32)."""
    st = _port_state(jstate, tcfg, tr)
    model = st["params"]
    if f64:
        model.double()
        for k in ("m", "v"):
            st["opt"][k] = {n: t.double() for n, t in st["opt"][k].items()}
        batches = [{k: v.double() if v.is_floating_point() else v
                    for k, v in b.items()} for b in batches]
    names = [n for n, _ in model.named_parameters()]
    gsum = [0] * len(names)
    for i in range(M):
        mb = {k: v.reshape((M, -1) + tuple(v.shape[1:]))[i]
              for k, v in batches[0].items()}
        g = torch.autograd.grad(tlm.loss_fn(model, mb, tr)[0],
                                list(model.parameters()))
        gsum = [a + (x.double() if f64 else x.float())
                for a, x in zip(gsum, g)]
    grads = tlm.to_tree(model, {n: x / M for n, x in zip(names, gsum)})
    ts = TS.make_step(tcfg, tr, "train")
    mets = [ts(st, b)[1] for b in batches]
    return grads, mets, TS.state_tree(st)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "smollm-360m",
                                  "mamba2-130m", "seamless-m4t-medium",
                                  "llama-3.2-vision-90b"])
@pytest.mark.parametrize("M", [1, 2])
def test_train_step_equals_jax(arch, M):
    """Two float32 steps from the same weights and optimizer state:
    loss, grad_norm, the first step's per-leaf gradients (JAX's read
    back from its first moment) and the updated parameters against JAX's
    jitted step; the port with remat on equals the port with remat off
    bit for bit.  The encoder-decoder and the vision model train on
    their context (frames, image embeddings) with their gates drawn;
    they are ill-conditioned in float32 (ILL_CONDITIONED), so each of
    their limits also allows 4 times the distance of the port's float32
    value from its float64 run of the same steps."""
    jcfg, jrun, tcfg, trun, jstate = _setup(arch, "float32", M)
    batches = _batches(tcfg)
    jb = [{k: jnp.asarray(v.numpy()) for k, v in b.items()}
          for b in batches]
    step, _ = JS.make_train_step(jcfg, jrun, make_host_mesh())
    step = jax.jit(step)
    runs = {remat: _port_run(jstate, tcfg, dataclasses.replace(
        trun, remat=remat), batches, M) for remat in (False, True)}
    js = jstate
    jmets = []
    for b in jb:
        js, m = step(js, b)
        jmets.append(m)
        if not jmets[1:]:
            # JAX's first-step gradients, the mean over the M row slices,
            # out of its first moment: m = (1 - b1) * clip_scale * g
            gn = float(m["grad_norm"])
            scale = min(1.0, trun.grad_clip / max(gn, 1e-9))
            jg = jax.tree.map(lambda a: np.asarray(a) / (0.1 * scale),
                              js["opt"]["m"])
    grads, mets, tree = runs[False]
    spread = {"loss": [0.0] * 2, "grad_norm": [0.0] * 2}
    gspread = pspread = None
    if arch in ILL_CONDITIONED:
        g64, m64, t64 = _port_run(jstate, tcfg, trun, batches, M, f64=True)
        pspread = t64["params"]
        spread = {k: [abs(a[k].item() - b[k].item())
                      for a, b in zip(mets, m64)] for k in spread}
        gspread = g64
    for i, (jm, tm) in enumerate(zip(jmets, mets)):
        for k, rt in (("loss", 1e-5), ("grad_norm", 1e-4)):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=rt,
                                       atol=4 * spread[k][i],
                                       err_msg=f"{k} step {i}")
        assert tm["aux"].item() == float(jm["aux"]) == 0.0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]:
        a, b = _f32(leaf), _f32(_leaf(grads, path))
        slack = 0.0 if gspread is None else 4 * float(np.abs(
            b.astype(np.float64) - _leaf(gspread, path).numpy()).max())
        assert np.abs(a - b).max() <= 2e-4 * np.abs(a).max() + 1e-8 + \
            slack, jax.tree_util.keystr(path)
    _check_params(js["params"], tree["params"], pspread)
    assert int(tree["opt"]["step"]) == int(js["opt"]["step"]) == 2
    # remat on: the same numbers bit for bit
    g2, m2, t2 = runs[True]
    for a, b in zip(mets, m2):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for (_, x), (_, y) in zip(tcommon.tree_items(tree),
                              tcommon.tree_items(t2)):
        assert torch.equal(x, y)
    for (_, x), (_, y) in zip(tcommon.tree_items(grads),
                              tcommon.tree_items(g2)):
        assert torch.equal(x, y)


def test_train_step_bfloat16_equals_jax():
    """smollm-360m in bfloat16 (params, activations), M = 2, remat on
    with the block policy, two steps.  At lr 3e-4 a bf16 parameter's
    update is about one bf16 ulp, so a float difference of rounding size
    in a gradient moves whole ulps of the updated parameters, and the
    second step's gradients follow: loss within 2e-3, grad_norm within
    3e-2 at step 0 and 1e-1 at step 1 (read: 6e-5, 1%, 6e-4, 6%), each
    parameter within 6 x (lr + one bf16 rounding) (read: 3.6 x)."""
    jcfg, jrun, tcfg, trun, jstate = _setup(
        "smollm-360m", "bfloat16", 2, remat=True, remat_policy="block")
    batches = _batches(tcfg)
    step, _ = JS.make_train_step(jcfg, jrun, make_host_mesh())
    step = jax.jit(step)
    st = _port_state(jstate, tcfg, trun)
    ts = TS.make_train_step(tcfg, trun)
    js = jstate
    for i, b in enumerate(batches):
        js, jm = step(js, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
        st, tm = ts(st, b)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=2e-3, err_msg=f"loss step {i}")
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]),
                                   rtol=(3e-2, 1e-1)[i],
                                   err_msg=f"grad_norm step {i}")
    tree = TS.state_tree(st)
    assert tree["params"]["embed"].dtype == torch.bfloat16
    for path, leaf in jax.tree_util.tree_flatten_with_path(js["params"])[0]:
        a, b = _f32(leaf), _f32(_leaf(tree["params"], path))
        assert (np.abs(a - b) <= 6 * (LR + 2 ** -8 * np.abs(a))).all(), \
            jax.tree_util.keystr(path)


def test_make_step_kinds_and_specs():
    cfg = get_config("smollm-360m").reduced()
    run = RunConfig()
    for kind in ("train", "prefill", "decode"):
        assert callable(TS.make_step(cfg, run, kind))
    with pytest.raises(ValueError):
        TS.make_step(cfg, run, "nope")
    from repro.configs.base import SHAPES_BY_NAME as J_SHAPES
    from repro_torch.configs import SHAPES_BY_NAME
    jspec = JS.train_state_specs(j_get_config("smollm-360m").reduced(),
                                 JRunConfig(opt_state_dtype="bfloat16"))
    tspec = TS.train_state_specs(cfg, RunConfig(opt_state_dtype="bfloat16"))
    jl = jax.tree_util.tree_flatten_with_path(
        jspec, is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))[0]
    tl = list(tcommon.tree_items(tspec))
    assert [tuple(k.key for k in p) for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert a.shape == b.shape and jnp.dtype(a.dtype).name == \
            str(b.dtype).split(".")[-1] and a.axes == b.axes
    jb = JS.batch_specs(j_get_config("smollm-360m"), J_SHAPES["train_4k"])
    tb = TS.batch_specs(get_config("smollm-360m"), SHAPES_BY_NAME["train_4k"])
    assert {k: (v.shape, v.axes) for k, v in jb.items()} == \
        {k: (v.shape, v.axes) for k, v in tb.items()}
