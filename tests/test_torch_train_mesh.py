"""The train step on DTensors, and the cross layers and the encoder on a
mesh (ROADMAP.md §1 item 10e part 2c), on the CPU: `make_train_step`
with a mesh on 4 spawned gloo ranks over the 1 x 4 and 2 x 2 ("data",
"model") host meshes, against the one-device port's train step, from
numpy weights and token batches made from a seed (float32, 2 steps).

- Cases: the reduced llama3.2-1b with M = 1 and 2 microbatches, remat
  "period" and "block", ZeRO-3 at use on and off on 2 x 2, and the
  `train_sp` profile once; qwen2-moe-a2.7b (capacity 8.0: the
  expert-parallel layer drops nothing); Jamba; seamless-m4t-medium
  (encoder and cross layers, frames drawn from a seed); and
  llama-3.2-vision-90b (cross layers, image embeddings drawn), each
  with its `xattn_gate`s drawn (zero gates leave the cross paths dead).
- The mesh's MoE aux loss is the mean of the Switch losses of the token
  blocks its ranks route (ROADMAP.md §3, `moe_apply`'s aux), so the
  one-device run takes that aux (`launch.taps.mesh_aux`).
- Each case runs on 2 x 2, the llama M = 1 case, qwen2-moe and
  seamless on 1 x 4 too (the test's time: every case on both meshes
  would take half as long again; the reduced vision's 2 KV heads do not
  divide over 4, so its 1 x 4 run would add no sharding).
- Loss, aux and grad_norm of each step, every gradient of the first
  step (what the step hands AdamW), m and v after 2 steps equal the
  one-device port's within MESH_TOL = 1e-5 (rtol = atol), each rank's
  shard against the one-device tensor's slice (gathered whole here);
  a gradient's atol scales with its leaf's largest magnitude (a
  gradient sums every token's term, and the embedding's cancel: its
  largest difference, 2.7e-5 at 0.074 in a leaf reaching 3.9, is
  rounding of terms far larger than the sum).
  The parameters after 2 steps are held as `test_torch_train.py` holds
  them against JAX: at most a share 1e-3 of a leaf past 2e-5 and none
  past 4 x lr, because AdamW's normalized step moves a parameter by
  about lr x sign(g), and a gradient of rounding size may flip its
  sign.
- Jamba, seamless and vision are chaotic at these random weights (the
  one-device float32 gradients of the reduced seamless lie 5e-4 to
  9e-4 from float64, so any other summation order lands as far away):
  their mesh run feeds each layer the one-device run's input and the
  gradient reaching its output (`launch.taps.TrainTaps`), and the same
  gates hold, with Jamba at CHAOTIC_TOL = 1e-3.
- The path ran: the mesh's grad_norm is the same on every rank, its
  `global_norm` makes one all-reduce of a float32 scalar a mesh axis;
  the vocabulary-parallel cross entropy makes three all-reduces of
  (B_l, S_l) float32 over the vocabulary's axis and one scalar over the
  batch's, and never gathers the logits; under ZeRO-3 on 2 x 2 each
  layer's data-sharded weights are all-gathered over "data" at use (and
  again in the recompute under remat) and their gradients
  reduce-scattered back, with bytes equal to the closed form.
- Seamless and vision also serve on each mesh: a prefill with their
  context and 2 decode steps, logits and caches within MESH_TOL of one
  device; flash on the rank's heads, the self decode on its `kv_seq`
  shard in the (o, lse) form, the cross decode on its heads of a cross
  cache sharded on the KV heads (whole heads where the KV heads do not
  divide over "model", as the rules prune them: the reduced models'
  2 KV heads on 1 x 4).  The serving runs are fed the one-device run's
  layer inputs too.
- `launch.steps.default_runcfg` equals JAX's field by field for every
  architecture and shape.

One `run_ranks` call runs every case on both meshes; the ranks run
`test_torch_local_ranks.train_mesh_ranks` and import no JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.launch.comm_stats import total_collective_bytes
from repro_torch.launch.local_ranks import run_ranks
from repro_torch.models import lm as tlm
from repro_torch.models.common import tree_items
from test_torch_local_ranks import (WORLD, train_mesh_cfg, train_mesh_ranks,
                                    train_mesh_runcfg)

MESH_TOL = dict(rtol=1e-5, atol=1e-5)
CHAOTIC_TOL = dict(rtol=1e-3, atol=1e-3)
LR = train_mesh_runcfg(()).learning_rate
STEPS = 2
B, S = 4, 24
Z3 = ("zero3_at_use", True)
# key: (arch, RunConfig options, chaotic: fed the one-device layer taps)
CASES = {
    "llama-m1": ("llama3.2-1b", (Z3,), False),
    "llama-m2-block": ("llama3.2-1b", (("num_microbatches", 2),
                                       ("remat_policy", "block")), False),
    "llama-sp": ("llama3.2-1b", (("sharding_profile", "train_sp"),), False),
    "qwen2-moe": ("qwen2-moe-a2.7b", (Z3,), False),
    "jamba": ("jamba-1.5-large-398b", (Z3,), True),
    "seamless": ("seamless-m4t-medium", (("num_microbatches", 2), Z3), True),
    "vision": ("llama-3.2-vision-90b", (("remat_policy", "block"), Z3),
               True),
}
MESHES = {   # name: (data, model, the cases run on it)
    "1x4": (1, 4, ("llama-m1", "qwen2-moe", "seamless")),
    "2x2": (2, 2, tuple(CASES)),
}
# serve: (arch, profile, B, prompt S, capacity)
SERVES = {"seamless-m4t-medium": ("seamless-m4t-medium", "decode", 4, 16,
                                  24),
          "llama-3.2-vision-90b": ("llama-3.2-vision-90b", "decode", 4, 16,
                                   24)}


def _tol(key):
    return CHAOTIC_TOL if CASES[key][0].startswith("jamba") else MESH_TOL


def _weights(arch, seed):
    """The port's parameter tree of the reduced `arch` as numpy: normal
    leaves scale/sqrt(fan_in), zeros and ones as their specs say, and
    every `xattn_gate` drawn from a standard normal."""
    rng = np.random.default_rng(seed)
    out = {}
    specs = tlm.build_param_specs(train_mesh_cfg(arch), torch.float32)
    for path, p in tree_items(specs):
        if path[-1] == "xattn_gate":
            a = rng.standard_normal(p.shape).astype(np.float32)
        elif p.init in ("zeros", "ones"):
            a = np.full(p.shape, p.init == "ones", np.float32)
        else:
            fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
            a = (rng.standard_normal(p.shape) * p.scale /
                 np.sqrt(max(fan_in, 1))).astype(np.float32)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    return out


def _context(cfg, rng, batch, seq):
    if cfg.family == "vlm":
        return {"img_embeds": rng.standard_normal(
            (batch, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)}
    if cfg.family == "audio_encdec":
        return {"frames": rng.standard_normal(
            (batch, seq, cfg.d_model)).astype(np.float32)}
    return {}


def _batches(key):
    cfg = train_mesh_cfg(CASES[key][0])
    rng = np.random.default_rng(len(key) + 40)
    V = cfg.vocab_size
    return [dict(tokens=rng.integers(0, V, (B, S)).astype(np.int32),
                 labels=rng.integers(0, V, (B, S)).astype(np.int32),
                 **_context(cfg, rng, B, S)) for _ in range(STEPS)]


def _serves():
    out = {}
    for arch, sc in SERVES.items():
        _, _, b, s, _ = sc
        cfg = train_mesh_cfg(arch)
        rng = np.random.default_rng(60)
        V = cfg.vocab_size
        out[arch] = (sc, _context(cfg, rng, b, s),
                     rng.integers(0, V, (b, s)).astype(np.int32),
                     [rng.integers(0, V, (b,)).astype(np.int32)
                      for _ in range(STEPS)])
    return out


@pytest.fixture(scope="module")
def runs():
    archs = sorted({c[0] for c in CASES.values()} | set(SERVES))
    weights = {a: _weights(a, 30 + i) for i, a in enumerate(archs)}
    return run_ranks(train_mesh_ranks, WORLD, MESHES, CASES, weights,
                     {k: _batches(k) for k in CASES}, _serves(),
                     timeout=300.0)


def _mesh_keys():
    return [(m, k) for m, (_, _, keys) in MESHES.items() for k in keys]


def _close(got, want, tol, what):
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=f"{what} {n}",
                                   **tol)


# --------------------------------------------------------------------- #
# the train step on the mesh against one device
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mesh,key", _mesh_keys())
def test_train_step_on_mesh_matches_one_device(runs, mesh, key):
    ref, got = runs[0][mesh, key]
    tol = _tol(key)
    for i, (g, w) in enumerate(zip(got["metrics"], ref["metrics"])):
        for k in ("loss", "aux", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], err_msg=f"{k} step {i}",
                                       **tol)
    assert ref["metrics"][0]["grad_norm"] > 0
    if CASES[key][0].startswith("qwen2"):
        assert ref["metrics"][0]["aux"] > 0
    assert set(got["grads"]) == set(ref["grads"])
    for n, w in ref["grads"].items():
        np.testing.assert_allclose(
            got["grads"][n], w, rtol=tol["rtol"],
            atol=tol["atol"] * max(1.0, float(np.abs(w).max())),
            err_msg=f"gradient {n}")
    _close(got["m"], ref["m"], tol, "m")
    _close(got["v"], ref["v"], tol, "v")
    for n, w in ref["params"].items():
        d = np.abs(got["params"][n] - w)
        assert (d > 2e-5).mean() <= 1e-3, (n, int((d > 2e-5).sum()))
        assert d.max() <= 4 * LR, (n, float(d.max()))
    assert got["passes"] == ref["passes"] == STEPS * dict(
        CASES[key][1]).get("num_microbatches", 1)


@pytest.mark.parametrize("mesh,key", _mesh_keys())
def test_global_norm_is_one_value_on_every_rank(runs, mesh, key):
    """Each rank clips by the same norm: one all-reduce of a float32
    scalar a mesh axis of more than one rank, and the ranks' grad_norms
    equal bit for bit."""
    got = runs[0][mesh, key][1]
    norms = {r[mesh, key] for r in runs[1:]} | {
        tuple(m["grad_norm"] for m in got["metrics"])}
    assert len(norms) == 1, norms
    axes = sum(n > 1 for n in MESHES[mesh][:2])
    for records in got["collectives"]["norm"]:
        assert [(r.kind, r.result_bytes) for r in records] == \
            [("all-reduce", 4)] * axes


@pytest.mark.parametrize("mesh,key", _mesh_keys())
def test_vocab_parallel_cross_entropy(runs, mesh, key):
    """Each call: the max, the sum of exponentials and the label's logit
    all-reduced over the vocabulary's axis ((B_l, S_l) float32 each,
    the rows as placed), then the rows' loss summed over the axes that
    shard them; nothing gathered, so the logits stay vocab-sharded."""
    data, model, _ = MESHES[mesh]
    got = runs[0][mesh, key][1]
    M = dict(CASES[key][1]).get("num_microbatches", 1)
    sp = dict(CASES[key][1]).get("sharding_profile") == "train_sp"
    Bm = B // M
    b_n = data if Bm % data == 0 else 1
    s_n, v_n = (model, 1) if sp else (1, model)
    rows = Bm // b_n * S // s_n * 4
    want = 3 * [("all-reduce", rows, v_n)] if v_n > 1 else []
    want += [("all-reduce", 4, n) for n in (b_n, s_n) if n > 1]
    assert len(got["collectives"]["xent"]) == STEPS * M
    for records in got["collectives"]["xent"]:
        assert [tuple(r) for r in records] == want


@pytest.mark.parametrize("key", [k for k, c in CASES.items()
                                 if Z3 in c[1]])
def test_zero3_gathers_weights_at_use(runs, key):
    """On 2 x 2 each layer's weights stored sharded over "data" are
    all-gathered over it where the layer runs, once in the forward and
    once more in the recompute (remat): one all-gather of the weight at
    its use placements a weight, with the closed form's bytes.  Each
    weight's gradient is brought back to its storage placements once a
    layer call (a cross layer's gate, replicated, is used as stored),
    with a collective for each weight stored sharded over "data" (the
    expert-parallel layer hands back its expert weights' gradients
    reduced already)."""
    from repro_torch.sharding.axes import (logical_to_spec, resolve_rules,
                                           use_rules)
    arch, run, _ = CASES[key]
    cfg, rc = train_mesh_cfg(arch), train_mesh_runcfg(run)
    mesh = dataclasses.make_dataclass("M", [("shape", dict)])(
        {"data": 2, "model": 2})
    rules = resolve_rules(cfg, rc.sharding_profile)
    got = runs[0]["2x2", key][1]
    kinds = tlm.layer_kinds(cfg)

    def weights(kind):
        out = []
        for _, p in tree_items(tlm.block_params(cfg, kind, torch.float32)):
            store = logical_to_spec(p.axes, p.shape, rules, mesh)
            use = logical_to_spec(p.axes, p.shape, use_rules(rules), mesh)
            n = int(np.prod(p.shape)) * 4
            for spec in use:
                n //= 1 if spec is None else 2
            out.append(("data" in store and "data" not in use, n))
        return out

    calls = (2 if rc.remat else 1) * rc.num_microbatches * STEPS
    blocks = [kinds[i % len(kinds)] for i in range(cfg.num_layers)]
    layers = [weights(k) for k in blocks]
    want = sorted(tuple(sorted(("all-gather", n, 2) for g, n in w if g))
                  for w in layers) * calls
    assert sorted(tuple(sorted(map(tuple, recs)))
                  for recs in got["collectives"]["gather"]) == sorted(want)
    assert all(want)
    assert total_collective_bytes(
        [r for recs in got["collectives"]["gather"] for r in recs]) == \
        sum(n // 2 for w in want for _, n, _ in w)
    reductions = got["collectives"]["reduce"]
    n_weights = sum(len(w) - k.cross for w, k in zip(layers, blocks))
    assert len(reductions) == n_weights * rc.num_microbatches * STEPS
    if not cfg.moe_num_experts:
        gathered = sum(g for w in layers for g, _ in w)
        assert sum(bool(recs) for recs in reductions) >= \
            gathered * rc.num_microbatches * STEPS


# --------------------------------------------------------------------- #
# the cross layers and the encoder serving on the mesh
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(SERVES))
def test_cross_and_encoder_serve_on_mesh(runs, mesh, arch):
    ref, got = runs[0][mesh, arch, "serve"]
    _, profile, b, s, cap = SERVES[arch]
    data, model, _ = MESHES[mesh]
    cfg = train_mesh_cfg(arch)
    for i, (g, w) in enumerate(zip(got["logits"], ref["logits"])):
        np.testing.assert_allclose(g, w, err_msg=f"step {i}", **MESH_TOL)
    assert len(got["logits"]) == STEPS + 1
    for name, (w, _) in ref["caches"].items():
        g, pl = got["caches"][name]
        np.testing.assert_allclose(g, w, err_msg=name, **MESH_TOL)
        if "/cross/k" in name:       # its KV heads, where they divide
            assert ("Shard(dim=3)" in pl) == (cfg.num_kv_heads % model == 0)
            assert np.abs(w).max() > 0
        if "/self/k" in name:
            assert "Shard(dim=2)" in pl, (name, pl)       # kv_seq
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b_l = b // data
    assert got["flash"] and all(q == (b_l, s, H // model, hd)
                                for q, _ in got["flash"])
    kinds = tlm.layer_kinds(cfg)
    G = cfg.num_layers // len(kinds)
    n_self = G * sum(k.mixer == "attn" for k in kinds)
    n_cross = G * sum(k.cross for k in kinds)
    self_calls = [d for d in got["decode"] if d[2]]
    cross_calls = [d for d in got["decode"] if not d[2]]
    assert len(self_calls) == n_self * STEPS
    assert len(cross_calls) == n_cross * STEPS
    T_x = cap if cfg.encoder_layers else cfg.num_image_tokens
    for q, k, _ in self_calls:
        assert q == (b_l, 1, H, hd) and k == (b_l, cap // model, KV, hd)
    x_n = model if KV % model == 0 else 1
    for q, k, _ in cross_calls:
        assert q == (b_l, 1, H // x_n, hd) and k == (b_l, T_x, KV // x_n, hd)


# --------------------------------------------------------------------- #
# default_runcfg
# --------------------------------------------------------------------- #
def test_default_runcfg_equals_jax():
    from repro.configs import get_config as j_get_config
    from repro.configs.base import SHAPES as J_SHAPES
    from repro.launch import steps as JS
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import steps as TS
    assert [s.name for s in SHAPES] == [s.name for s in J_SHAPES]
    for arch in ARCH_IDS:
        for shape, jshape in zip(SHAPES, J_SHAPES):
            for kw in ({}, {"remat": False, "num_microbatches": 2}):
                t = TS.default_runcfg(get_config(arch), shape, **kw)
                j = JS.default_runcfg(j_get_config(arch), jshape, **kw)
                assert dataclasses.asdict(t) == dataclasses.asdict(j), \
                    (arch, shape.name, kw)
