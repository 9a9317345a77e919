"""The LM forward on DTensors (ROADMAP.md §1 item 10e part 2a) on the
CPU: the serving steps on gloo ranks over host meshes against the
one-device port forward, and through it against JAX's `lm.forward`.

- The merge of the decode kernel's (o, lse) form, without ranks: the
  twin on r = 2, 3 and 4 `kv_seq` shards of a cache, merged by
  `models.attention.merge_partials`, equals JAX's `decode_attention` on
  the whole cache within 1e-6, with cache_len on and beside the shard
  boundaries, so that some shards hold no valid key (cache_len 0 is out:
  JAX averages the whole cache there, the kernel returns 0).
- The steps on ranks: `launch.steps.make_prefill_step` and
  `make_decode_step` with a mesh, one prefill and 2 greedy decode steps
  of the reduced llama3.2-1b,
  qwen2-moe-a2.7b (capacity 8.0, where the expert-parallel layer drops
  nothing and computes the dense form's function) and Jamba, float32,
  decode profile, over the 1 x 4 and 2 x 2 ("data", "model") meshes of
  4 spawned gloo ranks, and llama under the `long` profile (B = 1, the
  sequence and the cache over both axes), from numpy weights and
  tokens made from a seed (the decode steps fed seeded tokens).  Every step's logits and
  every cache leaf equal the one-device port's within MESH_TOL = 1e-5
  (rtol = atol), the greedy tokens wherever the one-device top-2 margin
  passes twice that.  The reduced Jamba is chaotic: a relative change
  of 1e-7 in its embedding moves its one-device logits by 6.4e-5, so
  its whole-model logits and caches are held to CHAOTIC_TOL = 1e-3,
  and each of its layers, fed the one-device run's input, to MESH_TOL.
  The one-device port equals JAX's `lm.forward` on the same numpy
  weights within JAX_TOL = 1e-4, the port's float32 tolerance
  (`test_torch_models.py`).  The ranks run
  `test_torch_local_ranks.lm_mesh_ranks` and import no JAX.
- The path is real: the attention caches are sharded on `kv_seq`, each
  flash call ran on the rank's heads (and its query block under
  `long`), each decode call on its cache shard in the (o, lse) form,
  the SSD scan on the rank's heads; the merge's collectives are two
  all-reduces an attention layer per step per sharding axis, of the
  closed form's bytes.

One `run_ranks` call runs every case on both meshes.
"""
from __future__ import annotations

import dataclasses
import threading

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
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.launch.comm_stats import total_collective_bytes
from repro_torch.launch.local_ranks import run_ranks
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from test_torch_local_ranks import (MESH_CAPACITY, WORLD, lm_mesh_ranks,
                                    mesh_cfg, one_device_serve)

MESH_TOL = dict(rtol=1e-5, atol=1e-5)
CHAOTIC_TOL = dict(rtol=1e-3, atol=1e-3)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
MERGE_TOL = dict(rtol=1e-6, atol=1e-6)
CHAOTIC = ("jamba-1.5-large-398b",)
STEPS = 2
# key: (arch, profile, B, prompt S, capacity); the capacity splits 4 ways
CASES = {
    "llama": ("llama3.2-1b", "decode", 4, 16, 24),
    "qwen2-moe": ("qwen2-moe-a2.7b", "decode", 4, 16, 24),
    "jamba": ("jamba-1.5-large-398b", "decode", 4, 16, 24),
    "llama-long": ("llama3.2-1b", "long", 1, 16, 24),
}
MESHES = {"1x4": 4, "2x2": 2}          # name: the "model" axis


# --------------------------------------------------------------------- #
# the merge, without ranks
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("r", [2, 3, 4])
def test_merged_shards_match_jax_decode_attention(r):
    B, T, H, KV, hd = 9, 24, 8, 2, 16
    Tl = T // r
    rng = np.random.default_rng(r)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, 1, H, hd), (B, T, KV, hd), (B, T, KV, hd)))
    lens = np.array([1, Tl - 1, Tl, Tl + 1, 2 * Tl - 1, 2 * Tl, T - 1, T,
                     Tl + 2], np.int32)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    os_, lses = [], []
    for i in range(r):
        clen = torch.from_numpy(np.clip(lens - i * Tl, 0, Tl).astype(
            np.int32))
        o, lse = decode_attention_ref(qt, kt[:, i * Tl:(i + 1) * Tl],
                                      vt[:, i * Tl:(i + 1) * Tl], clen,
                                      with_lse=True)
        os_.append(o)
        lses.append(lse)
    assert (torch.stack(lses) == -float("inf")).any()   # empty shards

    def over_shards(x, op):
        red = x.amax(0) if op == "max" else x.sum(0)
        return red.expand_as(x)

    got = tattn.merge_partials(torch.stack(os_), torch.stack(lses),
                               over_shards)[0]
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MERGE_TOL)


# --------------------------------------------------------------------- #
# the references, in this process, while the ranks run
# --------------------------------------------------------------------- #
_F32 = dict(remat=False, param_dtype="float32", activation_dtype="float32")


def _jcfg(arch):
    return dataclasses.replace(j_get_config(arch).reduced(),
                               moe_capacity_factor=MESH_CAPACITY)


def _weights(arch, seed):
    """The JAX parameter tree of the reduced `arch` made with numpy:
    normal leaves scale/sqrt(fan_in) as `init_tree` draws them, zeros and
    ones as their specs say."""
    rng = np.random.default_rng(seed)

    def leaf(p):
        if p.init in ("zeros", "ones"):
            return np.full(p.shape, p.init == "ones", np.float32)
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        std = p.scale / np.sqrt(max(fan_in, 1))
        return (rng.standard_normal(p.shape) * std).astype(np.float32)

    return jax.tree.map(leaf, JS.param_specs(_jcfg(arch), JRunConfig(**_F32)),
                        is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))


def _feed(key):
    arch, _, B, S, _ = CASES[key]
    rng = np.random.default_rng(len(key))
    V = mesh_cfg(arch).vocab_size
    return {"tokens": rng.integers(0, V, (B, S)).astype(np.int32),
            "fed": [rng.integers(0, V, (B,)).astype(np.int32)
                    for _ in range(STEPS)]}


def _jax_run(case, params, feed):
    """JAX's `lm.forward` on the same weights: prefill, the self caches
    grown to capacity as its serve loop grows them, then the fed
    tokens."""
    arch, profile, B, S, cap = case
    jcfg, jrun = _jcfg(arch), JRunConfig(**_F32)
    mesh, rules = make_host_mesh(), JS.resolve_rules(jcfg, "train")
    params = jax.tree.map(jnp.asarray, params)
    logits, layers, _ = jax.jit(lambda p, t: jlm.forward(
        p, t, jcfg, jrun, mesh, rules, mode="prefill"))(
            params, jnp.asarray(feed["tokens"]))
    layers = {r: {n: (jax.tree.map(lambda x: jnp.pad(
        x, [(0, 0), (0, 0), (0, cap - S), (0, 0), (0, 0)]), c)
        if n == "self" else c) for n, c in cs.items()}
        for r, cs in layers.items()}
    out = [np.asarray(logits)]
    dec = jax.jit(lambda p, c, pos, t: jlm.forward(
        p, t, jcfg, jrun, mesh, rules, mode="decode", caches=c,
        cache_len=pos)[:2])
    pos = jnp.full((B,), S, jnp.int32)
    for t in feed["fed"]:
        lg, layers = dec(params, layers, pos, jnp.asarray(t)[:, None])
        out.append(np.asarray(lg))
        pos = pos + 1
    return out


@pytest.fixture(scope="module")
def runs():
    """One `run_ranks` call, in a thread, for every case on both meshes;
    the one-device references and JAX's meanwhile."""
    archs = sorted({c[0] for c in CASES.values()})
    weights = {a: _weights(a, 20 + i) for i, a in enumerate(archs)}
    feeds = {key: _feed(key) for key in CASES}
    taps = [k for k, c in CASES.items() if c[0] in CHAOTIC]
    got = {}
    th = threading.Thread(target=lambda: got.setdefault("mesh", run_ranks(
        lm_mesh_ranks, WORLD, MESHES, CASES, weights, feeds, taps,
        timeout=240.0)[0]))
    th.start()
    refs = {key: one_device_serve(case, weights[case[0]], feeds[key],
                                  tap=case[0] in CHAOTIC)
            for key, case in CASES.items()}
    jax_logits = {key: _jax_run(case, weights[case[0]], feeds[key])
                  for key, case in CASES.items()}
    th.join()
    assert "mesh" in got, "the ranks failed (their error is printed above)"
    return jax_logits, feeds, refs, got["mesh"]


def _tol(key):
    return CHAOTIC_TOL if CASES[key][0] in CHAOTIC else MESH_TOL


def _margin_ok(logits, tol):
    """Rows whose one-device top-2 margin passes twice the tolerance."""
    top = np.sort(logits[:, -1], axis=-1)
    return top[:, -1] - top[:, -2] > 2 * (tol["atol"] +
                                          tol["rtol"] * np.abs(top[:, -1]))


# --------------------------------------------------------------------- #
# the tests
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("key", list(CASES))
def test_one_device_port_matches_jax(runs, key):
    jax_logits, _, refs, _ = runs
    want, got = jax_logits[key], refs[key]["logits"]
    assert len(got) == len(want) == STEPS + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **JAX_TOL)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("key", list(CASES))
def test_mesh_steps_match_one_device(runs, key, mesh):
    _, _, refs, mesh_runs = runs
    ref, got = refs[key], mesh_runs[mesh][key]
    tol = _tol(key)
    assert len(got["logits"]) == STEPS + 1
    for i, (g, w) in enumerate(zip(got["logits"], ref["logits"])):
        np.testing.assert_allclose(g, w, err_msg=f"step {i}", **tol)
    for i, (g, w) in enumerate(zip(got["tokens"], ref["tokens"])):
        ok = _margin_ok(ref["logits"][i], tol)
        assert ok.any()
        np.testing.assert_array_equal(g[ok], w[ok], err_msg=f"step {i}")
    assert set(got["caches"]) == set(ref["caches"])
    for name, (g, _) in got["caches"].items():
        np.testing.assert_allclose(g, ref["caches"][name], err_msg=name,
                                   **tol)
    np.testing.assert_array_equal(got["pos"], CASES[key][3] + STEPS)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("key", [k for k, c in CASES.items()
                                 if c[0] in CHAOTIC])
def test_chaotic_model_layer_by_layer(runs, key, mesh):
    """Each layer of the reduced Jamba on the mesh, fed the one-device
    run's input, within MESH_TOL of the one-device layer, in the prefill
    and in each decode step; its caches too (each layer's K/V and states
    come from that layer's input)."""
    _, _, refs, mesh_runs = runs
    ref, got = refs[key], mesh_runs[mesh][key, "taps"]
    assert len(got["layers"]) == len(ref["layers"]) == \
        (STEPS + 1) * mesh_cfg(CASES[key][0]).num_layers
    for i, (g, w) in enumerate(zip(got["layers"], ref["layers"])):
        np.testing.assert_allclose(g, w, err_msg=f"layer call {i}",
                                   **MESH_TOL)
    for name, (g, _) in got["caches"].items():
        np.testing.assert_allclose(g, ref["caches"][name], err_msg=name,
                                   **MESH_TOL)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("key", list(CASES))
def test_the_sharded_path_ran(runs, key, mesh):
    """No pruning hides the path: the attention caches shard `kv_seq`
    (an uneven capacity would fall back to a replicated cache), the
    flash calls see the rank's heads (or, under `long`, all heads and
    the rank's query block against the keys up to its end), the decode
    calls the rank's cache shard in the (o, lse) form, the SSD scan the
    rank's heads; the merge makes a max and a sum all-reduce per
    sharding axis of more than one rank, with the closed form's bytes."""
    mesh_runs = runs[3]
    arch, profile, B, S, cap = CASES[key]
    cfg = mesh_cfg(arch)
    model_n = MESHES[mesh]
    data_n = 4 // model_n
    got = mesh_runs[mesh][key]
    seq_n = 4 if profile == "long" else model_n     # kv_seq's shards
    b_n = 1 if profile == "long" else data_n        # the batch's
    attn = [n for n in got["caches"] if n.endswith("self/k")]
    assert len(attn) == sum(k.mixer == "attn" for k in tlm.layer_kinds(cfg))
    for name in attn:
        _, pl = got["caches"][name]
        assert "Shard(dim=2)" in pl, (name, pl)
    n_attn = len(attn) * (cfg.num_layers // len(tlm.layer_kinds(cfg)))
    assert len(got["flash"]) == n_attn
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for q_shape, k_shape in got["flash"]:
        if profile == "long":
            assert q_shape == (B, S // seq_n, H, hd)
            assert k_shape[1] in [(r + 1) * S // seq_n
                                  for r in range(seq_n)]
        else:
            assert q_shape == (B // b_n, S, H // model_n, hd)
            assert k_shape[2] == max(1, KV // model_n)
    assert len(got["decode"]) == n_attn * STEPS
    for q_shape, k_shape, lse in got["decode"]:
        assert lse and q_shape == (B // b_n, 1, H, hd)
        assert k_shape == (B // b_n, cap // seq_n, KV, hd)
    if cfg.ssm_state:
        H_ssd = cfg.ssm_heads
        assert got["ssd"] and all(s[3] == H_ssd // model_n
                                  for s in got["ssd"])
    sizes = [n for n in ((model_n,) if profile != "long"
                         else (data_n, model_n)) if n > 1]
    assert len(got["merge"]) == n_attn * STEPS
    for o_shape, records in got["merge"]:
        assert [r.kind for r in records] == ["all-reduce"] * 2 * len(sizes)
        Bl = o_shape[0]
        want = sum(2 * (n - 1) / n * (Bl * H * 4 + Bl * H * (hd + 1) * 4)
                   for n in sizes)
        assert total_collective_bytes(records) == int(want)
