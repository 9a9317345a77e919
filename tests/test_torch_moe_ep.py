"""The expert-parallel MoE of the port (`models/moe.py`: `_moe_local_a2a`,
`_moe_local_psum` and `moe_apply` on a mesh, ROADMAP.md §1 item 10e)
against JAX's bodies.

The port's bodies run on gloo ranks spawned once for the file (4 CPU
processes: one group of 4 and two groups of 2); JAX's run under
`jax.vmap(..., axis_name="model")` over the same ranks stacked on one
CPU device.  Reduced qwen3-moe-30b-a3b and qwen2-moe-a2.7b in float32,
ep 2 and 4, both forms, capacity factors 8.0, 1.25 and 0.5: the top-k
ids, the positions in the bins and the kept entries equal JAX's (its
own helpers recompute them, since its bodies return only (out, aux)),
outputs and aux within 1e-5, and at 8.0, where nothing drops, the
outputs equal the dense form.  `moe_apply` on DTensors over a 1 x 4
and a 2 x 2 ("data", "model") mesh equals the dense form; its aux
equals the mean over the data ranks of what JAX's bodies return for
each data rank's batch share; and the gradients of the output and
0.01 aux equal `jax.grad` of JAX's dense oracle and of that mean.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.launch import comm_stats
from repro_torch.launch.local_ranks import run_ranks
from repro_torch.models import moe as tmoe
from repro_torch.models.common import init_tree
from test_torch_local_ranks import (GRAD_LOSS_AUX, WORLD, local_x,
                                    moe_ep_ranks)

ARCHS = ("qwen3-moe-30b-a3b", "qwen2-moe-a2.7b")
EPS = (2, 4)
CAPS = (8.0, 1.25, 0.5)
FORMS = ("a2a", "psum")
B = 2
SEQ = {"a2a": 8, "psum": 3}        # psum: the sequence does not divide ep
TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [(a, ep, f, c) for a in ARCHS for ep in EPS for f in FORMS
         for c in CAPS]


def _cfgs(arch, cf):
    return (dataclasses.replace(j_get_config(arch).reduced(),
                                moe_capacity_factor=cf),
            dataclasses.replace(get_config(arch).reduced(),
                                moe_capacity_factor=cf))


def _weights(arch):
    jcfg = j_get_config(arch).reduced()
    p = jcommon.init_tree(jax.random.PRNGKey(ARCHS.index(arch) + 3),
                          jmoe.moe_params(jcfg, jnp.float32))
    return {k: np.asarray(v) for k, v in p.items()}


def _tokens(arch, form):
    rng = np.random.default_rng(10 * ARCHS.index(arch) + FORMS.index(form))
    D = j_get_config(arch).reduced().d_model
    return rng.standard_normal((B, SEQ[form], D)).astype(np.float32)


@pytest.fixture(scope="module")
def ranks():
    weights = {a: _weights(a) for a in ARCHS}
    tokens = {(a, f): _tokens(a, f) for a in ARCHS for f in FORMS}
    res = run_ranks(moe_ep_ranks, WORLD, weights, tokens, CASES,
                    timeout=240.0)
    return weights, tokens, res


# --------------------------------------------------------------------- #
# the reference: JAX's bodies under vmap, its routing from its helpers
# --------------------------------------------------------------------- #
def _jax_bodies(arch, ep, form, cf, weights, x):
    jcfg, _ = _cfgs(arch, cf)
    body = jmoe._moe_local_a2a if form == "a2a" else jmoe._moe_local_psum
    E_loc = weights["wg"].shape[0] // ep
    shard = lambda a: jnp.asarray(a.reshape((ep, E_loc) + a.shape[1:]))
    xs = jnp.stack([jnp.asarray(local_x(x, form, ep, r))
                    for r in range(ep)])
    fn = jax.jit(jax.vmap(functools.partial(body, cfg=jcfg, ep=ep,
                                            axis="model"),
                          in_axes=(0, None, 0, 0, 0), axis_name="model"))
    y, aux = fn(xs, jnp.asarray(weights["router"]), shard(weights["wg"]),
                shard(weights["wu"]), shard(weights["wd"]))
    return np.asarray(y), np.asarray(aux)


def _jax_routes(arch, ep, form, cf, weights, x):
    """Each rank's integer routing as JAX's body computes it."""
    jcfg, _ = _cfgs(arch, cf)
    E_loc = weights["wg"].shape[0] // ep
    xs = [jnp.asarray(local_x(x, form, ep, r)) for r in range(ep)]
    fn = jax.jit(functools.partial(_routes_traced, jcfg=jcfg, ep=ep,
                                   form=form, E_loc=E_loc))
    return [{n: np.asarray(v) for n, v in rt.items()}
            for rt in fn(xs, jnp.asarray(weights["router"]))]


def _routes_traced(xs, router, *, jcfg, ep, form, E_loc):
    k, cf = jcfg.moe_top_k, jcfg.moe_capacity_factor
    one_hot = lambda i, n: jax.nn.one_hot(i, n, dtype=jnp.int32)
    routes, sends = [], []
    for r, xl in enumerate(xs):
        T = xl.shape[0] * xl.shape[1]
        _, ids, _ = jmoe._route(xl.reshape(T, -1), router, jcfg)
        if form == "psum":
            local = ids // E_loc == r
            lids = jnp.where(local, ids % E_loc, E_loc).reshape(-1)
            cap = max(int(-(-T * k // E_loc) * cf), 1)
            pos = jmoe._positions_in_bins(one_hot(lids, E_loc))
            routes.append({"ids": ids, "pos": pos,
                           "keep": (pos < cap) & local.reshape(-1)})
            continue
        cap = max(int(-(-T * k // ep) * cf), 1)
        flat = ids.reshape(-1)
        dest = flat // E_loc
        pos = jmoe._positions_in_bins(one_hot(dest, ep))
        valid = pos < cap
        send = jnp.full((ep, cap), E_loc, jnp.int32).at[
            jnp.where(valid, dest, ep), jnp.where(valid, pos, cap)].set(
                flat % E_loc, mode="drop")
        routes.append({"ids": ids, "pos": pos, "keep": valid})
        sends.append(send)
    if form == "a2a":
        R = ep * sends[0].shape[1]
        cap2 = -(-R // E_loc)
        for r in range(ep):
            reid = jnp.concatenate([s[r] for s in sends])
            pos2 = jmoe._positions_in_bins(one_hot(reid, E_loc))
            routes[r].update(pos2=pos2, keep2=(pos2 < cap2) & (reid < E_loc))
    return routes


def _jax_dense(arch, weights, x):
    jcfg, _ = _cfgs(arch, 8.0)
    y, aux = jmoe.moe_apply_dense(
        {n: jnp.asarray(v) for n, v in weights.items()}, jnp.asarray(x),
        jcfg)
    return np.asarray(y), np.asarray(aux)


# --------------------------------------------------------------------- #
# the tests
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,ep,form,cf", CASES)
def test_ep_bodies_match_jax(ranks, arch, ep, form, cf):
    weights, tokens, res = ranks
    w, x = weights[arch], tokens[arch, form]
    jy, jaux = _jax_bodies(arch, ep, form, cf, w, x)
    jroutes = _jax_routes(arch, ep, form, cf, w, x)
    dropped = 0
    for r in range(ep):
        y, aux, route, recs = res[r][0][arch, ep, form, cf]
        assert [k for k, _, _ in recs] == KINDS[form]
        assert all(n == ep for _, _, n in recs)
        assert comm_stats.total_collective_bytes(recs) == \
            _wire_bytes(form, ep, cf, w, x)
        assert set(route) == set(jroutes[r])
        for n, want in jroutes[r].items():
            np.testing.assert_array_equal(route[n], want, err_msg=n)
        dropped += int(np.sum(~route["keep"]))
        np.testing.assert_allclose(y, jy[r], **TOL)
        np.testing.assert_allclose(aux, jaux[r], **TOL)
    if form == "psum":       # every rank's share sums to the same output
        np.testing.assert_allclose(res[1][0][arch, ep, form, cf][0],
                                   res[0][0][arch, ep, form, cf][0],
                                   **TOL)
    if cf == 8.0:
        dy, _ = _jax_dense(arch, w, x)
        got = np.concatenate([res[r][0][arch, ep, form, cf][0]
                              for r in range(ep)], axis=1) \
            if form == "a2a" else res[0][0][arch, ep, form, cf][0]
        np.testing.assert_allclose(got, dy - _shared(arch, w, x), **TOL)
    elif cf == 0.5 and form == "a2a":
        assert dropped > 0                # the capacity bites


KINDS = {"a2a": ["all-to-all"] * 3 + ["all-reduce"],
         "psum": ["all-reduce"] * 2}


def _wire_bytes(form, ep, cf, w, x):
    """One layer's wire bytes per rank in closed form (float32): a2a
    sends (ep, cap, D) out and back and the (ep, cap) int32 expert ids,
    each all-to-all (ep - 1)/ep of it; psum all-reduces (T, D), 2(ep -
    1)/ep of it; both all-reduce the scalar aux."""
    B, S, D = x.shape
    k = 2                                         # the reduced top-k
    ring = (ep - 1) / ep
    aux = 4 * 2 * ring
    if form == "psum":
        return int(B * S * D * 4 * 2 * ring + aux)
    cap = max(int(-(-(B * S // ep) * k // ep) * cf), 1)
    return int(2 * ep * cap * D * 4 * ring + ep * cap * 4 * ring + aux)


def _shared(arch, w, x):
    """The shared experts' SwiGLU, which `moe_apply_dense` adds and the
    bodies leave to `moe_apply`."""
    if "shared_wg" not in w:
        return 0.0
    from repro.models.common import swiglu
    return np.asarray(swiglu(jnp.asarray(x), *(jnp.asarray(w[n]) for n in (
        "shared_wg", "shared_wu", "shared_wd"))))


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("form", FORMS)
def test_moe_apply_on_mesh_matches_dense_and_its_gradients(ranks, shape,
                                                           form):
    """moe_apply on DTensors on a (data, model) = `shape` mesh (2 x 2
    shards the batch over "data"): y equals JAX's dense oracle at 8.0;
    aux equals the mean over the data ranks of the aux that JAX's bodies
    (under vmap over the model ranks) return for each data rank's batch
    share; the gradients of sum(y * c) + 0.01 aux equal jax.grad of the
    dense oracle's y and of that mean of the ranks' aux."""
    arch = "qwen2-moe-a2.7b"
    weights, tokens, res = ranks
    w, x = weights[arch], tokens[arch, form]
    jcfg, _ = _cfgs(arch, 8.0)
    n_dp, ep = shape
    c = jnp.asarray(np.cos(np.arange(x.size, dtype=np.float32)).reshape(
        x.shape))
    halves = np.split(x, n_dp)
    want_aux = np.mean([_jax_bodies(arch, ep, form, 8.0, w, xd)[1][0]
                        for xd in halves])

    def rank_aux(p, xx):
        """The mean over data and model ranks of each rank's router aux,
        as JAX's bodies compute it (pmean over "model")."""
        auxes = [jmoe._route(xl.reshape(-1, xl.shape[-1]), p["router"],
                             jcfg)[2]
                 for xd in jnp.split(xx, n_dp)
                 for xl in (local_x(xd, form, ep, r) for r in range(ep))]
        return sum(auxes) / len(auxes)

    def loss(p, xx):
        y, _ = jmoe.moe_apply_dense(p, xx, jcfg)
        return jnp.sum(y * c) + GRAD_LOSS_AUX * rank_aux(p, xx)

    jp = {n: jnp.asarray(v) for n, v in w.items()}
    np.testing.assert_allclose(rank_aux(jp, jnp.asarray(x)), want_aux,
                               **TOL)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jnp.asarray(x))
    dy, _ = _jax_dense(arch, w, x)
    for r in range(WORLD):
        y, aux, grads = res[r][1][shape, form]
        np.testing.assert_allclose(y, dy, **TOL)
        np.testing.assert_allclose(aux, want_aux, **TOL)
        np.testing.assert_allclose(grads.pop("x"), np.asarray(gx), **TOL)
        assert set(grads) == set(gp) - {"pre_norm"}   # unused by the layer
        for n, g in grads.items():
            np.testing.assert_allclose(g, np.asarray(gp[n]), **TOL,
                                       err_msg=n)


def test_one_card_moe_apply_stays_dense():
    """No mesh, or an expert axis of 1: the dense form, unchanged."""
    import types
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    w = init_tree(torch.Generator().manual_seed(0),
                  tmoe.moe_params(cfg, torch.float32))
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    want = tmoe.moe_apply_dense(w, x, cfg)
    for mesh in (None, types.SimpleNamespace(shape={"data": 4,
                                                     "model": 1})):
        y, aux = tmoe.moe_apply(w, x, cfg, mesh)
        assert torch.equal(y, want[0]) and torch.equal(aux, want[1])
    with pytest.raises(TypeError, match="DTensors"):
        tmoe.moe_apply(w, x, cfg, types.SimpleNamespace(
            shape={"data": 1, "model": 2}))
