"""State parity: every leaf of the port's `build_static`, `init_state`
and `make_cfg_arrays` equals the JAX package's in name, dtype, shape and
value — for a small cluster and for the paper's CONFIG, unpadded and
padded — plus the numpy round trip, the uint32 digest mix carried as
int32 bits, the recompute-from-scratch `prefix_digest` and
`pytree_nbytes`."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs.bwraft_kv import CONFIG as J_CONFIG
from repro.core import runtime as JRT
from repro.core import state as JSM
from repro_torch.configs.bwraft_kv import CONFIG as T_CONFIG
from repro_torch.core import runtime as TRT
from repro_torch.core import state as TSM

from test_torch_tape import port_config, small_config

PADS = [dict(), dict(pad_nodes=3, pad_sites=2, pad_log=40, pad_keys=9),
        dict(n_obs_digest=5, pad_obs=2, trace_capacity=32)]


def _configs():
    return [("small", small_config(), port_config(small_config())),
            ("paper", J_CONFIG, T_CONFIG)]


def _assert_tree_equal(j, t, ctx):
    assert set(j) == set(t), (ctx, set(j) ^ set(t))
    for k in j:
        a, b = j[k], t[k]
        if isinstance(a, (int, float, bool)):
            assert a == b and type(a) is type(b), (ctx, k, a, b)
            continue
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (ctx, k, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), (ctx, k)


@pytest.mark.parametrize("pads", PADS, ids=["unpadded", "padded", "obs"])
@pytest.mark.parametrize("name", ["small", "paper"])
def test_static_and_state_equal_jax(name, pads):
    jcfg, tcfg = {n: (j, t) for n, j, t in _configs()}[name]
    sk = {k: v for k, v in pads.items() if k not in ("pad_log", "pad_keys")}
    ik = {k: v for k, v in pads.items() if k in ("pad_log", "pad_keys")}
    js, ts = JSM.build_static(jcfg, **sk), TSM.build_static(tcfg, **sk)
    _assert_tree_equal(js, ts, f"{name} static {pads}")
    jst = JSM.init_state(jcfg, js, **ik)
    tst = TSM.to_numpy(TSM.init_state(tcfg, ts, "cpu", **ik))
    _assert_tree_equal({k: np.asarray(v) for k, v in jst.items()}, tst,
                       f"{name} state {pads}")
    assert JSM.hist_bins(jcfg) == TSM.hist_bins(tcfg)


@pytest.mark.parametrize("kw", [
    dict(write_rate=8.0, read_rate=32.0),
    dict(write_rate=2.5, read_rate=7.0, phi=0.3, pad_nodes=2, pad_sites=1,
         pad_keys=5, spot_price_vol=0.5, cross_shard_frac=0.25,
         two_pc_ticks=6, warning_ticks=3, spot_bid=[0.02, 0.03],
         bid_on_trace=True, trace_on=True,
         trace_mask=(True, False, True, True, False, True))])
def test_cfg_arrays_equal_jax(kw):
    j = JRT.make_cfg_arrays(J_CONFIG, **kw)
    t = TSM.to_numpy(TRT.make_cfg_arrays(T_CONFIG, "cpu", **kw))
    _assert_tree_equal({k: np.asarray(v) for k, v in j.items()}, t,
                       "cfg_c")


def test_numpy_round_trip_and_uint32_bits():
    """from_numpy keeps dtypes, carries uint32 as int32 bits, and
    to_numpy restores the uint32 view exactly."""
    rng = np.random.default_rng(0)
    tree = {"applied_digest": rng.integers(0, 2 ** 32, 9, dtype=np.uint32),
            "log_term": rng.integers(-5, 5, (3, 4)).astype(np.int32),
            "alive": rng.random(9) < 0.5, "tick": np.int32(7),
            "cost_accrued": np.float32(0.25), "N": 9}
    t = TSM.from_numpy(tree, "cpu")
    assert t["applied_digest"].dtype == torch.int32
    assert t["tick"].shape == () and t["N"] == 9
    back = TSM.to_numpy(t)
    for k, v in tree.items():
        if isinstance(v, int):
            continue
        assert back[k].dtype == np.asarray(v).dtype, k
        assert np.array_equal(back[k], v), k


def test_entry_mix_matches_jax_uint32():
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 4096, 1000).astype(np.int32)
    key = rng.integers(-3, 2 ** 20, 1000).astype(np.int32)
    val = rng.integers(0, 2 ** 31 - 1, 1000).astype(np.int32)
    want = np.asarray(JSM.entry_mix(pos, key, val))
    got = TSM.entry_mix(*(torch.as_tensor(a) for a in (pos, key, val)))
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_leader_id_matches_jax():
    rng = np.random.default_rng(2)
    for _ in range(20):
        role = rng.integers(0, 6, 11).astype(np.int32)
        alive = rng.random(11) < 0.7
        want = int(JSM.leader_id({"role": role, "alive": alive}, None))
        got = TSM.leader_id({"role": torch.as_tensor(role),
                             "alive": torch.as_tensor(alive)})
        assert got.dtype == torch.int32 and int(got) == want


@pytest.mark.parametrize("L", [1, 7, 64, 1000])
def test_prefix_digest_matches_jax(L):
    """The recompute-from-scratch digest of a seeded log row at several
    prefixes (empty, one entry, odd, whole) equals JAX's uint32 bit for
    bit, one row at a time and for the rows together."""
    rng = np.random.default_rng(L)
    keys = rng.integers(-3, 2 ** 20, (5, L)).astype(np.int32)
    vals = rng.integers(0, 2 ** 31 - 1, (5, L)).astype(np.int32)
    uptos = np.array([0, 1, L // 2 + 1, L, L + 3])
    want = np.array([JSM.prefix_digest(k, v, int(u), xp=np)
                     for k, v, u in zip(keys, vals, uptos)], np.uint32)
    jax_want = np.array([np.asarray(JSM.prefix_digest(k, v, int(u)))
                         for k, v, u in zip(keys, vals, uptos)], np.uint32)
    assert np.array_equal(want, jax_want)
    rows = [TSM.prefix_digest(torch.as_tensor(k), torch.as_tensor(v), int(u))
            for k, v, u in zip(keys, vals, uptos)]
    assert all(r.dtype == torch.int32 and r.shape == () for r in rows)
    assert np.array_equal(np.array([int(r) for r in rows], np.int64)
                          .astype(np.int32).view(np.uint32), want)
    batched = TSM.prefix_digest(torch.as_tensor(keys), torch.as_tensor(vals),
                                torch.as_tensor(uptos))
    assert np.array_equal(batched.numpy().view(np.uint32), want)


def test_pytree_nbytes_matches_jax():
    """Bytes from shapes and dtypes only: the paper cluster's state and
    static tables as JAX counts them, and Python scalars and None as
    JAX's weakly typed leaves count."""
    js = JSM.build_static(J_CONFIG, n_obs_digest=5)
    ts = TSM.build_static(T_CONFIG, n_obs_digest=5)
    jst = JSM.init_state(J_CONFIG, js)
    tst = TSM.init_state(T_CONFIG, ts, "cpu")
    assert TSM.pytree_nbytes(tst) == JSM.pytree_nbytes(jst) > 0
    assert TSM.pytree_nbytes(TSM.to_numpy(tst)) == JSM.pytree_nbytes(jst)
    arrays = {k: v for k, v in js.items() if isinstance(v, np.ndarray)}
    assert TSM.pytree_nbytes(arrays) == JSM.pytree_nbytes(arrays)
    odd = {"a": 3, "b": 2.5, "c": True, "d": None,
           "e": [np.zeros((2, 3), np.int16), (torch.zeros(5, dtype=torch.
                                                          bfloat16),)]}
    jodd = dict(odd, e=[odd["e"][0], (jax.numpy.zeros(5, jax.numpy.
                                                       bfloat16),)])
    assert TSM.pytree_nbytes(odd) == JSM.pytree_nbytes(jodd) == 4 + 4 + 1 + \
        12 + 10
