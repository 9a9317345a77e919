"""The port's market services (`repro_torch.market`: traces, synthetic
providers, calibration and bid policies) against the JAX package's on
the CPU, and `BWRaftSim` under a trace market, a calibrated predictor
and a bid policy against a live JAX run fed the same draw tape.

Host code (loaders, resampling, fits, bids, the numpy processes) must be
equal bit for bit.  In the epoch, integer, bool and digest results must
be equal and float results are held to rtol=1e-6 (XLA reorders float32
sums inside its jitted epoch)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro import market as JM
from repro.core import runtime as JRT
from repro_torch import market as TM
from repro_torch.core import runtime as TRT

from test_torch_runtime import assert_reports_equal, assert_states_equal
from test_torch_tape import JaxTape, port_config, small_config


def assert_trees_equal(a, b, ctx=""):
    """Dataclass (or dict) fields equal, arrays bit for bit."""
    a = dataclasses.asdict(a) if dataclasses.is_dataclass(a) else a
    b = dataclasses.asdict(b) if dataclasses.is_dataclass(b) else b
    assert set(a) == set(b), ctx
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, (ctx, k)
            assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), \
                (ctx, k)
        else:
            assert x == y, (ctx, k, x, y)


def assert_traces_equal(a, b):
    assert a.name == b.name
    assert np.array_equal(a.price, b.price) and a.price.dtype == b.price.dtype
    assert np.array_equal(a.revoked, b.revoked)
    assert (a.revoked_node is None) == (b.revoked_node is None)
    if a.revoked_node is not None:
        assert np.array_equal(a.revoked_node, b.revoked_node)


# --------------------------------------------------------------------- #
# market/traces.py
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name,kw", [
    ("aws-us-east", {"ticks": 300}),
    ("aws-us-east", {"ticks": 200, "bid_multiplier": 1.2}),
    ("google-evict", {"ticks": 250}),
    ("google-evict", {"ticks": 150, "sites": 3, "node_rows": 7,
                      "price_mean": 0.02}),
])
def test_bundled_traces_equal_jax(name, kw):
    """Both loaders over the port's copies of the sample files, the fit
    rules and the empirical hazard equal the JAX package's."""
    assert TM.available_traces() == JM.available_traces()
    j, t = JM.load(name, **kw), TM.load(name, **kw)
    assert_traces_equal(j, t)
    for sites, ticks in ((2, 90), (5, 400)):
        assert_traces_equal(j.fit_to(sites, ticks), t.fit_to(sites, ticks))
    if j.revoked_node is not None:
        assert np.array_equal(j.node_columns(11, 333),
                              t.node_columns(11, 333))
    assert np.array_equal(j.empirical_revocation_rates(),
                          t.empirical_revocation_rates())
    with pytest.raises(KeyError, match="unknown trace"):
        TM.load("nope")


def test_resampling_rules_equal_jax():
    rng = np.random.default_rng(3)
    times = rng.uniform(0, 100, 40)
    vals = rng.uniform(0, 1, 40)
    for ticks, span in ((17, (0.0, 100.0)), (64, (-5.0, 120.0))):
        assert np.array_equal(JM.resample_price(times, vals, ticks, span),
                              TM.resample_price(times, vals, ticks, span))
        assert np.array_equal(JM.bucket_events(times, ticks, span),
                              TM.bucket_events(times, ticks, span))


# --------------------------------------------------------------------- #
# market/synthetic.py
# --------------------------------------------------------------------- #
def test_numpy_processes_equal_jax():
    """Regime-switching and correlated-shock traces, and the walk's
    parameters, equal the JAX package's bit for bit."""
    cfg = small_config()
    pcfg = port_config(cfg)
    for pad in (0, 2):
        jw = JM.walk_params_from_cluster(cfg, pad_sites=pad,
                                         spot_price_vol=0.3)
        tw = TM.walk_params_from_cluster(pcfg, pad_sites=pad,
                                         spot_price_vol=0.3)
        for a, b in zip(jw, tw):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    for cls, kw in ((JM.RegimeSwitchingWalk, {"p_spike": 0.1}),
                    (JM.CorrelatedSiteShocks, {"correlation": 0.8})):
        tcls = getattr(TM, cls.__name__)
        j = cls.from_cluster(cfg, **kw).materialize(300, seed=7)
        t = tcls.from_cluster(pcfg, **kw).materialize(300, seed=7)
        assert_traces_equal(j, t)


def test_export_walk_trace_equals_jax_under_the_tape():
    """Under the JAX tape the exporter's trace equals JAX's exporter's,
    padded sites included."""
    cfg = small_config()
    for pad in (0, 1):
        j = JM.export_walk_trace(cfg, seed=3, epochs=2, pad_sites=pad)
        t = TM.export_walk_trace(port_config(cfg), seed=3, epochs=2,
                                 pad_sites=pad, draws=JaxTape(3),
                                 device="cpu")
        assert_traces_equal(j, t)
    w = TM.MeanRevertingWalk(port_config(cfg), device="cpu")
    assert_traces_equal(w.materialize(100, seed=3),
                        TM.export_walk_trace(port_config(cfg), seed=3,
                                             epochs=2, device="cpu"))


def test_export_walk_trace_replays_bit_identically():
    """The §10 replay invariant within the port: a walk exported from the
    port's own draws (`TorchDraws(seed)`) and fed back as a trace market
    gives the process-market run's reports and state exactly."""
    cfg = port_config(small_config())
    trace = TM.export_walk_trace(cfg, seed=4, epochs=2, device="cpu")
    a = TRT.BWRaftSim(cfg, seed=4, phi=0.02, device="cpu")
    b = TRT.BWRaftSim(cfg, seed=4, phi=0.02, market="trace", trace=trace,
                      device="cpu")
    for e in range(2):
        assert repr(a.run_epoch()) == repr(b.run_epoch()), e
    for k, v in a.state.items():
        assert torch.equal(v, b.state[k]), k


def _replay_kw(case):
    """Sim knobs of the replay cases: each changes how much of the
    non-price draw stream an epoch uses (its rates, its plan, N, O)."""
    from repro_torch import workload as TW
    if case == "write16":
        return {"write_rate": 16.0}
    if case == "open_loop":
        return {"arrivals": TW.OpenLoop(
            write=TW.DiurnalRate(3.0, amplitude=0.5, phase=0.3),
            read=TW.FlashCrowd(TW.DiurnalRate(20.0, amplitude=0.5),
                               mult=4.0, every_ticks=25, burst_ticks=5),
            ticks=60)}
    if case == "observers":
        return {"n_observers": 16}
    return {"pad_nodes": 3}


@pytest.mark.parametrize("case", ["write16", "open_loop", "observers",
                                  "pad_nodes"])
def test_export_walk_trace_replays_other_rates_and_shapes(case):
    """The replay invariant away from the exporter's own rates and
    shapes: the walk exported from `TorchDraws(seed)` replays a
    same-seed sim at another write rate, under an open-loop plan, with
    digest-tier observers or with padded nodes, reports and state
    exactly (the price stream depends on the seed and S alone)."""
    cfg = port_config(small_config())
    kw = dict(seed=4, phi=0.02, device="cpu", **_replay_kw(case))
    trace = TM.export_walk_trace(cfg, seed=4, epochs=2, device="cpu")
    a = TRT.BWRaftSim(cfg, **kw)
    b = TRT.BWRaftSim(cfg, market="trace", trace=trace, **kw)
    for e in range(2):
        assert repr(a.run_epoch()) == repr(b.run_epoch()), (case, e)
    for k, v in a.state.items():
        assert torch.equal(v, b.state[k]), (case, k)


def test_export_walk_trace_replays_a_padded_fleet_member():
    """A fleet member padded to a wider member's N follows the walk the
    exporter gives for its own cluster and seed: fed back as a trace
    market, the member's reports and state are the process-market
    run's."""
    from repro_torch.core.fleet import FleetSim, MemberSpec
    from repro_torch.core.state import member
    cfg = port_config(small_config())
    wide = port_config(small_config("twide", followers=(4, 3)))
    trace = TM.export_walk_trace(cfg, seed=4, epochs=2, device="cpu")
    other = MemberSpec(cfg=wide, seed=9)
    a = FleetSim([MemberSpec(cfg=cfg, seed=4, phi=0.02), other],
                 device="cpu")
    b = FleetSim([MemberSpec(cfg=cfg, seed=4, phi=0.02, market="trace",
                             trace=trace), other], device="cpu")
    assert a.state["role"].shape[1] == wide.max_nodes > cfg.max_nodes
    for e in range(2):
        assert repr(a.run_epoch()[0]) == repr(b.run_epoch()[0]), e
    sa, sb = member(a.state, 0), member(b.state, 0)
    for k, v in sa.items():
        assert torch.equal(v, sb[k]), k


# --------------------------------------------------------------------- #
# market/calibrate.py
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def traces():
    return {n: (JM.load(n, ticks=600), TM.load(n, ticks=600))
            for n in ("aws-us-east", "google-evict")}


def test_calibration_equals_jax(traces):
    """epoch rates, the calibrated predictor and its report, the sliding
    window, the walk fit and the hazard-aware bids equal JAX's."""
    for name, (j, t) in traces.items():
        assert np.array_equal(JM.epoch_revocation_rates(j, 100),
                              TM.epoch_revocation_rates(t, 100))
        jp, jr = JM.calibrate_predictor(j, 100)
        tp, tr = TM.calibrate_predictor(t, 100)
        assert_trees_equal(jr, tr, name)
        assert np.array_equal(jp.predict(), tp.predict()) and \
            jp.alpha == tp.alpha
        for end, win in ((0, 50), (350, 120), (1500, 100), (40, 900)):
            assert np.array_equal(JM.sliding_window_rates(j, end, win),
                                  TM.sliding_window_rates(t, end, win))
        assert_trees_equal(JM.fit_walk(j), TM.fit_walk(t), name)
        mean = j.price.mean(axis=1)
        for window in (0, 100):
            jb = JM.HazardAwareBid(mean_price=mean, window_ticks=window)
            tb = TM.HazardAwareBid(mean_price=mean, window_ticks=window)
            for kw in ({"predictor": jp, "trace": j, "end_tick": 300,
                        "sites": 6},
                       {"predictor": jp, "sites": 2}, {"sites": 3}, {}):
                tkw = dict(kw)
                if "predictor" in kw:
                    tkw["predictor"] = tp
                if "trace" in kw:
                    tkw["trace"] = t
                assert np.array_equal(jb.update(**kw), tb.update(**tkw))
    rates = np.array([0.01, 0.2])
    assert np.array_equal(
        JM.calibrate.RevocationPredictor.calibrated(rates).predict(),
        TM.calibrate.RevocationPredictor.calibrated(rates).predict())


# --------------------------------------------------------------------- #
# cfg_c and the sim
# --------------------------------------------------------------------- #
def test_cfg_arrays_equal_jax():
    """Every item-8 leaf of `make_cfg_arrays` (trace widened and
    per-node, arrivals widened, Zipf keys padded, faults widened) equals
    the JAX package's; `market="trace"` without a trace is refused with
    the JAX package's message."""
    from repro.market.chaos import kill_nodes
    from repro.workload import DiurnalRate, OpenLoop, ZipfianKeys
    cfg = small_config()
    tr = JM.load("google-evict", ticks=80, node_rows=5)
    kw = dict(write_rate=3.0, read_rate=9.0, pad_nodes=3, pad_sites=1,
              pad_keys=5, market="trace", trace=tr, trace_ticks=120,
              arrivals=OpenLoop(write=DiurnalRate(2.0),
                                read=np.arange(30, dtype=np.float32),
                                ticks=30),
              arrival_ticks=70, keypop=ZipfianKeys(1.3),
              faults=kill_nodes([1, 2], 5, n_nodes=9, ticks=40),
              fault_ticks=60, warning_ticks=2, spot_bid=[0.02, 0.03],
              bid_on_trace=True)
    j = JRT.make_cfg_arrays(cfg, **kw)
    t = TRT.make_cfg_arrays(port_config(cfg), "cpu", **kw)
    assert set(j) == set(t)
    for k in j:
        a, b = np.asarray(j[k]), t[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k
    with pytest.raises(AssertionError, match="needs a market.MarketTrace"):
        JRT.make_cfg_arrays(cfg, write_rate=1.0, read_rate=1.0,
                            market="trace")
    with pytest.raises(ValueError, match="needs a market.MarketTrace"):
        TRT.make_cfg_arrays(port_config(cfg), "cpu", write_rate=1.0,
                            read_rate=1.0, market="trace")


@pytest.mark.parametrize("recipe", ["aws_bid_policy", "google_per_node"])
def test_trace_market_sim_matches_jax(recipe):
    """Two managed epochs under a bundled trace: the AWS prices with a
    calibrated predictor and a trailing-window hazard-aware bid policy
    (re-deriving revocations from the bids), or the Google evictions
    bucketed per node.  Every report, the
    bids after each epoch and the final state equal the JAX run."""
    cfg = small_config()
    if recipe == "aws_bid_policy":
        trace = JM.load("aws-us-east", ticks=100)
        mean = trace.fit_to(cfg.num_sites, 100).price.mean(axis=1)
        ev = dict(ticks=300, sites=cfg.num_sites)
        jp, _ = JM.calibrate_predictor(JM.load("google-evict", **ev), 50)
        tp, _ = TM.calibrate_predictor(TM.load("google-evict", **ev), 50)
        jkw = dict(bid_policy=JM.HazardAwareBid(mean_price=mean,
                                                window_ticks=50),
                   predictor=jp, bid_on_trace=True)
        tkw = dict(bid_policy=TM.HazardAwareBid(mean_price=mean,
                                                window_ticks=50),
                   predictor=tp, bid_on_trace=True)
        tname = "aws-us-east"
    else:
        trace = JM.load("google-evict", ticks=100, node_rows=6)
        jkw = tkw = dict(phi=0.0)
        tname = "google-evict"
    ttrace = TM.load(tname, ticks=100,
                     **({"node_rows": 6} if recipe != "aws_bid_policy"
                        else {}))
    kw = dict(seed=2, write_rate=4.0, read_rate=16.0, market="trace")
    jsim = JRT.BWRaftSim(cfg, backend="xla", trace=trace, **kw, **jkw)
    tsim = TRT.BWRaftSim(port_config(cfg), device="cpu", draws=JaxTape(2),
                         trace=ttrace, **kw, **tkw)
    for e in range(2):
        assert_reports_equal(jsim.run_epoch(), tsim.run_epoch(),
                             f"{recipe} epoch {e}")
        assert np.array_equal(np.asarray(jsim.cfg_c["spot_bid"]),
                              tsim.cfg_c["spot_bid"].numpy()), e
    assert_states_equal(jsim.state, tsim.state, recipe)
    if recipe == "aws_bid_policy":
        assert not np.allclose(tsim.cfg_c["spot_bid"].numpy(),
                               1.5 * mean), "the policy never moved a bid"
    else:
        assert sum(r.killed for r in tsim.reports) > 0, \
            "no per-node revocation replayed"
