"""The port's training coordination against the JAX package's on the
CPU: the control-record schema and the straggler detector (bit for bit:
both are plain Python), the `ConsensusCoordinator` over a simulator pair
stepping under the JAX draw tape (leaders, revisions, committed records
and the final cluster state equal), the commit -> restore -> digest-tag
recovery path, and `launch.train.main` against the JAX `main` from the
same weights: the same committed steps and membership record, and
per-step losses within bf16 tolerance (bf16 weights: 3e-2 relative; the
read is 2e-3).  Both run the coordinator on the paper's cluster
(`configs.bwraft_kv`, N = 87), as JAX's `main` does."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.coord import log_records as jrec
from repro.coord import stragglers as jstrag
from repro.coord.coordinator import ConsensusCoordinator as JCoord
from repro.core import state as JSM
from repro_torch.coord import log_records as trec
from repro_torch.coord import stragglers as tstrag
from repro_torch.coord.coordinator import ConsensusCoordinator as TCoord
from repro_torch.core import state as TSM

from test_torch_runtime import assert_states_equal, sim_pair
from test_torch_tape import port_config, small_config
from test_torch_train import _init_params, np_tree


def test_log_records_equal_jax():
    assert [(r.name, int(r)) for r in jrec.RecordType] == \
        [(r.name, int(r)) for r in trec.RecordType]
    for ks in (64, 1000, 1024, 4096):
        assert jrec.record_base(ks) == trec.record_base(ks)
        for r in jrec.RecordType:
            assert jrec.ControlRecord(r, 5).key(ks) == \
                trec.ControlRecord(trec.RecordType(int(r)), 5).key(ks)
    for step in (0, 1, 20, 4095, 2 ** 18 - 1, 2 ** 18, 2 ** 18 + 7):
        for digest in ("000", "abc123", "fff0", "1cb70cbd3067b1b4"):
            v = jrec.pack_ckpt(step, digest)
            assert v == trec.pack_ckpt(step, digest)
            assert jrec.unpack_ckpt(v) == trec.unpack_ckpt(v)
    for k_s, k_o in ((0, 0), (3, 7), (1023, 1023), (1024, 1025)):
        v = jrec.pack_scale(k_s, k_o)
        assert v == trec.pack_scale(k_s, k_o)
        assert jrec.unpack_scale(v) == trec.unpack_scale(v)
    for bm in (0, 0b1011, 2 ** 30 - 1, 2 ** 31 + 5):
        assert jrec.pack_membership(bm) == trec.pack_membership(bm)


def test_straggler_decisions_equal_jax():
    """One heartbeat sequence over 6 pods: a pod that slows and recovers,
    one that stays slow, a failure, a pod that reports late: every
    call's newly-marked pods, and the pods' EWMAs, strikes and views."""
    rng = np.random.default_rng(0)
    j = jstrag.StragglerMitigator(6, threshold=1.5, patience=2)
    t = tstrag.StragglerMitigator(6, threshold=1.5, patience=2)
    for step in range(30):
        hb = {p: float(1.0 + 0.1 * rng.random()) for p in range(5)}
        if 5 <= step < 9:
            hb[2] = 2.5
        if step >= 12:
            hb[4] = 3.0
        if step >= 3:
            hb[5] = 1.0
        if step == 15:
            j.mark_failed(0)
            t.mark_failed(0)
        assert j.heartbeat(hb) == t.heartbeat(hb), step
        assert [dataclasses.astuple(p) for p in j.pods] == \
            [dataclasses.astuple(p) for p in t.pods], step
    assert j.reassignments == t.reassignments and 4 in t.reassignments
    assert j.active_pods == t.active_pods
    assert j.shard_assignment() == t.shard_assignment()
    assert j.membership_bitmap() == t.membership_bitmap()


def _coord_script(coord, leader_of):
    """Elect, commit, kill the leader, re-elect, read, commit membership
    and scale records and a second checkpoint, revive."""
    out = []
    lid = coord.wait_for_leader()
    out.append(("leader", lid))
    out.append(dataclasses.astuple(coord.commit_checkpoint(
        10, "abc123def4567890")))
    out.append(("before", coord.last_committed_checkpoint()))
    coord.kill_pod(lid)
    new = coord.wait_for_leader()
    out.append(("new leader", new, new != lid))
    coord.kv._step(100)
    out.append(("after", coord.last_committed_checkpoint()))
    coord.commit_membership(0b1011)
    coord.commit_scale(2, 3)
    out.append(dataclasses.astuple(coord.commit_checkpoint(
        20, "fe0123456789abcd")))
    coord.kv._step(40)
    out.append(("membership", coord.membership(),
                coord.last_committed_checkpoint()))
    coord.revive_pod(lid)
    coord.kv._step(30)
    out.append(("leader at end", leader_of(coord)))
    return out


def test_coordinator_matches_jax_under_the_tape():
    cfg = small_config("tcoord", followers=(2, 2, 1))
    jsim, tsim = sim_pair(cfg, mode="bwraft", write_rate=0.0,
                          read_rate=0.0, seed=4, manage_resources=False)
    j = _coord_script(JCoord(cfg, sim=jsim),
                      lambda c: int(JSM.leader_id(c.sim.state, c.sim.static)))
    tc = TCoord(port_config(cfg), sim=tsim)
    t = _coord_script(tc, lambda c: int(TSM.leader_id(c.sim.state)))
    assert j == t
    assert t[2] == ("before", (10, 0xabc)) and t[4] == ("after", (10, 0xabc))
    assert t[6][1:] == (0b1011, (20, 0xfe0))
    assert tc.ticks == int(tsim.state["tick"])
    assert_states_equal(jsim.state, tsim.state, "coordinator")


def test_commit_then_restore_via_consensus(tmp_path):
    """The recovery path: save -> CKPT_COMMIT -> read the committed step
    from the replicated state machine -> restore + digest-tag check, on
    the paper's cluster."""
    from repro_torch.checkpoint.store import CheckpointStore, tree_digest
    from repro_torch.configs.bwraft_kv import CONFIG
    store = CheckpointStore(str(tmp_path))
    coord = TCoord(CONFIG, seed=2, device="cpu")
    coord.wait_for_leader()
    gen = torch.Generator().manual_seed(4)
    t = {"a": torch.randn((16, 8), generator=gen),
         "b": {"c": torch.arange(10, dtype=torch.int32)}}
    digest = store.save(20, t)
    coord.commit_checkpoint(20, digest)
    step, tag = coord.last_committed_checkpoint()
    assert step == 20 and tag == int(digest[:3], 16)
    t2, d2 = store.restore(step, t)
    assert int(d2[:3], 16) == tag and tree_digest(t2) == d2
    assert torch.equal(t2["a"], t["a"])


def test_train_main_matches_jax(tmp_path, monkeypatch):
    """Both `main`s, reduced smollm-360m, 6 steps, a checkpoint every 2,
    pod 1 killed at step 3, from the same bf16 weights: the committed
    steps, the membership bitmap, and per-step losses within 3e-2."""
    from repro.configs import get_config as j_get_config
    from repro.configs.base import RunConfig as JRunConfig
    from repro.launch import steps as JS
    from repro.launch import train as jtrain
    from repro_torch.launch import steps as TS
    from repro_torch.launch import train as ttrain
    from repro_torch.models import lm as tlm
    argv = ["--arch", "smollm-360m", "--steps", "6", "--ckpt-every", "2",
            "--kill-at", "3", "--batch", "4", "--seq", "16", "--seed", "1"]
    params = np_tree(_init_params(JS.param_specs(
        j_get_config("smollm-360m").reduced(),
        JRunConfig(remat=False, num_microbatches=1)), seed=1))
    jl, jc, jcoords = [], [], []
    build = jtrain.build

    def jbuild(*a, **k):
        cfg, runcfg, mesh, step, pipe = build(*a, **k)

        def rec(state, batch):
            state, m = step(state, batch)
            jl.append(float(m["loss"]))
            return state, m
        return cfg, runcfg, mesh, rec, pipe

    commit = jtrain.ConsensusCoordinator.commit_checkpoint

    def jcommit(self, step, digest):
        jc.append(step)
        jcoords.append(self)
        return commit(self, step, digest)

    monkeypatch.setattr(jtrain, "build", jbuild)
    monkeypatch.setattr(jtrain, "init_tree", lambda rng, specs: jax.tree.map(
        lambda a, p: jnp.asarray(a).view(p.dtype) if a.dtype == np.uint16
        else jnp.asarray(a), params, specs))
    monkeypatch.setattr(jtrain.ConsensusCoordinator, "commit_checkpoint",
                        jcommit)
    assert jtrain.main(argv + ["--ckpt-dir", str(tmp_path / "j")]) == 0

    def carried(cfg, runcfg, *, seed, device):
        return TS.init_train_state(tlm.from_numpy(
            params, cfg, runcfg, device, trainable=True))

    monkeypatch.setattr(ttrain, "init_state", carried)
    rep = ttrain.main(argv + ["--ckpt-dir", str(tmp_path / "t"),
                              "--device", "cpu"])
    assert [c[0] for c in rep.commits] == jc == [2, 4, 6]
    assert rep.membership == jcoords[-1].membership() == 0b1101
    assert rep.start_step == 0 and len(rep.losses) == len(jl) == 6
    np.testing.assert_allclose(rep.losses, jl, rtol=3e-2)
    assert rep.coord.last_committed_checkpoint() == \
        (6, int(rep.commits[-1][1][:3], 16))
    assert len(rep.commit_ticks) == 3 and min(rep.commit_ticks) > 0
