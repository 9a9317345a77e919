"""The BW-KV client of the port against the JAX one: the quickstart's
sequence on a small cluster, both services stepping under the same JAX
key schedule (the port through the JAX draw tape)."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro.core import state as JSM
from repro.kvstore.service import BWKVService as JaxKV
from repro_torch.core import state as TSM
from repro_torch.kvstore.service import BWKVService as TorchKV

from test_torch_runtime import assert_states_equal, sim_pair
from test_torch_tape import small_config


def test_kv_service_matches_jax():
    """The quickstart's client sequence — elect, lease, put/get, kill
    every spot node with phi=1, put/get again — returns the same values,
    revisions and latencies through both services."""
    cfg = small_config("tkv", followers=(2, 2, 1))
    jsim, tsim = sim_pair(cfg, write_rate=2.0, read_rate=8.0, seed=0)
    jkv, tkv = JaxKV(jsim), TorchKV(tsim)
    for kv in (jkv, tkv):
        kv._step(60)
    assert int(JSM.leader_id(jsim.state, jsim.static)) == \
        int(TSM.leader_id(tsim.state))
    jsim._lease(2, 3)
    tsim._lease(2, 3)

    def set_phi(kv, sim, phi):
        sim.set_rates(phi=phi)
        # the JAX service jits its tick with cfg_c closed over, so a
        # later set_rates never reaches it; drop the trace so both
        # services step with the new phi
        if isinstance(kv, JaxKV):
            kv._tickfn = None

    def script(kv, sim):
        out = [kv.put("paper/title", 2022), kv.get("paper/title")]
        set_phi(kv, sim, 1.0)
        kv._step(5)
        alive = np.array(sim.state["alive"])       # every spot node killed
        assert not alive[~sim.static["is_voter"]].any()
        set_phi(kv, sim, 0.0)
        out += [kv.put("paper/venue", 42), kv.get("paper/venue"),
                kv.get("paper/title")]
        return out, list(kv.read_latencies)

    jout, tout = script(jkv, jsim), script(tkv, tsim)
    assert [dataclasses.astuple(x) if dataclasses.is_dataclass(x) else x
            for x in jout[0]] == \
        [dataclasses.astuple(x) if dataclasses.is_dataclass(x) else x
         for x in tout[0]]
    assert jout[1] == tout[1]
    assert tout[0][1][0] == 2022 and tout[0][3][0] == 42
    assert_states_equal(jsim.state, tsim.state, "kv")
