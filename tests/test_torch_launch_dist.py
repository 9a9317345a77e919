"""The port's launch layer for many ranks (ROADMAP.md §1 item 10e):
`launch/mesh.py` over a fake process group of 256 and 512 ranks (in a
subprocess: the group is global), `launch/comm_stats.py` against JAX's
`repro.launch.hlo_stats` on HLO lines written for the same collectives
at the same group sizes, and `launch/cluster.py` against JAX's stub."""
from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.launch import cluster as jcluster
from repro.launch import hlo_stats
from repro_torch.launch import cluster as tcluster
from repro_torch.launch import comm_stats
from repro_torch.launch import mesh as tmesh

SRC = Path(__file__).resolve().parent.parent / "src"

# rank 17 of 512: pod 0, data 1, model 1
_FAKE_GROUP = r"""
import json
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as fc
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import mesh as M
from repro_torch.launch.comm_stats import CollectiveRecorder

out = {}
dist.init_process_group("fake", store=FakeStore(), rank=17, world_size=512)
m = M.make_production_mesh(multi_pod=True, device_type="cpu")
out["multi"] = [m.shape, {a: m.group(a).size() for a in m.shape},
                list(m.device_mesh.mesh_dim_names)]
try:
    M.make_production_mesh(device_type="cpu")
except ValueError as e:
    out["refused"] = str(e)
t = distribute_tensor(torch.arange(512.0), m.device_mesh,
                      [Replicate(), Shard(0), Shard(0)], src_data_rank=None)
out["rows"] = t.to_local().tolist()
with CollectiveRecorder() as rec:
    x = torch.ones(8, 16)
    g = m.group("model")
    fc.wait_tensor(fc.all_reduce(x, "sum", g))
    fc.wait_tensor(fc.all_gather_tensor(x, 0, m.group("data")))
    fc.wait_tensor(fc.reduce_scatter_tensor(x, "sum", 0, m.group("pod")))
    fc.wait_tensor(fc.all_to_all_single(torch.ones(32, 16).bfloat16(), None,
                                        None, g))
    dist.all_reduce(x, group=m.group("data"))
    dist.all_to_all_single(torch.empty(32, 4), torch.ones(32, 4), group=g)
    u = distribute_tensor(torch.ones(512, 4), m.device_mesh,
                          [Replicate(), Shard(0), Shard(0)],
                          src_data_rank=None)
    u.redistribute(m.device_mesh, [Replicate()] * 3)
out["records"] = [list(r) for r in rec.records]
dist.destroy_process_group()
dist.init_process_group("fake", store=FakeStore(), rank=3, world_size=256)
m = M.make_production_mesh(device_type="cpu")
out["single"] = [m.shape, {a: m.group(a).size() for a in m.shape}]
try:
    M.make_production_mesh(multi_pod=True, device_type="cpu")
except ValueError as e:
    out["refused_multi"] = str(e)
dist.destroy_process_group()
dist.init_process_group("fake", store=FakeStore(), rank=5, world_size=8)
out["host"] = [M.make_host_mesh(model=4, device_type="cpu").shape,
               M.make_host_mesh(model=16, device_type="cpu").shape,
               M.make_host_mesh(device_type="cpu").shape]
print(json.dumps(out))
"""

# the same collectives as HLO lines, in the order `_FAKE_GROUP` makes them
_HLO = """
%all-reduce.1 = f32[8,16]{1,0} all-reduce(f32[8,16]{1,0} %p0), replica_groups=[32,16]<=[512], to_apply=%add
%all-gather.2 = f32[128,16]{1,0} all-gather(f32[8,16]{1,0} %p0), replica_groups=[32,16]<=[16,2,16]T(1,0,2), dimensions={0}
%reduce-scatter.3 = f32[4,16]{1,0} reduce-scatter(f32[8,16]{1,0} %p0), replica_groups=[256,2]<=[2,256]T(1,0), dimensions={0}, to_apply=%add
%all-to-all.4 = bf16[32,16]{1,0} all-to-all(bf16[32,16]{1,0} %p1), replica_groups=[32,16]<=[512], dimensions={0}
%all-reduce-start.5 = f32[8,16]{1,0} all-reduce-start(f32[8,16]{1,0} %p0), replica_groups=[32,16]<=[16,2,16]T(1,0,2), to_apply=%add
%all-reduce-done.5 = f32[8,16]{1,0} all-reduce-done(f32[8,16]{1,0} %all-reduce-start.5)
%all-to-all.6 = f32[32,4]{1,0} all-to-all(f32[32,4]{1,0} %p2), replica_groups=[32,16]<=[512], dimensions={0}
%all-gather.7 = f32[32,4]{1,0} all-gather(f32[2,4]{1,0} %p3), replica_groups=[32,16]<=[512], dimensions={0}
%all-gather.8 = f32[512,4]{1,0} all-gather(f32[32,4]{1,0} %all-gather.7), replica_groups=[32,16]<=[16,2,16]T(1,0,2), dimensions={0}
"""


@pytest.fixture(scope="module")
def fake_group():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _FAKE_GROUP], env=env,
                         capture_output=True, text=True, timeout=180,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_production_meshes(fake_group):
    shape, groups, names = fake_group["multi"]
    assert shape == {"pod": 2, "data": 16, "model": 16} == groups
    assert names == ["pod", "data", "model"]
    assert "needs a process group of 256 ranks, not 512" in \
        fake_group["refused"]
    shape, groups = fake_group["single"]
    assert shape == {"data": 16, "model": 16} == groups
    assert "of 512 ranks, not 256" in fake_group["refused_multi"]
    # a dim split over ("data", "model") takes data as the major axis
    assert fake_group["rows"] == [34.0, 35.0]


def test_host_meshes(fake_group):
    assert fake_group["host"] == [{"data": 2, "model": 4},
                                  {"data": 1, "model": 8},
                                  {"data": 8, "model": 1}]
    m = tmesh.make_host_mesh(model=4)        # no process group: one rank
    assert m.shape == {"data": 1, "model": 1} and m.device_mesh is None
    with pytest.raises(ValueError, match="one rank"):
        m.group("model")


def test_hw_is_the_h100():
    hw = tmesh.HW
    assert hw["name"] == "NVIDIA H100 80GB HBM3"
    assert hw["peak_flops_bf16"] == 989e12 and hw["hbm_gbps"] == 3.35e12
    assert hw["hbm_bytes"] == 80 * 2**30 and hw["power_limit_w"] == 700.0


def test_comm_stats_match_jax(fake_group):
    recs = [comm_stats.Record(*r) for r in fake_group["records"]]
    want = hlo_stats.collective_stats(_HLO)
    got = comm_stats.collective_stats(recs)
    assert got == want
    assert comm_stats.total_collective_bytes(recs) == \
        hlo_stats.total_collective_bytes(_HLO)
    assert comm_stats.render_stats(got) == hlo_stats.render_stats(want)
    assert comm_stats.render_stats({}) == hlo_stats.render_stats({})
    for n in (1, 2, 16, 512):
        for kind in comm_stats.COLLECTIVES:
            assert comm_stats._wire_factor(kind, n) == \
                hlo_stats._wire_factor(kind, n)
    for dt, dims in (("bf16", "8,16"), ("s32", ""), ("pred", "3"),
                     ("f8e4m3fn", "2,2"), ("c64", "4")):
        assert comm_stats.shape_bytes(dt, dims) == \
            hlo_stats.shape_bytes(dt, dims)


def _main_out(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().splitlines()


@pytest.mark.parametrize("argv", [
    [], ["--coordinator", "10.0.0.1:8476", "--num-pods", "4", "--pod-id",
         "3", "--chips-per-pod", "8"]])
def test_cluster_stub_matches_jax(argv):
    jrc, jout = _main_out(jcluster.main, argv)
    trc, tout = _main_out(tcluster.main, argv)
    assert trc == jrc == 0
    assert tout[0] == jout[0]
    assert "init_process_group('nccl'" in tout[1]
    assert "make_production_mesh(multi_pod=True)" in tout[1]
    assert "shard=pod_id" in tout[1]
    with pytest.raises(SystemExit):
        tcluster.main(["--pod-id", "x"])
