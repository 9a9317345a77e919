"""`launch.local_ranks.run_ranks`, the spawner of the port's distributed
checks: a rank that raises, or one that hangs past the time limit,
fails the run and every rank is stopped.

This module imports torch and the port only, so the ranks that
`tests/test_torch_moe_ep.py` spawns import it, and not JAX: their
side of the expert-parallel MoE checks (`moe_ep_ranks`) lives here.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.comm_stats import CollectiveRecorder
from repro_torch.launch.local_ranks import run_ranks
from repro_torch.models import moe as tmoe

WORLD = 4
GRAD_LOSS_AUX = 0.01


def local_x(x, form, ep, r):
    """Rank r's tokens: a2a shards the sequence, psum replicates."""
    if form == "psum":
        return x
    s = x.shape[1] // ep
    return x[:, r * s:(r + 1) * s]


def _cfg(arch, cf):
    return dataclasses.replace(get_config(arch).reduced(),
                               moe_capacity_factor=cf)


def _np(t):
    return t.detach().cpu().numpy()


def _run_cases(rank, weights, tokens, cases, groups):
    """Each (arch, ep, form, cf) case's body on this rank's share:
    (out, aux, integer routing) as numpy, and the collectives it made."""
    out = {}
    for case in cases:
        arch, ep, form, cf = case
        w = {k: torch.from_numpy(v) for k, v in weights[arch].items()}
        r = rank % ep
        E_loc = w["wg"].shape[0] // ep
        sl = slice(r * E_loc, (r + 1) * E_loc)
        x = torch.from_numpy(local_x(tokens[arch, form], form, ep, r))
        body = tmoe._moe_local_a2a if form == "a2a" else tmoe._moe_local_psum
        with CollectiveRecorder() as rec:
            y, aux, route = body(x, w["router"], w["wg"][sl], w["wu"][sl],
                                 w["wd"][sl], cfg=_cfg(arch, cf), ep=ep,
                                 group=groups[ep])
        out[case] = (_np(y), _np(aux), {k: _np(v) for k, v in
                                        route.items()}, rec.records)
    return out


def _run_apply(weights, tokens, forms=("a2a", "psum")):
    """moe_apply on DTensors: the forward on a 1 x 4 and a 2 x 2
    ("data", "model") mesh, both forms, at 8.0, and the gradients of
    sum(y * c) + 0.01 aux."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.axes import (TRAIN_RULES, logical_to_spec,
                                           placements)
    out = {}
    arch = "qwen2-moe-a2.7b"
    cfg = _cfg(arch, 8.0)
    specs = tmoe.moe_params(cfg, torch.float32)
    for shape in ((1, 4), (2, 2)):
        mesh = make_host_mesh(model=shape[1], device_type="cpu")
        assert tuple(mesh.shape.values()) == shape
        dm = mesh.device_mesh
        rep = [Replicate(), Replicate()]
        for form in forms:
            x = tokens[arch, form]
            c = np.cos(np.arange(x.size, dtype=np.float32)).reshape(x.shape)
            p = {k: distribute_tensor(
                    torch.from_numpy(v), dm,
                    placements(logical_to_spec(specs[k].axes, v.shape,
                                               TRAIN_RULES, mesh), mesh)
                 ).requires_grad_() for k, v in weights[arch].items()}
            dx = distribute_tensor(torch.from_numpy(x), dm,
                                   rep).requires_grad_()
            y, aux = tmoe.moe_apply(p, dx, cfg, mesh)
            loss = (y * distribute_tensor(torch.from_numpy(c), dm,
                                          rep)).sum() + GRAD_LOSS_AUX * aux
            loss.backward()
            grads = {k: _np(v.grad.full_tensor()) for k, v in p.items()
                     if v.grad is not None}
            grads["x"] = _np(dx.grad.full_tensor())
            out[shape, form] = (_np(y.full_tensor()),
                                _np(aux.full_tensor()), grads)
    return out


def moe_ep_ranks(rank, world, weights, tokens, cases):
    """A rank of `tests/test_torch_moe_ep.py`: the bodies in a group of
    4 and in two groups of 2, then `moe_apply` on DTensors."""
    import torch.distributed as dist
    torch.set_num_threads(1)          # four ranks share the host's cores
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    groups = {4: dist.group.WORLD, 2: pairs[rank // 2]}
    return (_run_cases(rank, weights, tokens, cases, groups),
            _run_apply(weights, tokens))


# --------------------------------------------------------------------- #
# run_ranks itself
# --------------------------------------------------------------------- #
def _fail_or_hang(rank, world, how):
    import torch.distributed as dist
    x = torch.full((2,), float(rank))
    dist.all_reduce(x)                    # every rank joined the group
    if rank == 1 and how == "raise":
        raise ValueError("rank 1 refuses")
    if rank == 1 and how == "hang":
        time.sleep(600)
    return x.tolist()


@pytest.mark.parametrize("how", ["raise", "hang"])
def test_a_failed_rank_fails_the_run(how):
    t0 = time.monotonic()
    want = "rank 1 raised" if how == "raise" else "did not finish within"
    with pytest.raises(RuntimeError, match=want) as err:
        run_ranks(_fail_or_hang, 2, how,
                  timeout=60.0 if how == "raise" else 12.0)
    if how == "raise":
        assert "ValueError: rank 1 refuses" in str(err.value)
    else:                         # rank 1 is among those left running
        assert "1] did not finish" in str(err.value)
    assert time.monotonic() - t0 < 50
