"""What the SSD-scan launcher decides in Python, before any launch, and the
device guard every launcher shares, checked on the CPU with no card: the
(P, N, Q) the kernels accept and the route each takes (the tensor-core
kernels for bfloat16 with P and N in {64, 128}, the scalar kernel for the
rest) for every SSM configuration, the head-group rule of the tensor-core
route, the per-route counters, and that every ctypes launcher launches
inside `kernels.device_stream` of its own operand with the stream it
yields (the helper and the ctypes bindings patched)."""
from __future__ import annotations

import contextlib
import math
import types

import pytest
import torch

from repro_torch import kernels as tk
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import build
from repro_torch.kernels.ae_sync import kernel as aek
from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.group_digest import kernel as gdk
from repro_torch.kernels.leader_fanout import kernel as lfk
from repro_torch.kernels.raft_tick import kernel as rtk
from repro_torch.kernels.ssd_scan import kernel as sk
from repro_torch.kernels.ssd_scan import ops as ss

SSM_ARCHS = [a for a in ARCH_IDS if get_config(a).ssm_state]
H100_SMS = 132


def test_ssm_configs_exist():
    assert {"mamba2-130m", "jamba-1.5-large-398b"} <= set(SSM_ARCHS)


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_every_ssm_config_is_accepted(arch, reduced):
    """Every configured (head_dim, state, chunk), full and reduced, is a
    shape the kernels take; at full width in bfloat16 it runs on the
    tensor cores, the reduced (16, 16) configs on the scalar kernel."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    P, N, Q = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    assert sk.accepts(P, N, Q)
    want = "scalar" if reduced else "tensor_core"
    assert sk.route(torch.bfloat16, P, N) == want
    assert sk.route(torch.float32, P, N) == "scalar"


@pytest.mark.parametrize("P", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("N", [16, 64, 128, 48])
@pytest.mark.parametrize("Q", [1, 64, 256, 257])
def test_accepts_and_routes(P, N, Q):
    ok = P in (16, 64, 128) and N in (16, 64, 128) and Q <= 256
    assert sk.accepts(P, N, Q) == ok
    tc = P in (64, 128) and N in (64, 128)
    assert sk.route(torch.bfloat16, P, N) == ("tensor_core" if tc
                                              else "scalar")
    assert sk.route(torch.float32, P, N) == "scalar"
    assert set(sk.ROUTES) == {"tensor_core", "scalar"}


# (B, nc, Q, H): the serve shape (8 x 512 tokens of mamba2-130m), the long
# one (B = 1, S = 65,536), a short prompt, jamba's 128 heads, and shapes
# too small to fill the card
@pytest.mark.parametrize("B,nc,Q,H", [(8, 2, 256, 24), (1, 256, 256, 24),
                                      (2, 1, 16, 24), (1, 16, 128, 128),
                                      (4, 1, 256, 24), (1, 1, 1, 7),
                                      (2, 2, 128, 8), (1, 3, 65, 4)])
def test_head_group_fills_the_card(B, nc, Q, H):
    """G divides H; the output kernel has a block for every SM whenever
    one head per block can give that; and no larger divisor would."""
    G = sk.head_group(B, nc, Q, H, H100_SMS)
    assert 1 <= G <= H and H % G == 0
    blocks = B * nc * math.ceil(Q / 64) * (H // G)
    assert blocks >= H100_SMS or G == 1
    if G < H:   # the next larger divisor would leave an SM without a block
        bigger = min(d for d in range(G + 1, H + 1) if H % d == 0)
        assert B * nc * math.ceil(Q / 64) * (H // bigger) < H100_SMS
    if (B, nc) in ((8, 2), (1, 256)):
        assert blocks >= H100_SMS


def test_head_group_at_the_timed_shapes():
    assert sk.head_group(8, 2, 256, 24, H100_SMS) == 8
    assert sk.head_group(1, 256, 256, 24, H100_SMS) == 24
    assert sk.head_group(1, 16, 128, 128, H100_SMS) == 16
    assert sk.head_group(2, 1, 16, 24, H100_SMS) == 1


def test_cpu_call_moves_no_route_counter():
    tk.reset_launch_counts()
    zero = {name: dict.fromkeys(sk.ROUTES, 0) for name in tk.ROUTED}
    assert tk.route_counts() == zero
    g = torch.Generator().manual_seed(0)
    for dtype, (P, N) in ((torch.bfloat16, (64, 64)),
                          (torch.float32, (16, 16))):
        x = torch.randn(1, 2, 8, 3, P, generator=g).to(dtype)
        Bm, Cm = (torch.randn(1, 2, 8, N, generator=g).to(dtype)
                  for _ in range(2))
        dt = torch.rand(1, 2, 8, 3, generator=g)
        A = -torch.rand(3, generator=g)
        y, st = ss.ssd_scan(x, Bm, Cm, dt, A)
        assert y.shape == x.shape and st.shape == (1, 3, P, N)
    assert tk.route_counts() == zero
    assert tk.launch_counts()["ssd_scan"] == 0


def test_route_counts_cover_ssd_scan():
    ss.ssd_scan.route_launches["tensor_core"] = 4
    assert tk.route_counts()["ssd_scan"] == {"tensor_core": 4, "scalar": 0}
    tk.reset_launch_counts()
    assert tk.route_counts()["ssd_scan"] == {"tensor_core": 0, "scalar": 0}


# --------------------------------------------------------------------- #
# the device guard (F2): every launcher inside device_stream(operand)
# --------------------------------------------------------------------- #
STREAM = 0x5EED


class _Lib:
    """A stand-in for a loaded kernel library: every symbol records its
    arguments and returns 0 (cudaSuccess)."""

    def __init__(self, calls):
        self._calls = calls

    def __getattr__(self, name):
        def fn(*args):
            self._calls.append((name, args))
            return 0
        return fn


@pytest.fixture
def guarded(monkeypatch):
    seen, calls = [], []

    @contextlib.contextmanager
    def device_stream(t):
        seen.append(t)
        yield STREAM

    monkeypatch.setattr(tk, "device_stream", device_stream)
    monkeypatch.setattr(build, "load", lambda name: _Lib(calls))
    for mod in (rtk, lfk, aek, gdk, fk, dk, sk):
        monkeypatch.setattr(mod, "_FNS", {})
    monkeypatch.setattr(dk, "sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(dk, "tc_blocks_per_sm", lambda dev, hd: 4)
    monkeypatch.setattr(sk, "_SCRATCH", {})
    return types.SimpleNamespace(seen=seen, calls=calls)


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


def _launches():
    """(name, launch thunk, the operand whose device it must guard)."""
    bf16 = torch.bfloat16
    B, N, L = 2, 5, 16
    term = _i32(B, N, L)
    match = _i32(B, N)
    kv = _i32(B, N, 8)
    rows = [_i32(B, N) for _ in range(10)]
    site_rtt = _i32(B, 2, 2)
    gids = _i32(B)
    q64 = torch.zeros(1, 8, 3, 64, dtype=bf16)
    q16 = torch.zeros(1, 8, 3, 16)
    kv64 = torch.zeros(1, 8, 1, 64, dtype=bf16)
    kv16 = torch.zeros(1, 8, 1, 16)
    d64, d16 = q64[:, :1].contiguous(), q16[:, :1].contiguous()
    clen = torch.tensor([8], dtype=torch.int32)

    def ssd(dtype, P, N_):
        x = torch.zeros(1, 2, 8, 3, P, dtype=dtype)
        ops = (x, torch.zeros(1, 2, 8, N_, dtype=dtype),
               torch.zeros(1, 2, 8, N_, dtype=dtype),
               torch.zeros(1, 2, 8, 3), torch.zeros(3),
               torch.zeros(1, 2, 8, 3, P), torch.zeros(1, 3, P, N_))
        return (lambda: sk.ssd_scan(*ops)), x

    ssd_tc, x_tc = ssd(bf16, 64, 128)
    ssd_sc, x_sc = ssd(torch.float32, 16, 16)
    return [
        ("log_match_append", lambda: rtk.log_match_append(
            term, term, term, _i32(B, L), _i32(B, L), _i32(B, L),
            match, match, match, match, match, match, w=4), term),
        ("commit_majority", lambda: rtk.commit_majority(
            match, match, _i32(B, L), gids, gids, gids), match),
        ("apply_last_wins", lambda: rtk.apply_last_wins(
            kv, _i32(B, N, 3), _i32(B, N, 3), _i32(B, N, 3)), kv),
        ("leader_fanout", lambda: lfk.leader_fanout(
            rows, _i32(B, N, N), [gids] * 6, [_i32(B, N)] * 5 + [gids],
            msg_budget=4, max_ship=2, entries_per_msg=8), rows[0]),
        ("ae_sync", lambda: aek.ae_sync(
            [_i32(B, 7)] * 8, [_i32(B, N)] * 6, site_rtt, gids, gids,
            [_i32(B, 7)] * 4), site_rtt),
        ("group_reduce", lambda: gdk.group_reduce(
            gids, _i32(B, 3), torch.zeros(B, 2), _i32(1, 3),
            torch.zeros(1, 2), torch.zeros(1, 2)), gids),
        ("flash_attention tensor_core", lambda: fk.flash_attention(
            q64, kv64, kv64, torch.empty_like(q64), True), q64),
        ("flash_attention scalar", lambda: fk.flash_attention(
            q16, kv16, kv16, torch.empty_like(q16), True), q16),
        ("decode_attention tensor_core", lambda: dk.decode_attention(
            d64, kv64, kv64, clen, torch.empty_like(d64)), d64),
        ("decode_attention scalar", lambda: dk.decode_attention(
            d16, kv16, kv16, clen, torch.empty_like(d16)), d16),
        ("ssd_scan tensor_core", ssd_tc, x_tc),
        ("ssd_scan scalar", ssd_sc, x_sc),
    ]


LAUNCHERS = [name for name, _, _ in _launches()]


@pytest.mark.parametrize("name", LAUNCHERS)
def test_every_launcher_guards_its_operand_device(guarded, name):
    """One guard per launch, entered with the launcher's own operand (so
    the launch lands on that tensor's device), and the ctypes call gets
    the stream the guard yielded."""
    thunk, operand = {n: (f, t) for n, f, t in _launches()}[name]
    thunk()
    assert len(guarded.seen) == 1 and guarded.seen[0] is operand
    assert len(guarded.calls) == 1
    sym, args = guarded.calls[0]
    assert args[-1] == STREAM, sym


def test_launch_routes_name_their_entry_points(guarded):
    """The route a launcher returns is the entry point it called."""
    want = {"flash_attention tensor_core": "flash_attention_tc",
            "flash_attention scalar": "flash_attention",
            "decode_attention tensor_core": "decode_attention_tc",
            "decode_attention scalar": "decode_attention",
            "ssd_scan tensor_core": "ssd_scan_tc",
            "ssd_scan scalar": "ssd_scan"}
    for name, thunk, _ in _launches():
        if name not in want:
            continue
        guarded.calls.clear()
        r = thunk()
        assert r == name.split()[1]
        assert guarded.calls[-1][0] == want[name]


def test_device_stream_enters_the_operand_device(monkeypatch):
    """The real helper: `torch.cuda.device` is entered with the tensor's
    own device and the stream is that device's (both patched: no card)."""
    entered, streams = [], []

    @contextlib.contextmanager
    def fake_device(d):
        entered.append(d)
        yield

    def fake_stream(d):
        streams.append(d)
        return types.SimpleNamespace(cuda_stream=77)

    monkeypatch.setattr(torch.cuda, "device", fake_device)
    monkeypatch.setattr(torch.cuda, "current_stream", fake_stream)
    t = torch.zeros(2)
    with tk.device_stream(t) as s:
        assert s == 77
    assert entered == [t.device] and streams == [t.device]
