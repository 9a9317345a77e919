"""BW-Raft cluster state as a dict of tensors, leading axis = node
(PyTorch port of `repro.core.state`).

Node layout: ids [0, V) are the on-demand voters, [V, V+MS) the
secretary slots, [V+MS, N) the observer slots; spot slots are DEAD until
the resource manager leases an instance into them.  Every leaf keeps the
JAX package's name, dtype and shape, with one exception of type only: the
uint32 applied-prefix digests (DESIGN.md §13) are carried as int32 bit
patterns, since int32 wraparound multiply-XOR gives the same bits.

`build_static` returns numpy tables (the host control plane reads them);
`from_numpy` moves any such tree — static, `cfg_c` or state — onto a
device, and `to_numpy` brings a tree back in the JAX package's dtypes.

The tick runs on trees with a leading member axis B (the JAX fleet's
`vmap` axis written out; one cluster is B = 1): `stack` and `member`
turn member trees into a batched tree and back, `batch1` views one
cluster's tree as B = 1, and `stack_static` splits the members' statics
the way the JAX fleet does (DESIGN.md §7) — shared python ints, and
(B, ...) tensors for the per-member tables.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.cluster_config import ClusterConfig
from repro_torch.trace import ring as trace_ring

# roles
FOLLOWER, CANDIDATE, LEADER, SECRETARY, OBSERVER, DEAD = range(6)

# extra unit bins past T in the latency histograms (DESIGN.md §7.1/§11)
HIST_TAIL = 64

# leaves the JAX package holds as uint32; the port holds their bits
UINT32_LEAVES = frozenset({"applied_digest", "dobs_digest"})


def _i32(c: int) -> int:
    """A uint32 constant as the int32 with the same bits."""
    return c - (1 << 32) if c >= (1 << 31) else c


# position-keyed entry-mix constants of the rolling applied-prefix digest
_MIX_POS = _i32(0x9E3779B1)
_MIX_KEY = _i32(0x85EBCA77)
_MIX_VAL = _i32(0xC2B2AE3D)


def entry_mix(pos, key, val) -> torch.Tensor:
    """The uint32 mix of one log entry (DESIGN.md §13) as int32 bits:
    `(pos+1)*P ^ (key+1)*K ^ (val+1)*V` with int32 wraparound."""
    i = lambda x: x.to(torch.int32)
    return (((i(pos) + 1) * _MIX_POS) ^ ((i(key) + 1) * _MIX_KEY)
            ^ ((i(val) + 1) * _MIX_VAL))


def prefix_digest(keys, vals, upto) -> torch.Tensor:
    """Digest of the applied prefix `[0, upto)` of a log row (the last
    axis of `keys` and `vals`), as int32 bits: the recompute-from-scratch
    form of the rolling `applied_digest` that `step.apply_step` keeps
    (DESIGN.md §13), the XOR of every entry's `entry_mix` below `upto`
    (`upto` a scalar, or one per row)."""
    keys, vals = torch.as_tensor(keys), torch.as_tensor(vals)
    pos = torch.arange(keys.shape[-1], device=keys.device)
    upto = torch.as_tensor(upto, device=keys.device)
    x = torch.where(pos < upto[..., None], entry_mix(pos, keys, vals), 0)
    while x.shape[-1] > 1:                  # XOR-fold halves
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], -1)
        x = x[..., 0::2] ^ x[..., 1::2]
    return x[..., 0] if x.shape[-1] else x.sum(-1)


def pytree_nbytes(tree) -> int:
    """Payload bytes of a tree (dicts, lists, tuples) of tensors, numpy
    arrays and Python scalars, from shapes and dtypes only (nothing moves
    from the device): the epoch-digest transfer accounting of DESIGN.md
    §7.1 (`FleetSim.d2h_bytes`).  A Python bool counts 1 byte, an int or
    float 4, as JAX's weakly typed scalars; None is no leaf."""
    if isinstance(tree, dict):
        return sum(pytree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(pytree_nbytes(v) for v in tree)
    if tree is None:
        return 0
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (np.ndarray, np.generic)):
        return int(tree.nbytes)
    return 1 if isinstance(tree, bool) else 4


def hist_bins(cfg: ClusterConfig) -> int:
    """Latency-histogram width: unit bins covering [0, T + HIST_TAIL]."""
    return cfg.period_ticks + 1 + HIST_TAIL


def build_static(cfg: ClusterConfig, *, pad_nodes: int = 0,
                 pad_sites: int = 0, n_obs_digest: int = 0,
                 pad_obs: int = 0,
                 trace_capacity: int = trace_ring.DEFAULT_CAPACITY
                 ) -> Dict:
    """Static per-node tables (site, voter mask, rtt matrix, capacities)
    as numpy arrays and python ints, equal leaf for leaf to
    `repro.core.state.build_static`."""
    V = cfg.num_voters
    MS, MO = cfg.max_secretaries, cfg.max_observers
    R = V + MS + MO
    N = R + pad_nodes
    site = np.zeros((N,), np.int32)
    i = 0
    for s_idx, s in enumerate(cfg.sites):
        for _ in range(s.followers):
            site[i] = s_idx
            i += 1
    for j in range(V, N):
        site[j] = (j - V) % cfg.num_sites
    is_voter = np.zeros((N,), bool)
    is_voter[:V] = True
    is_secretary_slot = np.zeros((N,), bool)
    is_secretary_slot[V:V + MS] = True
    is_observer_slot = np.zeros((N,), bool)
    is_observer_slot[V + MS:R] = True

    intra = np.asarray([s.rtt_intra for s in cfg.sites], np.int32)
    inter = np.asarray([s.rtt_inter for s in cfg.sites], np.int32)

    def pair_rtt(sa: np.ndarray, sb: np.ndarray) -> np.ndarray:
        a, b = sa[:, None], sb[None, :]
        return np.where(a == b, intra[a],
                        (inter[a] + inter[b]) // 2).astype(np.int32)

    rtt = pair_rtt(site, site)
    S = cfg.num_sites + pad_sites
    site_of = np.minimum(np.arange(S), cfg.num_sites - 1)
    site_rtt = pair_rtt(site_of, site_of)
    O = n_obs_digest + pad_obs
    dobs_site = (np.arange(O, dtype=np.int32) % cfg.num_sites
                 if O else np.zeros((0,), np.int32))
    return {
        "site": site, "is_voter": is_voter,
        "is_secretary_slot": is_secretary_slot,
        "is_observer_slot": is_observer_slot,
        "rtt": rtt, "site_rtt": site_rtt,
        "dobs_site": dobs_site, "O": O, "O_live": n_obs_digest,
        "trace_cap": int(trace_capacity),
        "N": N, "V": V,
        "S": S,
        "majority": V // 2 + 1,
        "work_capacity": 8,       # reads a node can serve per tick
        "msg_budget": 16,         # fan-out msg-units a node sends per tick
        "entries_per_msg": 32,    # batch payload per msg-unit (bytes model)
        "max_ship": 256,          # entries shipped per append batch
        "max_apply": 8,           # state-machine applies per tick
    }


def site_price_init(cfg: ClusterConfig, S: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Initial per-site spot price and bid (1.5x the mean), (S,) float32
    each; padded sites repeat the last real site."""
    site_of = [min(s, cfg.num_sites - 1) for s in range(S)]
    price0 = np.asarray(
        [cfg.sites[site_of[s]].spot_price_mean for s in range(S)],
        np.float32)
    bid = np.asarray(
        [cfg.sites[site_of[s]].spot_price_mean * 1.5 for s in range(S)],
        np.float32)
    return price0, bid


def init_state(cfg: ClusterConfig, static, device, *, pad_log: int = 0,
               pad_keys: int = 0) -> Dict[str, torch.Tensor]:
    """Initial cluster state on `device`; `pad_log`/`pad_keys` widen the
    log window and key space (dead tail capacity)."""
    N = static["N"]
    L, K = cfg.max_log + pad_log, cfg.key_space + pad_keys
    S = static.get("S", cfg.num_sites)
    price0, bid0 = site_price_init(cfg, S)
    i32 = dict(dtype=torch.int32, device=device)
    z = lambda *sh: torch.zeros(sh, **i32)
    neg = lambda *sh: torch.full(sh, -1, **i32)
    is_voter = torch.as_tensor(static["is_voter"], device=device)
    span = cfg.election_timeout_max - cfg.election_timeout_min + 1
    st = {
        "tick": z(),
        "role": torch.where(is_voter, FOLLOWER, DEAD).to(torch.int32),
        "alive": is_voter.clone(),
        "term": z(N),
        "voted_for": neg(N),
        "votes_received": z(N),
        "log_term": z(N, L),
        "log_key": z(N, L),
        "log_val": z(N, L),
        "log_len": z(N),
        "commit_len": z(N),
        "applied_len": z(N),
        "kv": z(N, K),
        # staggered initial timers: avoids simultaneous-candidate storms
        "election_timer": cfg.election_timeout_min +
        (torch.arange(N, **i32) * 7) % span,
        "heartbeat_timer": z(N),
        "match_len": z(N),
        "app_arrive_t": neg(N),
        "app_from_len": z(N),
        "app_upto": z(N),
        "app_term": z(N),
        "app_commit": z(N),
        "ack_arrive_t": neg(N),
        "ack_upto": z(N),
        "vreq_t": neg(N),
        "vreq_from": neg(N),
        "vreq_term": z(N),
        "vreq_lastterm": z(N),
        "vreq_lastlen": z(N),
        "grant_t": neg(N),
        "grant_to": neg(N),
        "grant_term": z(N),
        "sec_of": neg(N),
        "obs_of": neg(N),
        "read_queue": z(N),
        "write_pending": z(),
        "leader_work": z(N),
        "entry_submit_t": neg(L),
        "entry_commit_t": neg(L),
        "spot_price": torch.as_tensor(price0, device=device),
        "spot_bid": torch.as_tensor(bid0, device=device),
        "warn_timer": neg(N),
        "reads_arrived": z(),
        "writes_arrived": z(),
        "cross_arrived": z(),
        "reads_served": z(),
        "writes_committed": z(),
        "read_lat_sum": torch.zeros((), dtype=torch.float32, device=device),
        "read_lat_max": torch.zeros((), dtype=torch.float32, device=device),
        "read_lat_hist": z(hist_bins(cfg)),
        "cost_accrued": torch.zeros((), dtype=torch.float32, device=device),
        "applied_digest": z(N),
    }
    st.update(_digest_tier_init(cfg, static, device))
    st.update(trace_ring.trace_leaves(
        static.get("trace_cap", trace_ring.DEFAULT_CAPACITY), device))
    return st


def _digest_tier_init(cfg: ClusterConfig, static, device
                      ) -> Dict[str, torch.Tensor]:
    """Digest-tier observer leaves, leading axis O (DESIGN.md §13); all
    exist, at length 0, when the tier is off."""
    O = int(static.get("O", 0))
    O_live = int(static.get("O_live", 0))
    V = static["V"]
    dobs_site = np.asarray(static.get("dobs_site", np.zeros((0,), np.int32)))
    site = np.asarray(static["site"])
    dobs_fol = np.full((O,), -1, np.int32)
    taken: Dict[int, int] = {}
    for o in range(O_live):
        d = int(dobs_site[o])
        voters = [v for v in range(V) if site[v] == d]
        if voters:
            k = taken.get(d, 0)
            dobs_fol[o] = voters[k % len(voters)]
            taken[d] = k + 1
        else:
            dobs_fol[o] = o % V
    enabled = torch.as_tensor(np.arange(O) < O_live, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    z = lambda *sh: torch.zeros(sh, **i32)
    return {
        "dobs_enabled": enabled,
        "dobs_alive": enabled.clone(),
        "dobs_fol": torch.as_tensor(dobs_fol, device=device),
        "dobs_applied": z(O),
        "dobs_term": z(O),
        "dobs_digest": z(O),
        "dobs_synced_t": z(O),
        "dobs_warn": torch.full((O,), -1, **i32),
        "dobs_read_queue": z(O),
        "obs_reads_served": z(),
        "obs_rerouted": z(),
        "obs_stale_hist": z(hist_bins(cfg)),
    }


def leader_id(state, static=None) -> torch.Tensor:
    """Current leader id or -1 (max over the alive-leader mask; at most
    one by safety): a (B,) int32 tensor for a batched state, 0-d for one
    cluster's unbatched state."""
    role = state["role"]
    is_leader = (role == LEADER) & state["alive"]
    ids = torch.arange(role.shape[-1], dtype=torch.int32,
                       device=role.device)
    return torch.where(is_leader, ids, -1).max(dim=-1).values


# static scalars every member of a fleet must agree on, and the
# per-member static tables that stack along the member axis — the split
# of the JAX fleet (`repro.core.fleet`, DESIGN.md §7, §13)
SHARED_STATIC_KEYS = ("work_capacity", "msg_budget", "entries_per_msg",
                      "max_ship", "max_apply")
BATCHED_STATIC_KEYS = ("site", "is_voter", "rtt", "majority", "site_rtt",
                       "dobs_site")


def stack_static(statics, device) -> Dict:
    """The tick's static tree for members whose `build_static` tables
    are `statics` (numpy, equal padded shapes): the shared python ints,
    checked equal across members, and the per-member tables stacked to
    (B, ...) tensors on `device` (`majority` as a (B,) int32 vector)."""
    statics = list(statics)
    out = {}
    for k in SHARED_STATIC_KEYS:
        vals = {int(st[k]) for st in statics}
        if len(vals) != 1:
            raise ValueError(f"members disagree on static {k}: {vals}")
        out[k] = vals.pop()
    for k in BATCHED_STATIC_KEYS:
        arr = np.stack([np.asarray(st[k]) for st in statics])
        if k == "majority":
            arr = arr.astype(np.int32)
        out[k] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return out


def stack(trees) -> Dict:
    """Member trees (state, `cfg_c` or draw bundles) stacked along a new
    leading member axis; python scalars must agree and pass through."""
    trees = list(trees)
    out = {}
    for k, v in trees[0].items():
        if isinstance(v, torch.Tensor):
            out[k] = torch.stack([t[k] for t in trees])
        else:
            out[k] = v
    return out


def member(tree: Dict, i: int) -> Dict:
    """Member `i` of a batched tree, as views."""
    return {k: (v[i] if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items()}


def batch1(tree: Dict) -> Dict:
    """One cluster's tree as a batched tree with B = 1, as views."""
    return {k: (v.unsqueeze(0) if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items()}


def from_numpy(tree: Dict, device) -> Dict:
    """A tree of numpy arrays (a JAX state, static or cfg_c taken with
    `np.asarray`) as tensors on `device`: dtypes kept, uint32 as int32
    bits; python scalars pass through unchanged."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, (np.ndarray, np.generic)):
            a = np.array(v)                 # a writable C-order copy
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            out[k] = torch.from_numpy(a).to(device)
        else:
            out[k] = v
    return out


def to_numpy(tree: Dict) -> Dict:
    """The inverse of `from_numpy`: tensors to numpy in the JAX
    package's dtypes (the digest leaves back to uint32)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            a = v.detach().cpu().numpy()
            out[k] = a.view(np.uint32) if k in UINT32_LEAVES else a
        else:
            out[k] = v
    return out
