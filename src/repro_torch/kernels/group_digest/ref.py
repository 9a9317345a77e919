"""Plain PyTorch twin of the grouped digest-reduction kernel: the
`segment_sum`/`segment_max` contract of `repro.kernels.group_digest.ref`
written as a loop over members in ascending order with masked adds, so
the float32 sums accumulate in the order `segment_sum` and the CUDA
kernel use and all three agree bit for bit (`index_add_` on the card
uses atomics, whose order changes from run to run); the max orders +0
above -0, as XLA's does.
"""
from __future__ import annotations

import torch


def group_reduce_ref(gids, int_mat, flt_mat, *, n_groups: int):
    """gids (B,) int32 — members with an id outside [0, n_groups) are
    dropped; int_mat (B, Fi) int32; flt_mat (B, Ff) float32.  Returns
    (g_int (G, Fi) sums, g_sum (G, Ff) sums, g_max (G, Ff) maxes, -inf
    for an empty group)."""
    B, Fi = int_mat.shape
    Ff = flt_mat.shape[1]
    dev = int_mat.device
    g_int = torch.zeros((n_groups, Fi), dtype=torch.int32, device=dev)
    g_sum = torch.zeros((n_groups, Ff), dtype=torch.float32, device=dev)
    g_max = torch.full((n_groups, Ff), -torch.inf, dtype=torch.float32,
                       device=dev)
    rows = torch.arange(n_groups, device=dev)[:, None]
    for b in range(B):
        hit = rows == gids[b]
        v = flt_mat[b]
        g_int = g_int + torch.where(hit, int_mat[b], 0)
        g_sum = g_sum + torch.where(hit, v, 0.0)
        g_max = torch.where(hit, _max(g_max, v), g_max)
    return g_int.to(torch.int32), g_sum, g_max


def _max(m, v):
    """`segment_max`'s max: NaN if either side is NaN, and +0 over -0
    where the two compare equal (`torch.maximum` alone may keep -0)."""
    tie = (m.view(torch.int32) & v.view(torch.int32)).view(torch.float32)
    return torch.where(m == v, tie, torch.maximum(m, v))
