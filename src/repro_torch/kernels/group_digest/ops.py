"""Public op of the grouped digest reduction (DESIGN.md §8, §9): what
`core/fleet.py:_group_digest` calls once per fleet epoch.

The signature of `repro.kernels.group_digest.ops.group_reduce`: the
digest leaves packed into one (B, Fi) int32 matrix and one (B, Ff)
float32 matrix, reduced over the members of each group.  A CPU tensor
runs the twin in `ref.py`; a CUDA tensor launches the kernel in
`csrc/group_digest.cu` after the operands are checked, else the op
raises.  Every launch adds one to `group_reduce.launches`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import check, on_cpu
from repro_torch.kernels.group_digest import kernel as K
from repro_torch.kernels.group_digest import ref


def group_reduce(gids, int_mat, flt_mat, *, n_groups: int):
    """gids (B,) int32 — ungrouped members carry `n_groups` and drop;
    int_mat (B, Fi) int32; flt_mat (B, Ff) float32.  Returns (g_int
    (G, Fi) sums, g_sum (G, Ff) sums, g_max (G, Ff) maxes), equal bit
    for bit to the segment-op twins, float order included."""
    if on_cpu(int_mat, "group_reduce"):
        return ref.group_reduce_ref(gids, int_mat, flt_mat,
                                    n_groups=n_groups)
    B, Fi = int_mat.shape
    Ff = flt_mat.shape[1]
    dev = int_mat.device
    check("group_reduce", "gids", gids, torch.int32, (B,), dev)
    check("group_reduce", "int_mat", int_mat, torch.int32, (B, Fi), dev)
    check("group_reduce", "flt_mat", flt_mat, torch.float32, (B, Ff), dev)
    G = int(n_groups)
    # the kernel writes every cell (0 sums and a -inf max for an empty
    # group); with no group or no lane the outputs have no element
    g_int = torch.empty((G, Fi), dtype=torch.int32, device=dev)
    g_sum = torch.empty((G, Ff), dtype=torch.float32, device=dev)
    g_max = torch.empty((G, Ff), dtype=torch.float32, device=dev)
    if G and Fi + Ff:
        K.group_reduce(gids, int_mat, flt_mat, g_int, g_sum, g_max)
        group_reduce.launches += 1
    return g_int, g_sum, g_max


group_reduce.launches = 0
