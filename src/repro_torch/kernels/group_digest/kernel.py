"""ctypes launcher for the grouped digest-reduction CUDA kernel
(`csrc/group_digest.cu`), which replaces the Pallas kernel
`repro.kernels.group_digest.kernel.group_reduce_kernel`.

One thread per (group, packed feature) loads its column of a chunk of
8 members, ids included, in one round trip (the next chunk's loads
issued before the current one is added) and adds them in ascending
member order; the float cells start on a warp of their own.  It writes
every output cell, so the outputs come unfilled.  A few KB per launch
at the slice's fleet, so the launch bounds it.  The design notes are in
the CUDA source.
"""
from __future__ import annotations

from repro_torch import kernels as tk
from repro_torch.kernels import build

_FNS = {}


def _fn():
    if "f" not in _FNS:
        _FNS["f"] = build.bind(build.load("group_digest"), "group_reduce",
                               6, 4)
    return _FNS["f"]


def group_reduce(gids, int_mat, flt_mat, g_int, g_sum, g_max) -> None:
    """gids (B,) int32; int_mat (B, Fi) int32; flt_mat (B, Ff) float32;
    outputs g_int (G, Fi) int32, g_sum and g_max (G, Ff) float32, which
    the kernel overwrites whole (they may hold anything)."""
    B, Fi = int_mat.shape
    Ff = flt_mat.shape[1]
    G = g_int.shape[0]
    ptrs = [t.data_ptr() for t in (gids, int_mat, flt_mat, g_int, g_sum,
                                   g_max)]
    with tk.device_stream(gids) as stream:
        rc = _fn()(*ptrs, B, G, Fi, Ff, stream)
    if rc != 0:
        raise RuntimeError(f"group_reduce: CUDA launch failed with "
                           f"error {rc}")
