"""BW-Raft on PyTorch and CUDA: the port of the `repro` consensus data
plane to an NVIDIA H100.

The package mirrors `src/repro/`'s layout (`core/`, `trace/`, `kernels/`,
`kvstore/`, ...) so each module has an obvious counterpart, and imports
`torch` and numpy only — never `jax` and nothing of the `repro` package.
Entry points (`core.runtime.BWRaftSim`, `kvstore.service.BWKVService`)
run on the card unless the caller passes `device="cpu"`; a CPU tensor
goes through each kernel's plain PyTorch twin, a CUDA tensor through the
hand-written CUDA kernel (`kernels/csrc/`).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The entry points' device rule: `None` means the card, and raises
    when there is none — there is no silent CPU fallback; pass
    `device="cpu"` to run the plain twins on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
