"""Configurations the port runs (copies of `repro.configs`): the BW-Raft
cluster (`bwraft_kv`) and the architecture registry, --arch <id> ->
ModelConfig."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ModelConfig, RunConfig, ShapeConfig,
                                      SHAPES, SHAPES_BY_NAME,
                                      shape_applicable)

_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
    "qwen2.5-3b": "qwen2_5_3b",
    "smollm-360m": "smollm_360m",
    "qwen3-8b": "qwen3_8b",
    "llama-3.2-vision-90b": "llama3_2_vision_90b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "mamba2-130m": "mamba2_130m",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_run_config(cfg: ModelConfig, **overrides) -> RunConfig:
    kw = dict(cfg.run_overrides)
    kw.update(overrides)
    return RunConfig(**kw)
