"""mamba2-130m [ssm] — 24L d_model=768 (attn-free) vocab=50280,
ssm_state=128, SSD (state-space duality) [arXiv:2405.21060; unverified].

Attention-free: every layer is an SSD mixer with no MLP (d_ff=0), matching
the Mamba2 architecture.  d_inner=1536, headdim=64 -> 24 SSD heads (not
16-divisible; SSD tensors replicate on "model" — the arch is DP-dominant,
see DESIGN.md §4).  Supports long_500k (O(1) decode state).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=12, num_kv_heads=12, head_dim=64,
    d_ff=0, vocab_size=50280, ssm_state=128, ssm_head_dim=64,
    sub_quadratic=True,
    sharding_overrides=(("batch", ("pod", "data", "model")),),
)
