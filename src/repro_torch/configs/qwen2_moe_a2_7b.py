"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (kv=16) d_ff=1408
vocab=151936, MoE 60 routed top-4 + 4 shared [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

Every layer is MoE (d_ff=0 dense path unused); the 4 shared experts are a
dense SwiGLU of width 4x1408=5632.  60 experts pad to 64 for 16-way EP.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=0, vocab_size=151936, rope_theta=1_000_000.0,
    moe_num_experts=60, moe_top_k=4, moe_d_ff=1408, moe_shared_d_ff=5632,
)
