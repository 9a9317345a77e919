"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2, Mamba:attn 1:7 [arXiv:2403.19887; hf].

Period-8 block: position 4 is attention, the rest SSD; MoE MLP on odd
positions (every other layer), dense d_ff=24576 otherwise.  Jamba-1.5 uses
Mamba-1 internals; we adapt to SSD (TPU-native, DESIGN.md §3) with
d_inner=16384, ssd head_dim=128 -> 128 heads (16-divisible), state=64.
Optimizer state is bf16 (398B params, DESIGN.md §3).  Supports long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536, rope_theta=1_000_000.0,
    moe_num_experts=16, moe_top_k=2, moe_d_ff=24576,
    moe_layer_period=2, moe_layer_offset=1,
    attn_layer_period=8, attn_layer_offset=4,
    ssm_state=64, ssm_head_dim=128, ssm_chunk=128,
    sub_quadratic=True,
    run_overrides=(("opt_state_dtype", "bfloat16"),),
)
