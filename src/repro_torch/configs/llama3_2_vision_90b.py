"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256, cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

Vision frontend is a STUB per the assignment: input_specs() supplies
precomputed patch embeddings (B, 1600, d_model).  Cross-attention layers sit
at every 5th position (20 of 100).  Optimizer state is bf16 (90B params x
fp32 m/v would not fit 16 GB/chip at 256 chips — DESIGN.md §3).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256, rope_theta=500_000.0,
    cross_attn_period=5, cross_attn_offset=4, num_image_tokens=1600,
    run_overrides=(("opt_state_dtype", "bfloat16"),),
)
