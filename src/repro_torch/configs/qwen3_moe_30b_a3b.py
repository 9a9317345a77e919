"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128e top-8 [hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=64,
    d_ff=0, vocab_size=151936, qk_norm=True, rope_theta=1_000_000.0,
    moe_num_experts=128, moe_top_k=8, moe_d_ff=768,
)
