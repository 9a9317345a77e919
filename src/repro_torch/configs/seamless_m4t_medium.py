"""seamless-m4t-medium [audio] — 12L d_model=1024 16H (kv=16) d_ff=4096
vocab=256206, enc-dec multimodal [arXiv:2308.11596; hf].

Encoder-decoder: 12 encoder + 12 decoder layers.  The audio frontend is a
STUB: input_specs() supplies precomputed frame embeddings (B, S, d_model).
vocab 256206 pads to 256256 for 16-way sharding (loss masks the pad).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio_encdec",
    num_layers=12, encoder_layers=12, d_model=1024, num_heads=16,
    num_kv_heads=16, head_dim=64, d_ff=4096, vocab_size=256206,
    rope_theta=10_000.0,
    cross_attn_period=1, cross_attn_offset=0,   # every decoder layer
)
