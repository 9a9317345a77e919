"""smollm-360m [dense] — 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152, llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf].

15 Q-heads / 5 KV-heads do not divide the 16-way "model" axis: attention
projections auto-replicate (see DESIGN.md §4); d_ff=2560 and d_model=960
still shard 16-way.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5, head_dim=64,
    d_ff=2560, vocab_size=49152, tie_embeddings=True, rope_theta=10_000.0,
    # pure data parallelism: 15 heads can't shard the 16-way "model" axis,
    # so spread the batch over BOTH axes instead — measured 18.9x step-bound
    # improvement on train_4k (EXPERIMENTS.md §Perf cell 4)
    sharding_overrides=(("batch", ("pod", "data", "model")),),
    run_overrides=(("num_microbatches", 1),),
)
