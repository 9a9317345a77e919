"""decode_attention kernel family: CUDA kernel, plain twin and op."""
