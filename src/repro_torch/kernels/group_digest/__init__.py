"""group_digest kernel family: CUDA kernel, plain twin and op."""
