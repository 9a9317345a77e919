"""ae_sync kernel family: CUDA kernel, plain twin and op."""
