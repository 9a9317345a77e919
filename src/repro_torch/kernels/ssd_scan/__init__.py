"""ssd_scan kernel family: CUDA kernel, plain twin and op."""
