"""leader_fanout kernel family: CUDA kernel, plain twin and op."""
