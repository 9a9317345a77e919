"""raft_tick kernel family: CUDA kernel, plain twin and op."""
