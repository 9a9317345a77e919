"""BW-KV: the key-value client over the port's consensus core."""
