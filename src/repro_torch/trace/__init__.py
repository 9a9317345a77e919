"""Flight recorder (DESIGN.md §14), PyTorch port: the in-tick event ring,
the always-on metrics registry, and the host-side drain."""
