"""Workload generators of the port (numpy only)."""
