"""Cluster configurations the port runs (copies of `repro.configs`)."""
