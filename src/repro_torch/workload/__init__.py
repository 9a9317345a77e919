"""Workload helpers the port needs (copies from `repro.workload`)."""
