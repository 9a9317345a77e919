"""Spot-market pieces the port runs (DESIGN.md §10): the process walk."""
