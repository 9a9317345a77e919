"""Data of the port: the seeded training token stream and the serving
workload generators (numpy makes every number)."""
