"""The consensus core of the port: state, the tick, the epoch runtime and
the host control plane."""
