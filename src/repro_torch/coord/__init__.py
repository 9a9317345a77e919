"""Coordination of the port's model stack over the BW-Raft log: the
training coordinator (checkpoint commits, membership, scale records),
its record schema, straggler mitigation, and the elastic observer pool
of serving replicas."""
