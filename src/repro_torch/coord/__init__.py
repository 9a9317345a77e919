"""Coordination of the port's model stack: the elastic observer pool of
serving replicas."""
