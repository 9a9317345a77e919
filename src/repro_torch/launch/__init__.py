"""Entry points of the port's model stack: the prefill and decode steps
(`steps`) and the serving entry point (`serve`)."""
