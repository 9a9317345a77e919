"""Entry points of the port's model stack: the train, prefill and decode
steps (`steps`), the serving entry point (`serve`) and the
consensus-coordinated trainer (`train`)."""
