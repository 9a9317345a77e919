"""The optimizer of the port's training path: AdamW with global-norm
clipping (`optim.adamw`)."""
