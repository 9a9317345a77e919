"""Checkpoints of the port's training path: the sharded store with an
asynchronous save, whose steps become valid through the coordinator's
CKPT_COMMIT record (`checkpoint.store`)."""
