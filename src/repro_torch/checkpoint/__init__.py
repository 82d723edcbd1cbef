"""Atomic, asynchronous checkpoints of trees of tensors."""
