"""Optimizers: AdamW and Adafactor over trees of tensors."""
