"""Checkpoints in the JAX package's on-disk layout (`ckpt.py`)."""
