"""Checkpointing of the port: the JAX package's on-disk layout."""
