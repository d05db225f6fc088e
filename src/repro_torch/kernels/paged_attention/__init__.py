"""Paged attention: the CUDA kernel, its plain version and the pool append."""
