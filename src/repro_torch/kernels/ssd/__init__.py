"""Mamba2 SSD chunk scan: the CUDA kernel and its plain version."""
