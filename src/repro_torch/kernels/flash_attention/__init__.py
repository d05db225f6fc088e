"""Flash attention: CUDA forward/backward kernels and their plain version."""
