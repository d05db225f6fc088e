"""Block-sparse dropout matmul: the CUDA kernel and its plain version."""
