"""Hand-written CUDA kernels, their plain PyTorch versions, the build."""
