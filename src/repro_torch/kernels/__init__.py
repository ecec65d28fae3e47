"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version beside it.  Nothing here builds or loads a kernel at import."""
