"""Force and step operations: the plain PyTorch versions and the CUDA kernels."""
