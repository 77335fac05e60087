"""Device decode: the CUDA kernels (csrc/) and their plain PyTorch versions."""
