"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``) and
the plain PyTorch version beside each."""
