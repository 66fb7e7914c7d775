"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``), each
with its plain PyTorch version beside it."""
