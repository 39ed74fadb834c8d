"""Kernel wrappers: each launches a CUDA kernel built from ``csrc/`` for CUDA
tensors and runs its plain PyTorch version for CPU tensors."""
