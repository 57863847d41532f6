"""Hopper kernels of the port, their plain PyTorch twins, and packing."""
