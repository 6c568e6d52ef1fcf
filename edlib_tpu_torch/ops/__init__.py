"""Kernels of the port (CUDA C++ in csrc/) and the modules around them."""
