"""Kernels written by hand for Hopper (``csrc/``), their build, and their
Python wrappers with the plain PyTorch version beside each."""
