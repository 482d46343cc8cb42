"""Compute plane of the port: GF(2^8) math, the Hopper kernels and the
Reed-Solomon codec seam."""
