"""Operators of the port: evaluation, rank-space selection, the fused
deme breed and its CUDA kernel bindings."""
