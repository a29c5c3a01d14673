"""Vector ops, SpMV dispatch and the CUDA kernel wrappers (ops/cuda)."""
