"""Compute kernels and math primitives (JAX/XLA, plus a CUDA kernel
through the XLA FFI)."""
