"""Ops: convolutions, pooling, and the two CUDA kernels (scan, log-mel)."""
