"""Adaptive average pooling as a matmul (mirrors velocity_asr_tpu/ops/pooling.py).

Output bin i averages input indices [floor(i*L/K), ceil((i+1)*L/K)),
torch's ``adaptive_avg_pool1d`` bucket rule.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def pool_size_level1(seq_len: int) -> int:
    """K1 = max(64, L // 8), clamped to L."""
    return min(max(64, seq_len // 8), seq_len)


def pool_size_level2(k1: int) -> int:
    """K2 = min(64, max(16, K1 // 4)), clamped to K1."""
    return min(min(64, max(16, k1 // 4)), k1)


@functools.lru_cache(maxsize=64)
def adaptive_pool_matrix(seq_len: int, pool_size: int) -> np.ndarray:
    """(pool_size, seq_len) averaging matrix, read-only."""
    mat = np.zeros((pool_size, seq_len), dtype=np.float32)
    for i in range(pool_size):
        start = (i * seq_len) // pool_size
        end = -(-((i + 1) * seq_len) // pool_size)  # ceil
        mat[i, start:end] = 1.0 / (end - start)
    mat.setflags(write=False)
    return mat


@functools.lru_cache(maxsize=64)
def _device_pool_matrix(seq_len: int, pool_size: int, device: torch.device,
                        dtype: torch.dtype) -> torch.Tensor:
    """The averaging matrix on `device` in `dtype`, copied there once (a
    normal tensor even when first asked for under inference mode)."""
    with torch.inference_mode(False):
        mat = torch.from_numpy(adaptive_pool_matrix(seq_len, pool_size).copy())
        return mat.to(device=device, dtype=dtype)


def adaptive_avg_pool1d(x: torch.Tensor, pool_size: int) -> torch.Tensor:
    """(batch, L, d) -> (batch, pool_size, d); the matrix is cast to x's dtype."""
    seq_len = x.shape[1]
    if pool_size == seq_len:
        return x
    return torch.matmul(_device_pool_matrix(seq_len, pool_size, x.device, x.dtype), x)
