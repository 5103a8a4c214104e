"""Convolutions (mirrors velocity_asr_tpu/ops/conv.py).

Both are library convolutions (``F.conv1d``), as the JAX package leaves
them to XLA. Inputs and outputs are (batch, L, channels); weights are in
torch's (out, in/groups, k) layout, and the bias is added after the
convolution in the input's dtype, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def causal_depthwise_conv1d(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise conv over time, left-padded by k-1 (x (B, L, d), weight (d, 1, k))."""
    k = weight.shape[-1]
    h = F.pad(x.transpose(1, 2), (k - 1, 0))
    out = F.conv1d(h, weight.to(x.dtype), groups=weight.shape[0]).transpose(1, 2)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def strided_conv1d(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor | None = None, stride: int = 2,
                   padding: int = 1) -> torch.Tensor:
    """Strided conv (x (B, L, in), weight (out, in, k)); k=3/s=2/p=1 gives
    (L + 1) // 2 frames."""
    out = F.conv1d(x.transpose(1, 2), weight.to(x.dtype), stride=stride,
                   padding=padding).transpose(1, 2)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
