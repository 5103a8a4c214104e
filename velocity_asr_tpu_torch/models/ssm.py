"""Selective-SSM components (mirrors velocity_asr_tpu/models/ssm.py),
offline only.

The recurrence always runs in fp32; the Dense layers run in the compute
dtype.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import causal_depthwise_conv1d
from ..ops.scan import selective_scan
from .layers import Dense, LayerNorm


class SelectiveSSM(nn.Module):
    """in_proj -> (x, z); B, C from x_proj; dt = softplus(dt_proj(x));
    A = -exp(A_log); scan; y * silu(z); out_proj."""

    def __init__(self, d_model: int = 192, state_dim: int = 64, expand_ratio: int = 2,
                 scan_mode: str = "parallel", dtype: torch.dtype = torch.float32):
        super().__init__()
        d_inner = d_model * expand_ratio
        self.state_dim = state_dim
        self.scan_mode = scan_mode
        self.dtype = dtype
        self.in_proj = Dense(d_model, d_inner * 2, bias=False, dtype=dtype)
        self.x_proj = Dense(d_inner, state_dim * 2, bias=False, dtype=dtype)
        self.dt_proj = Dense(d_inner, d_inner, dtype=dtype)
        self.out_proj = Dense(d_inner, d_model, bias=False, dtype=dtype)
        self.A_log = nn.Parameter(torch.zeros(state_dim))
        self.D = nn.Parameter(torch.zeros(d_inner))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_in, z = self.in_proj(x).chunk(2, dim=-1)
        B, C = self.x_proj(x_in).chunk(2, dim=-1)
        dt = F.softplus(self.dt_proj(x_in))
        A = -torch.exp(self.A_log)
        f32 = torch.float32
        y = selective_scan(x_in.to(f32), dt.to(f32), A, B.to(f32), C.to(f32), self.D,
                           mode=self.scan_mode)
        y = y.to(self.dtype) * F.silu(z)
        return self.out_proj(y)


class SSMBlock(nn.Module):
    """Pre-norm block: norm1 -> causal depthwise conv -> SelectiveSSM ->
    +residual; norm2 -> FFN (d -> expand*d, exact GELU, -> d) -> +residual."""

    def __init__(self, d_model: int = 192, state_dim: int = 64, expand_ratio: int = 2,
                 kernel_size: int = 4, scan_mode: str = "parallel",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(d_model, dtype)
        self.conv = nn.Conv1d(d_model, d_model, kernel_size, groups=d_model)
        self.ssm = SelectiveSSM(d_model, state_dim, expand_ratio, scan_mode, dtype)
        self.norm2 = LayerNorm(d_model, dtype)
        self.ffn_in = Dense(d_model, d_model * expand_ratio, dtype=dtype)
        self.ffn_out = Dense(d_model * expand_ratio, d_model, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = causal_depthwise_conv1d(self.norm1(x), self.conv.weight, self.conv.bias)
        x = self.ssm(h) + x
        h = self.ffn_out(F.gelu(self.ffn_in(self.norm2(x))))
        return h + x


class LocalSSMProcessor(nn.Module):
    """A stack of SSM blocks and a final LayerNorm."""

    def __init__(self, d_model: int = 192, num_layers: int = 8, state_dim: int = 64,
                 expand_ratio: int = 2, kernel_size: int = 4,
                 scan_mode: str = "parallel", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            SSMBlock(d_model, state_dim, expand_ratio, kernel_size, scan_mode, dtype)
            for _ in range(num_layers)
        )
        self.norm = LayerNorm(d_model, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.layers:
            x = block(x)
        return self.norm(x)


class GlobalSSM(LocalSSMProcessor):
    """The SSM stack over pooled tokens: expand ratio 2 and kernel size 4,
    fixed as in the JAX package."""

    def __init__(self, d_model: int = 192, num_layers: int = 2, state_dim: int = 32,
                 scan_mode: str = "parallel", dtype: torch.dtype = torch.float32):
        super().__init__(d_model, num_layers, state_dim, expand_ratio=2, kernel_size=4,
                         scan_mode=scan_mode, dtype=dtype)
