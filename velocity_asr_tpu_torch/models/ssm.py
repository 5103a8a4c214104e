"""Selective-SSM components (mirrors velocity_asr_tpu/models/ssm.py),
offline and streaming.

The recurrence always runs in fp32; the Dense layers run in the compute
dtype. A streaming block carries, per stream, its last (k-1) normed
frames (the causal conv's tail, fp32) and the scan state (batch,
d_inner, state_dim) fp32: ``{"conv": ..., "ssm": ...}``, in the autograd
graph when it records (the streaming-aware objective). In training mode
each block applies dropout after the SSM, after the FFN's GELU and after
the FFN (the JAX sites), offline and streaming, its masks drawn from the
``rng`` passed in.

With ``checkpoint`` (the model's ``gradient_checkpointing``) the local
stack runs each block of a stateless pass under autograd as
``CheckpointedBlock``: the forward keeps only the block's input and
runs without recording (the no-bounds scan), and the backward runs the
block again, recording (the bounds scan), with its dropout masks
replayed from the generator state saved at the block's entry.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import causal_depthwise_conv1d
from ..ops.scan import selective_scan
from .layers import Dense, Dropout, LayerNorm


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

    def forward(self, x: torch.Tensor, ssm_state: torch.Tensor | None = None,
                return_state: bool = False):
        """y, or (y, final scan state) with return_state; ssm_state seeds
        the scan."""
        x_in, z = self.in_proj(x).chunk(2, dim=-1)
        B, C = self.x_proj(x_in).chunk(2, dim=-1)
        dt = F.softplus(self.dt_proj(x_in))
        A = -torch.exp(self.A_log)
        f32 = torch.float32
        y = selective_scan(x_in.to(f32), dt.to(f32), A, B.to(f32), C.to(f32), self.D,
                           mode=self.scan_mode, h0=ssm_state, return_state=return_state)
        if return_state:
            y, h_final = y
        out = self.out_proj(y.to(self.dtype) * F.silu(z))
        return (out, h_final) if return_state else out


class SSMBlock(nn.Module):
    """Pre-norm block: norm1 -> causal depthwise conv -> SelectiveSSM ->
    dropout -> +residual; norm2 -> FFN (d -> expand*d, exact GELU, dropout,
    -> d) -> dropout -> +residual."""

    def __init__(self, d_model: int = 192, state_dim: int = 64, expand_ratio: int = 2,
                 kernel_size: int = 4, scan_mode: str = "parallel",
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.kernel_size = kernel_size
        self.d_inner = d_model * expand_ratio
        self.state_dim = state_dim
        self.norm1 = LayerNorm(d_model, dtype)
        self.conv = nn.Conv1d(d_model, d_model, kernel_size, groups=d_model)
        self.ssm = SelectiveSSM(d_model, state_dim, expand_ratio, scan_mode, dtype)
        self.norm2 = LayerNorm(d_model, dtype)
        self.ffn_in = Dense(d_model, d_model * expand_ratio, dtype=dtype)
        self.ffn_out = Dense(d_model * expand_ratio, d_model, dtype=dtype)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, state: dict | None = None,
                return_state: bool = False, rng: torch.Generator | None = None):
        """out, or (out, new state) with return_state. A passed state is
        spliced in either way: the carried conv tail goes in front of the
        chunk, so the causal conv is exact across chunk boundaries. `rng`
        draws the dropout masks in training mode."""
        h = self.norm1(x)
        if return_state and state is None:
            state = self.init_stream_state(x.shape[0], x.device)
        if state is not None:
            h_ext = torch.cat([state["conv"].to(h.dtype), h], dim=1)
            # explicit start index: -(k-1) == -0 would keep everything at k == 1
            new_tail = h_ext[:, h_ext.shape[1] - (self.kernel_size - 1):]
            h = causal_depthwise_conv1d(h_ext, self.conv.weight, self.conv.bias)[
                :, self.kernel_size - 1:]
        else:
            h = causal_depthwise_conv1d(h, self.conv.weight, self.conv.bias)
        ssm_state = None if state is None else state["ssm"]
        if return_state:
            h, ssm_final = self.ssm(h, ssm_state, return_state=True)
        else:
            h = self.ssm(h, ssm_state)
        x = self.dropout(h, rng) + x
        h = self.dropout(F.gelu(self.ffn_in(self.norm2(x))), rng)
        out = self.dropout(self.ffn_out(h), rng) + x
        if return_state:
            return out, {"conv": new_tail.to(torch.float32), "ssm": ssm_final}
        return out

    def init_stream_state(self, batch: int, device="cpu") -> dict:
        """Zero streaming state: (k-1) conv-tail frames and the scan state."""
        return {
            "conv": torch.zeros(batch, self.kernel_size - 1, self.d_model,
                                dtype=torch.float32, device=device),
            "ssm": torch.zeros(batch, self.d_inner, self.state_dim, dtype=torch.float32,
                               device=device),
        }


class CheckpointedBlock(torch.autograd.Function):
    """out = block(x, rng=rng), recomputed in the backward instead of kept
    (``nn.remat`` of a block, as the JAX package wraps each local block).

    The forward runs the block without recording and saves x and, if
    `rng` is given, its state before the block's draws; the backward
    runs the block again from x with a generator at that state, so its
    dropout masks are the first pass's, and returns the gradients of x
    and of the block's parameters (passed as `params`, in
    ``block.parameters()`` order)."""

    @staticmethod
    def forward(ctx, block, rng, x, *params):
        ctx.block = block
        ctx.rng_state = None if rng is None else rng.get_state()
        ctx.rng_device = None if rng is None else rng.device
        ctx.save_for_backward(x)
        return block(x, rng=rng)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        rng = None
        if ctx.rng_state is not None:
            rng = torch.Generator(device=ctx.rng_device)
            rng.set_state(ctx.rng_state)
        params = list(ctx.block.parameters())
        with torch.enable_grad():
            x_in = x.detach().requires_grad_(ctx.needs_input_grad[2])
            out = ctx.block(x_in, rng=rng)
        wanted = [t for t, need in zip([x_in] + params, ctx.needs_input_grad[2:]) if need]
        grads = iter(torch.autograd.grad(out, wanted, g, allow_unused=True))
        return (None, None) + tuple(next(grads) if need else None
                                    for need in ctx.needs_input_grad[2:])


class LocalSSMProcessor(nn.Module):
    """A stack of SSM blocks and a final LayerNorm; with `checkpoint`, a
    stateless pass that records gradients runs each block as
    ``CheckpointedBlock``."""

    def __init__(self, d_model: int = 192, num_layers: int = 8, state_dim: int = 64,
                 expand_ratio: int = 2, kernel_size: int = 4,
                 scan_mode: str = "parallel", dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0, checkpoint: bool = False):
        super().__init__()
        self.checkpoint = checkpoint
        self.layers = nn.ModuleList(
            SSMBlock(d_model, state_dim, expand_ratio, kernel_size, scan_mode, dtype, dropout)
            for _ in range(num_layers)
        )
        self.norm = LayerNorm(d_model, dtype)

    def forward(self, x: torch.Tensor, states: list | None = None,
                return_state: bool = False, rng: torch.Generator | None = None):
        """out, or (out, per-block states) with return_state. Passed
        states are spliced in even when no state is asked back (running
        stateless would decode the chunk as a fresh stream)."""
        new_states = []
        remat = (self.checkpoint and states is None and not return_state
                 and torch.is_grad_enabled())
        for i, block in enumerate(self.layers):
            state = None if states is None else states[i]
            if remat:
                x = CheckpointedBlock.apply(block, rng, x, *block.parameters())
            elif return_state:
                x, st = block(x, state, return_state=True, rng=rng)
                new_states.append(st)
            else:
                x = block(x, state, rng=rng)
        out = self.norm(x)
        return (out, new_states) if return_state else out


class GlobalSSM(LocalSSMProcessor):
    """The SSM stack over pooled tokens: expand ratio 2 and kernel size 4,
    fixed as in the JAX package."""

    def __init__(self, d_model: int = 192, num_layers: int = 2, state_dim: int = 32,
                 scan_mode: str = "parallel", dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__(d_model, num_layers, state_dim, expand_ratio=2, kernel_size=4,
                         scan_mode=scan_mode, dtype=dtype, dropout=dropout)
