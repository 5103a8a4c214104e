"""Front-end and output layers (mirrors velocity_asr_tpu/models/layers.py),
offline and streaming.

Parameters are fp32. ``Dense`` casts its input, weight and bias to the
compute dtype, as flax's ``nn.Dense(dtype=...)`` does; LayerNorms run in
fp32 with eps 1e-5 and cast back. ``quant_dense`` builds each
quantizable projection (attention, fusion, pooling, CTC head) as a Dense,
a QAT fake-quantized Dense or an int8 Dense. ``Dropout`` is flax's
(``nn.Dropout``: keep with probability 1 - rate, scale by 1 / (1 - rate))
in training mode, drawing its mask from a ``torch.Generator`` that the
caller passes to each forward; in eval mode it is the identity. Under a
``parallel.data_shard`` the mask is this rank's part of the global
batch's (``parallel.mesh.sharded_draw``).

Under tensor parallelism (``parallel.tp.shard_params_tp``) the CTC head
holds its slice of the vocabulary and gathers the logits over the model
group.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import strided_conv1d
from ..parallel.mesh import enter, gather, sharded_draw


class Dense(nn.Linear):
    """nn.Linear computed in a fixed dtype (flax ``nn.Dense(dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def quant_mode(qat: bool, int8: bool) -> str:
    """The projection mode: "qat", "int8" or "none" (QAT wins)."""
    return "qat" if qat else ("int8" if int8 else "none")


def quant_dense(mode: str, in_features: int, out_features: int,
                dtype: torch.dtype = torch.float32, bias: bool = True,
                static: bool = False, qat_bits=(8, 8)) -> nn.Linear:
    """A Dense (mode "none"), a QAT Dense with (weight, activation) bits
    `qat_bits` (mode "qat") or an int8 Dense (mode "int8"; static selects
    calibrated activation scales): the one place that picks, so no call
    site drifts."""
    if mode == "qat":
        from ..quantize import QuantDense

        return QuantDense(in_features, out_features, bias=bias, dtype=dtype,
                          weight_bits=qat_bits[0], activation_bits=qat_bits[1])
    if mode == "int8":
        from ..quantize import DynamicInt8Dense

        return DynamicInt8Dense(in_features, out_features, bias=bias, dtype=dtype,
                                static=static)
    if mode == "none":
        return Dense(in_features, out_features, bias=bias, dtype=dtype)
    raise ValueError(f"unknown projection mode {mode!r}")


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training mode, zero each element with
    probability `rate` and scale the rest by 1 / (1 - rate), the mask drawn
    from `rng` (a ``torch.Generator`` on x's device); the identity in eval
    mode or at rate 0."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, rng: torch.Generator | None = None,
                batch_dim: int = 0, experts=None) -> torch.Tensor:
        """`batch_dim` is x's batch axis and `experts` (index, count) marks
        dim 0 as this rank's block of experts (``sharded_draw``)."""
        if not self.training or self.rate == 0.0:
            return x
        if rng is None:
            raise ValueError("dropout in training mode draws its mask from an explicit "
                             "torch.Generator: pass rng")
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        mask = sharded_draw(lambda s: torch.rand(s, generator=rng, device=x.device), x.shape,
                            batch_dim, experts) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class LayerNorm(nn.LayerNorm):
    """LayerNorm in fp32 (eps 1e-5), cast back to a compute dtype."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=1e-5)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(torch.float32)).to(self.compute_dtype)


def sinusoidal_time_encoding(max_len: int, dim: int) -> np.ndarray:
    """Fixed sinusoidal table, shape (max_len, dim): sin in the even
    columns, cos in the odd ones."""
    pe = np.zeros((max_len, dim), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, dim, 2, dtype=np.float32) * (-math.log(10000.0) / dim))
    ang = position * div_term
    n_even = (dim + 1) // 2
    pe[:, 0::2] = np.sin(ang[:, :n_even])
    pe[:, 1::2] = np.cos(ang[:, : dim - n_even])
    return pe


@functools.lru_cache(maxsize=16)
def _time_encoding(seq_len: int, dim: int, device: torch.device) -> torch.Tensor:
    # a normal tensor even when first asked for under inference mode, so a
    # later training step can use the cached table under autograd
    with torch.inference_mode(False):
        return torch.tensor(sinusoidal_time_encoding(seq_len, dim), device=device)


def time_encoding(time_offset, seq_len: int, dim: int,
                  device: torch.device) -> torch.Tensor:
    """Sinusoid at absolute positions time_offset + t, in fp32.

    An int offset gives (seq_len, dim): a cached table at offset 0
    (offline and a stream's first chunk), computed from the positions
    after that, as the JAX package computes it (no table cap on a
    session's length). A (batch,) tensor of offsets (independent sessions
    batched through one step) gives (batch, seq_len, dim), each row
    exactly what its offset gives as an int: rows at 0 read the table.
    """
    if isinstance(time_offset, torch.Tensor):
        offs = time_offset.to(device=device, dtype=torch.float32).reshape(-1, 1)
        pe = _sinusoid(offs + torch.arange(seq_len, dtype=torch.float32, device=device), dim)
        at_zero = (offs == 0)[:, :, None]
        return torch.where(at_zero, _time_encoding(seq_len, dim, device), pe)
    if time_offset == 0:
        return _time_encoding(seq_len, dim, device)
    return _sinusoid(float(time_offset) + torch.arange(seq_len, dtype=torch.float32,
                                                       device=device), dim)


def _sinusoid(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """(..., dim) sinusoid of fp32 positions (...,): sines in the even
    columns, cosines in the odd ones."""
    div_term = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device)
                         * (-math.log(10000.0) / dim))
    ang = positions[..., None] * div_term
    n_even = (dim + 1) // 2
    pe = torch.empty(positions.shape + (dim,), dtype=torch.float32, device=positions.device)
    pe[..., 0::2] = torch.sin(ang[..., :n_even])
    pe[..., 1::2] = torch.cos(ang[..., : dim - n_even])
    return pe


class PositionalEncoding2D(nn.Module):
    """First d_model/2 dims: fixed sinusoid over time; last d_model/2: one
    learned frequency vector broadcast over time. time_offset is the
    absolute output frame of x's first frame (streaming): an int, or a
    (batch,) tensor with one offset per row."""

    def __init__(self, d_model: int):
        super().__init__()
        self.half = d_model // 2
        self.pe_freq = nn.Parameter(torch.zeros(1, 1, self.half))

    def forward(self, x: torch.Tensor, time_offset=0) -> torch.Tensor:
        batch, seq_len, _ = x.shape
        pe_time = time_encoding(time_offset, seq_len, self.half, x.device)
        if pe_time.dim() == 2:  # one offset for the whole batch
            pe_time = pe_time[None]
        pos = torch.cat([pe_time, self.pe_freq.expand(pe_time.shape[0], seq_len, self.half)],
                        dim=-1)
        return x + pos.to(x.dtype)


class TemporalBindingLayer(nn.Module):
    """Conv1d(mel_bins -> d_model, k=3, stride=2, pad=1) -> exact GELU ->
    2D positional encoding -> LayerNorm. Output length (L + 1) // 2. With
    `qat` the conv is a ``QuantConv1d`` (offline only).

    Streaming (``return_carry``): chunks have an even number of frames;
    the last ``kernel_size // 2`` mel frames of a chunk are carried (zeros
    before the first chunk) and spliced in front of the next, and a valid
    strided conv over [carry | chunk] gives exactly the chunk's offline
    outputs. time_offset is the chunk's first absolute output frame."""

    def __init__(self, mel_bins: int = 80, d_model: int = 192, kernel_size: int = 3,
                 stride: int = 2, dtype: torch.dtype = torch.float32, qat: bool = False,
                 qat_bits=(8, 8)):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.qat = qat
        if qat:
            from ..quantize import QuantConv1d

            self.conv = QuantConv1d(mel_bins, d_model, kernel_size, stride=stride,
                                    padding=kernel_size // 2, dtype=dtype,
                                    weight_bits=qat_bits[0], activation_bits=qat_bits[1])
        else:
            self.conv = nn.Conv1d(mel_bins, d_model, kernel_size)
        self.pos_encoding = PositionalEncoding2D(d_model)
        self.norm = LayerNorm(d_model, dtype)

    def forward(self, mel: torch.Tensor, carry: torch.Tensor | None = None,
                time_offset=0, return_carry: bool = False):
        k = self.conv.kernel_size[0]
        if not return_carry:
            if self.qat:
                x = self.conv(mel.to(self.dtype))
            else:
                x = strided_conv1d(mel.to(self.dtype), self.conv.weight, self.conv.bias,
                                   stride=self.stride, padding=k // 2)
            x = F.gelu(x)  # exact erf, as torch's and flax's approximate=False
            return self.norm(self.pos_encoding(x))
        if self.qat:
            raise NotImplementedError("streaming QAT front-end not supported")
        if mel.shape[1] % self.stride:
            raise ValueError(f"stream chunks must be a multiple of {self.stride} frames, "
                             f"got {mel.shape[1]}")
        # The one-frame carry reproduces the offline conv only while no
        # output needs frames beyond its chunk.
        if k // 2 > self.stride - 1:
            raise NotImplementedError(
                f"streaming temporal binding requires kernel_size // 2 "
                f"<= stride - 1 (got kernel_size={k}, "
                f"stride={self.stride}); offline mode supports any size"
            )
        pad = k // 2
        if carry is None:
            carry = torch.zeros(mel.shape[0], pad, mel.shape[2], dtype=torch.float32,
                                device=mel.device)
        mel_ext = torch.cat([carry.to(mel.dtype), mel], dim=1)
        new_carry = mel_ext[:, mel_ext.shape[1] - pad:]
        x = strided_conv1d(mel_ext.to(self.dtype), self.conv.weight, self.conv.bias,
                           stride=self.stride, padding=0)
        x = F.gelu(x)
        return self.norm(self.pos_encoding(x, time_offset)), new_carry


class CTCOutputHead(nn.Module):
    """LayerNorm -> Dropout -> Linear(vocab). With ``tp_group`` set
    (``parallel.tp.shard_params_tp``) the projection holds this rank's
    rows of the vocabulary and the logits are gathered over the group."""

    def __init__(self, d_model: int = 192, vocab_size: int = 1000,
                 dtype: torch.dtype = torch.float32, int8: bool = False,
                 int8_static: bool = False, dropout: float = 0.0, qat: bool = False,
                 qat_bits=(8, 8)):
        super().__init__()
        self.norm = LayerNorm(d_model, dtype)
        self.dropout = Dropout(dropout)
        self.proj = quant_dense(quant_mode(qat, int8), d_model, vocab_size, dtype,
                                static=int8_static, qat_bits=qat_bits)
        self.tp_group = None

    def forward(self, x: torch.Tensor, rng: torch.Generator | None = None) -> torch.Tensor:
        h = self.dropout(self.norm(x), rng)
        if self.tp_group is None:
            return self.proj(h)
        return gather(self.proj(enter(h, self.tp_group)), self.tp_group, dim=-1)
