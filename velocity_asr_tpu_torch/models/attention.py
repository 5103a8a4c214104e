"""Hierarchical global context (mirrors velocity_asr_tpu/models/attention.py),
offline and streaming.

Pool sizes follow the (bucketed) sequence length; pooling is an
averaging matmul (ops/pooling.py). The cross-attention is small (<= 64
keys) and runs as plain matmuls with the softmax in fp32. With qat or
int8 set, the ten projections here are QAT or int8 Dense layers
(``layers.quant_dense``); the global SSM's stay float.
In training mode the attention weights and the global SSM's blocks apply
dropout, offline and streaming, their masks drawn from the ``rng`` passed
in.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..ops.pooling import adaptive_avg_pool1d, pool_size_level1, pool_size_level2
from .layers import Dropout, LayerNorm, quant_dense, quant_mode
from .ssm import GlobalSSM


class AdaptivePool(nn.Module):
    """Adaptive average pool over time, then a learned projection.
    Level 1: K1 = max(64, L // 8); level 2: K2 = min(64, max(16, K1 // 4));
    both clamped to the input length."""

    def __init__(self, level: int = 1, d_model: int = 192,
                 dtype: torch.dtype = torch.float32, int8: bool = False,
                 int8_static: bool = False, qat: bool = False, qat_bits=(8, 8)):
        super().__init__()
        self.level = level
        self.pool_proj = quant_dense(quant_mode(qat, int8), d_model, d_model, dtype,
                                     static=int8_static, qat_bits=qat_bits)

    def forward(self, x: torch.Tensor, prev_pool_size: int | None = None,
                pre_pooled: bool = False):
        """(projected pooled tokens, pool size). pre_pooled: x is already a
        streaming chunk's summary tokens; only the projection applies."""
        seq_len = x.shape[1]
        if pre_pooled:
            return self.pool_proj(x), seq_len
        if self.level == 1:
            pool_size = pool_size_level1(seq_len)
        else:
            k1 = prev_pool_size if prev_pool_size is not None else pool_size_level1(seq_len)
            pool_size = min(pool_size_level2(k1), seq_len)
        return self.pool_proj(adaptive_avg_pool1d(x, pool_size)), pool_size


class MultiHeadAttention(nn.Module):
    """Cross-attention with reduced attention dim: softmax(q k^T / sqrt(hd)) v,
    dropout on the attention weights."""

    def __init__(self, d_model: int = 192, num_heads: int = 4, attention_dim: int = 48,
                 dtype: torch.dtype = torch.float32, int8: bool = False,
                 int8_static: bool = False, dropout: float = 0.0, qat: bool = False,
                 qat_bits=(8, 8)):
        super().__init__()
        if attention_dim % num_heads:
            raise ValueError(
                f"attention_dim {attention_dim} not divisible by num_heads {num_heads}"
            )
        self.num_heads = num_heads
        self.attention_dim = attention_dim
        self.dtype = dtype
        mode = quant_mode(qat, int8)
        q = {"static": int8_static, "qat_bits": qat_bits}
        self.q_proj = quant_dense(mode, d_model, attention_dim, dtype, **q)
        self.k_proj = quant_dense(mode, d_model, attention_dim, dtype, **q)
        self.v_proj = quant_dense(mode, d_model, attention_dim, dtype, **q)
        self.out_proj = quant_dense(mode, attention_dim, d_model, dtype, **q)
        self.dropout = Dropout(dropout)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                rng: torch.Generator | None = None):
        batch, q_len, _ = query.shape
        kv_len = key.shape[1]
        hd = self.attention_dim // self.num_heads

        def heads(t, n):
            return t.reshape(batch, n, self.num_heads, hd).transpose(1, 2)

        q = heads(self.q_proj(query), q_len)
        k = heads(self.k_proj(key), kv_len)
        v = heads(self.v_proj(value), kv_len)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        attn = torch.softmax(scores.to(torch.float32), dim=-1).to(self.dtype)
        attn = self.dropout(attn, rng)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(batch, q_len, self.attention_dim)
        return self.out_proj(out)


class GatedFusion(nn.Module):
    """gate = sigmoid(W [local, global]); out = W_o (gate*W_l local + (1-gate)*W_g global)."""

    def __init__(self, d_model: int = 192, dtype: torch.dtype = torch.float32,
                 int8: bool = False, int8_static: bool = False, qat: bool = False,
                 qat_bits=(8, 8)):
        super().__init__()
        mode = quant_mode(qat, int8)
        q = {"static": int8_static, "qat_bits": qat_bits}
        self.gate_proj = quant_dense(mode, 2 * d_model, d_model, dtype, **q)
        self.local_proj = quant_dense(mode, d_model, d_model, dtype, **q)
        self.global_proj = quant_dense(mode, d_model, d_model, dtype, **q)
        self.out_proj = quant_dense(mode, d_model, d_model, dtype, **q)

    def forward(self, local_features: torch.Tensor, global_features: torch.Tensor):
        gate = torch.sigmoid(self.gate_proj(torch.cat([local_features, global_features], -1)))
        fused = gate * self.local_proj(local_features) + (1 - gate) * self.global_proj(
            global_features
        )
        return self.out_proj(fused)


class HierarchicalGlobalContext(nn.Module):
    """Pool -> GlobalSSM -> pool -> cross-attention -> gated fusion.

    Streaming (``summary`` given): this chunk's pooled summary tokens
    (batch, S, d_model) pass the level-1 projection and the GlobalSSM
    incrementally (per-block conv and scan state in ``gc_state["blocks"]``),
    and the SSM outputs roll into a memory ``gc_state["mem"]`` (batch, M,
    d_model) fp32, over which level-2 pooling and the cross-attention run.
    A row whose ``gc_state["init"]`` is false (its first chunk) fills the
    memory by tiling its tokens. ``frozen`` is the lookahead emit pass:
    attend over the memory as given, advancing nothing. Returns (fused,
    new gc_state).
    """

    def __init__(self, d_model: int = 192, num_heads: int = 4, attention_dim: int = 48,
                 global_ssm_layers: int = 2, global_ssm_state_dim: int = 32,
                 scan_mode: str = "parallel", dtype: torch.dtype = torch.float32,
                 int8: bool = False, int8_static: bool = False, dropout: float = 0.0,
                 qat: bool = False, qat_bits=(8, 8)):
        super().__init__()
        q = {"int8": int8, "int8_static": int8_static, "qat": qat, "qat_bits": qat_bits}
        self.dtype = dtype
        self.pool1 = AdaptivePool(1, d_model, dtype, **q)
        self.global_ssm = GlobalSSM(d_model, global_ssm_layers, global_ssm_state_dim,
                                    scan_mode, dtype, dropout)
        self.pool2 = AdaptivePool(2, d_model, dtype, **q)
        self.norm1 = LayerNorm(d_model, dtype)
        self.norm2 = LayerNorm(d_model, dtype)
        self.cross_attention = MultiHeadAttention(d_model, num_heads, attention_dim, dtype,
                                                  dropout=dropout, **q)
        self.fusion = GatedFusion(d_model, dtype, **q)

    def forward(self, local_features: torch.Tensor, summary: torch.Tensor | None = None,
                gc_state: dict | None = None, frozen: bool = False,
                rng: torch.Generator | None = None):
        streaming = summary is not None
        if streaming and gc_state is None:
            raise ValueError(
                "streaming HierarchicalGlobalContext requires gc_state "
                "(build one with streaming.init_stream_state)"
            )
        if streaming and frozen:
            x_ssm = gc_state["mem"].to(self.dtype)
            pool_size1 = x_ssm.shape[1]
            new_gc_state = gc_state
        elif streaming:
            x_new, _ = self.pool1(summary.to(self.dtype), pre_pooled=True)
            ssm_new, new_blocks = self.global_ssm(x_new, gc_state["blocks"],
                                                  return_state=True, rng=rng)
            mem = gc_state["mem"]
            mem_tokens, s = mem.shape[1], ssm_new.shape[1]
            ssm_new = ssm_new.to(torch.float32)
            tiled = ssm_new.repeat(1, mem_tokens // s, 1)
            rolled = torch.cat([mem[:, s:], ssm_new], dim=1)
            x_ssm = torch.where(gc_state["init"][:, None, None], rolled, tiled).to(self.dtype)
            pool_size1 = mem_tokens
            new_gc_state = {"mem": x_ssm.to(torch.float32), "blocks": new_blocks,
                            "init": torch.ones_like(gc_state["init"])}
        else:
            x_pool1, pool_size1 = self.pool1(local_features)
            x_ssm = self.global_ssm(x_pool1, rng=rng)
        x_pool2, _ = self.pool2(x_ssm, prev_pool_size=pool_size1)
        x_pool2 = self.norm1(x_pool2)
        query = self.norm2(local_features)
        global_context = self.cross_attention(query, x_pool2, x_pool2, rng=rng)
        fused = self.fusion(local_features, global_context)
        return (fused, new_gc_state) if streaming else fused
