"""Mixture-of-experts FFN (mirrors velocity_asr_tpu/models/moe.py).

``VelocityASRConfig.moe_experts > 0`` replaces each local SSM block's
dense FFN with ``num_experts`` expert FFNs behind a top-k softmax router.
Routing follows the JAX package's capacity dispatch exactly, since each
detail decides which expert a token reaches:

- the sequence is padded to a multiple of the group size
  ``s = min(group_size, T)`` and folded into (B * G, s) groups; only that
  fold padding is masked out of routing, capacity and the aux loss;
- each expert takes ``C = min(s, max(1, ceil(k * s * f / E)))`` tokens
  a group;
- the router is an fp32 Dense (no bias) on the block's normed input cast
  to fp32, then a softmax;
- k rounds of first-index argmax, each masking the expert it took; within
  an expert a token's slot is ``cumsum(mask) - mask + counts`` (earlier
  tokens and earlier rounds first), and a token past capacity is dropped
  for that choice;
- each kept choice is weighted by its original gate over the sum of the
  kept gates (floored at 1e-9); a token every choice dropped gives 0.

Where the JAX package builds one-hot dispatch and combine tensors and
runs einsums, the port gathers each expert's tokens into an (E, B*G*C, d)
buffer, runs both expert matmuls as batched matmuls over E in the compute
dtype (exact GELU and dropout between them) and gathers each token's k
outputs back. The Switch load-balance aux ``E * sum_e f_e * P_e`` (f the
first-choice fraction, P the mean gate, over valid tokens) and f itself
are returned only to a caller that passes a ``collect`` list: each layer
appends ``(aux, f_frac)``.

Expert parallelism (``parallel.tp.shard_params_tp`` sets ``ep``): the
expert weights hold this rank's block of experts, the routing is computed
on every rank, each rank runs its experts on the tokens routed to them,
and the weighted outputs are summed over the model group. Under a
``parallel.data_shard`` f and P are means over the real rows of the
global batch (their sums and the token count all-reduced over the data
axis), as one process computes them, and the dropout mask is this rank's
part of the global one.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import tracing
from ..parallel.mesh import current_data_shard, enter_all, reduce
from .layers import Dense, Dropout


def expert_init_bound(num_experts: int, fan_in: int, fan_out: int) -> float:
    """The xavier-uniform bound flax draws an (E, fan_in, fan_out) expert
    weight from: its fans count the leading E axis as receptive field,
    so the bound is sqrt(6 / (E * (fan_in + fan_out)))."""
    return math.sqrt(6.0 / (num_experts * (fan_in + fan_out)))


class MoEFFN(nn.Module):
    """Top-k routed mixture of expert FFNs (d -> hidden, exact GELU,
    dropout, -> d). Parameters in the flax layout: ``router`` (a Dense,
    fp32, no bias), ``w_in`` (E, d, hidden), ``b_in`` (E, hidden),
    ``w_out`` (E, hidden, d), ``b_out`` (E, d)."""

    def __init__(self, d_model: int = 192, hidden: int = 384, num_experts: int = 8,
                 top_k: int = 2, capacity_factor: float = 1.25, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, group_size: int = 128):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"moe_top_k={top_k} must be in [1, num_experts={num_experts}]")
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.group_size = group_size
        self.router = Dense(d_model, num_experts, bias=False, dtype=torch.float32)
        self.w_in = nn.Parameter(torch.zeros(num_experts, d_model, hidden))
        self.b_in = nn.Parameter(torch.zeros(num_experts, hidden))
        self.w_out = nn.Parameter(torch.zeros(num_experts, hidden, d_model))
        self.b_out = nn.Parameter(torch.zeros(num_experts, d_model))
        self.dropout = Dropout(dropout)
        self.ep = None  # (model group, this rank's block, blocks) under expert parallelism

    def capacity(self, s_len: int) -> int:
        """Slots per expert in a group of s_len tokens."""
        return min(s_len, max(1, math.ceil(self.top_k * s_len * self.capacity_factor
                                           / self.num_experts)))

    def route(self, xg: torch.Tensor, valid: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The routing of (G, S, d) groups whose tokens `valid` (G, S) marks
        (1.0 real, 0.0 fold padding): gates (G, S, E) fp32; per choice k
        the expert ``idx`` (K, G, S), the slot ``pos`` (K, G, S), whether
        it was kept ``keep`` (K, G, S) and its combine weight ``weight``
        (K, G, S) fp32; the capacity ``cap``; ``first`` the first choice's
        mask (G, S, E)."""
        n_exp, cap = self.num_experts, self.capacity(xg.shape[1])
        gates = torch.softmax(self.router(xg.to(torch.float32)), dim=-1)
        remaining = gates.detach()
        counts = torch.zeros(xg.shape[0], 1, n_exp, dtype=torch.float32, device=xg.device)
        kept_sum = torch.zeros_like(valid)
        idxs, poss, keeps, gate_ks = [], [], [], []
        first = None
        for _ in range(self.top_k):
            idx = remaining.argmax(dim=-1)  # the first maximal index, as jnp.argmax
            mask = F.one_hot(idx, n_exp).to(torch.float32) * valid[..., None]
            if first is None:
                first = mask
            pos = (torch.cumsum(mask, dim=1) - mask + counts)
            pos_tok = (pos * mask).sum(dim=-1)
            keep = (pos_tok < cap).to(torch.float32) * valid
            gate_k = (gates * mask).sum(dim=-1)  # the original gate value
            kept_sum = kept_sum + gate_k * keep
            counts = counts + mask.sum(dim=1, keepdim=True)
            remaining = remaining * (1.0 - mask)
            idxs.append(idx)
            poss.append(pos_tok.to(torch.int64))
            keeps.append(keep)
            gate_ks.append(gate_k)
        denom = torch.clamp(kept_sum, min=1e-9)
        weight = torch.stack([g * k / denom for g, k in zip(gate_ks, keeps)])
        return {"gates": gates, "idx": torch.stack(idxs), "pos": torch.stack(poss),
                "keep": torch.stack(keeps) > 0, "weight": weight, "cap": cap,
                "first": first}

    def forward(self, x: torch.Tensor, rng: Optional[torch.Generator] = None,
                collect: Optional[List] = None) -> torch.Tensor:
        """(B, T, d) in the compute dtype -> (B, T, d). In training mode
        the dropout after the GELU draws from `rng`; `collect`, if given,
        receives (aux, f_frac) of this call."""
        b, t_len, d = x.shape
        k_top, dt = self.top_k, self.dtype
        group, e_index, e_count = self.ep if self.ep is not None else (None, 0, 1)
        n_local = self.w_in.shape[0]  # this rank's experts: n_exp / e_count
        s_len = min(self.group_size, t_len)
        pad = (-t_len) % s_len
        n_groups = (t_len + pad) // s_len
        xg = F.pad(x, (0, 0, 0, pad)) if pad else x
        bg = b * n_groups
        xg = xg.reshape(bg, s_len, d)
        valid = (torch.arange(t_len + pad, device=x.device) < t_len).to(torch.float32)
        valid = valid.expand(b, -1).reshape(bg, s_len)
        with tracing.span("moe.route"):
            r = self.route(xg, valid)
        cap = r["cap"]
        with tracing.span("moe.dispatch"):
            # under EP the experts' inputs and the combine weights enter the
            # sharded region (one all-reduce of their gradients)
            x_in, weight = enter_all((xg, r["weight"]), group)
            keep, idx = r["keep"], r["idx"]
            if self.ep is not None:  # the choices this rank's experts serve
                idx = idx - e_index * n_local
                keep = keep & (idx >= 0) & (idx < n_local)

            # slot -> token: each kept choice writes its token index into slot
            # expert * cap + pos of its group; dropped choices go to a spare
            # column; an empty slot points at the zero row (index bg * s_len)
            with torch.no_grad():
                tok = torch.arange(s_len, device=x.device).expand(bg, s_len)
                slot_tok = torch.full((bg, n_local * cap + 1), s_len, dtype=torch.int64,
                                      device=x.device)
                slots = torch.where(keep, idx * cap + r["pos"], n_local * cap)
                for k in range(k_top):
                    slot_tok.scatter_(1, slots[k], tok)
                base = torch.arange(bg, device=x.device)[:, None] * s_len
                src = torch.where(slot_tok[:, :-1] < s_len, slot_tok[:, :-1] + base, bg * s_len)
                src = src.view(bg, n_local, cap).transpose(0, 1).reshape(-1)
            x_rows = torch.cat([x_in.reshape(bg * s_len, d).to(dt),
                                torch.zeros(1, d, dtype=dt, device=x.device)])
            expert_in = x_rows.index_select(0, src).view(n_local, bg * cap, d)
        with tracing.span("moe.experts"):
            h = torch.baddbmm(self.b_in.to(dt)[:, None, :], expert_in, self.w_in.to(dt))
            h = self.dropout(F.gelu(h), rng, batch_dim=1,
                             experts=None if self.ep is None else (e_index, e_count))
            expert_out = torch.baddbmm(self.b_out.to(dt)[:, None, :], h, self.w_out.to(dt))

        with tracing.span("moe.combine"):
            # token <- its k outputs, weighted; a dropped choice (or one another
            # rank's experts serve) reads the zero row
            with torch.no_grad():
                first_slot = torch.arange(bg, device=x.device)[:, None] * cap
                out_idx = torch.where(keep, idx * (bg * cap) + first_slot + r["pos"],
                                      n_local * bg * cap)
            out_rows = torch.cat([expert_out.reshape(n_local * bg * cap, d),
                                  torch.zeros(1, d, dtype=dt, device=x.device)])
            picked = out_rows.index_select(0, out_idx.reshape(-1)).view(k_top, bg, s_len, d)
            w = weight.to(dt).to(torch.float32)
            y = reduce((w[..., None] * picked.to(torch.float32)).sum(dim=0), group).to(dt)
        y = y.reshape(b, n_groups * s_len, d)[:, :t_len]

        if collect is not None:
            collect.append(self._aux(r, valid, b, n_groups))
        return y

    def _aux(self, r, valid: torch.Tensor, b: int, n_groups: int):
        """(Switch aux, f_frac) over the valid tokens: of this call, or
        under a ``data_shard`` of the real rows of the global batch."""
        shard = current_data_shard()
        if shard is None:
            n_valid = torch.clamp(valid.sum(), min=1.0)
            f_frac = r["first"].sum(dim=(0, 1)) / n_valid
            p_mean = (r["gates"] * valid[..., None]).sum(dim=(0, 1)) / n_valid
        else:
            rows = shard.row_mask(valid.device).to(torch.float32).repeat_interleave(n_groups)
            w_tok = valid * rows[:, None]
            n_valid = torch.clamp(shard.total(w_tok.sum()), min=1.0)
            f_frac = shard.total((r["first"] * w_tok[..., None]).sum(dim=(0, 1))) / n_valid
            p_mean = reduce((r["gates"] * w_tok[..., None]).sum(dim=(0, 1)),
                            shard.group) / n_valid
        return self.num_experts * (f_frac * p_mean).sum(), f_frac


def upcycle_dense_to_moe(params: Dict, num_experts: int,
                         generator: Optional[torch.Generator] = None,
                         router_scale: float = 1e-2) -> Dict:
    """Sparse upcycling of a dense flax parameter tree (numpy leaves): each
    local block's ``ffn_in`` / ``ffn_out`` tiled into every expert as
    ``moe/{w_in, b_in, w_out, b_out}`` and a router kernel (d, E) of
    router_scale times standard normals drawn from `generator` (a CPU
    ``torch.Generator``; None: seeded with 0). A block already MoE, or
    without an FFN, stays as it is. Every expert starting identical and the
    kept gates summing to 1, the upcycled model's forward is the dense
    model's up to capacity drops. The JAX package draws its router from a
    JAX key: the distribution is the same, the values are not."""
    import numpy as np

    if generator is None:
        generator = torch.Generator().manual_seed(0)
    out = dict(params)
    local = dict(out.get("local_ssm", {}))
    for name in sorted(local):
        if not name.startswith("layers_"):
            continue
        layer = dict(local[name])
        if "moe" in layer or "ffn_in" not in layer:
            continue
        ffn_in, ffn_out = layer.pop("ffn_in"), layer.pop("ffn_out")
        d = ffn_in["kernel"].shape[0]

        def tile(a):
            a = np.asarray(a)
            return np.ascontiguousarray(np.tile(a[None], (num_experts,) + (1,) * a.ndim))

        router = torch.randn(d, num_experts, generator=generator, dtype=torch.float32)
        layer["moe"] = {
            "router": {"kernel": (router_scale * router).numpy()},
            "w_in": tile(ffn_in["kernel"]), "b_in": tile(ffn_in["bias"]),
            "w_out": tile(ffn_out["kernel"]), "b_out": tile(ffn_out["bias"]),
        }
        local[name] = layer
    out["local_ssm"] = local
    return out
