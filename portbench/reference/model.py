"""The plain reference of VELOCITY-ASR: its forward pass in fp32 stock
PyTorch operations, written from the architecture's equations, with no
kernel, cache or batching trick of the measured program.

    mel (B, F, 80) -> strided conv (k 3, stride 2) -> exact GELU -> 2-D
    positional encoding -> LayerNorm -> local SSM blocks -> LayerNorm ->
    global context (adaptive pool, global SSM blocks, pool, cross
    attention, gated fusion) -> LayerNorm -> Linear -> logits (B, L, V)

An SSM block is pre-norm: LN -> causal depthwise conv -> selective SSM
(h[t] = exp(dt A) h[t-1] + dt B x, y = C.h + D x, gated by silu(z)) ->
+ residual; LN -> FFN (exact GELU) or, with experts, the GShard top-k
router with capacity written as one-hot dispatch and combine tensors
(GShard, arXiv:2006.16668; Switch's renormalised kept gates) -> +
residual. The scan is a loop over time in fp32.

Parameters are a flat dict keyed by the module names the architecture
gives them (``param_specs``); the benchmark draws them from its seed and
hands the same dict to the program and to this reference. TF32 must be
off on a card (``run.py`` and the tests set it).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


# ----- the parameters --------------------------------------------------------


def _block_specs(prefix: str, d: int, d_inner: int, n: int, k: int, ffn: Tuple) -> List:
    specs = [
        (f"{prefix}.norm1.weight", (d,), "ln_w"), (f"{prefix}.norm1.bias", (d,), "bias"),
        (f"{prefix}.conv.weight", (d, 1, k), "conv"), (f"{prefix}.conv.bias", (d,), "bias"),
        (f"{prefix}.ssm.A_log", (n,), "a_log"), (f"{prefix}.ssm.D", (d_inner,), "ln_w"),
        (f"{prefix}.ssm.in_proj.weight", (2 * d_inner, d), "dense"),
        (f"{prefix}.ssm.x_proj.weight", (2 * n, d_inner), "dense"),
        (f"{prefix}.ssm.dt_proj.weight", (d_inner, d_inner), "dense"),
        (f"{prefix}.ssm.dt_proj.bias", (d_inner,), "bias"),
        (f"{prefix}.ssm.out_proj.weight", (d, d_inner), "dense"),
        (f"{prefix}.norm2.weight", (d,), "ln_w"), (f"{prefix}.norm2.bias", (d,), "bias"),
    ]
    kind = ffn[0]
    if kind == "dense":
        hidden = ffn[1]
        specs += [(f"{prefix}.ffn_in.weight", (hidden, d), "dense"),
                  (f"{prefix}.ffn_in.bias", (hidden,), "bias"),
                  (f"{prefix}.ffn_out.weight", (d, hidden), "dense"),
                  (f"{prefix}.ffn_out.bias", (d,), "bias")]
    else:
        _, hidden, experts = ffn
        specs += [(f"{prefix}.moe.w_in", (experts, d, hidden), "expert"),
                  (f"{prefix}.moe.b_in", (experts, hidden), "bias"),
                  (f"{prefix}.moe.w_out", (experts, hidden, d), "expert"),
                  (f"{prefix}.moe.b_out", (experts, d), "bias"),
                  (f"{prefix}.moe.router.weight", (experts, d), "dense")]
    return specs


def param_specs(m: dict) -> List[Tuple[str, tuple, str]]:
    """[(name, shape, kind)] of every parameter of the configuration `m`
    (the model keys of a configuration file)."""
    d, mel, v = m["d_model"], m["mel_bins"], m["vocab_size"]
    d_inner = d * m["ssm_expand_ratio"]
    att = m["attention_dim"]
    experts = m.get("moe_experts", 0)
    ffn = ("moe", d_inner, experts) if experts > 0 else ("dense", d_inner)
    specs = [("temporal_binding.conv.weight", (d, mel, 3), "conv"),
             ("temporal_binding.conv.bias", (d,), "bias"),
             ("temporal_binding.pos_encoding.pe_freq", (1, 1, d // 2), "pe"),
             ("temporal_binding.norm.weight", (d,), "ln_w"),
             ("temporal_binding.norm.bias", (d,), "bias")]
    for i in range(m["ssm_layers"]):
        specs += _block_specs(f"local_ssm.layers.{i}", d, d_inner, m["ssm_state_dim"],
                              m["ssm_kernel_size"], ffn)
    specs += [("local_ssm.norm.weight", (d,), "ln_w"), ("local_ssm.norm.bias", (d,), "bias"),
              ("global_context.pool1.pool_proj.weight", (d, d), "dense"),
              ("global_context.pool1.pool_proj.bias", (d,), "bias")]
    for i in range(m["global_ssm_layers"]):
        specs += _block_specs(f"global_context.global_ssm.layers.{i}", d, 2 * d,
                              m["global_ssm_state_dim"], 4, ("dense", 2 * d))
    g = "global_context"
    specs += [(f"{g}.global_ssm.norm.weight", (d,), "ln_w"),
              (f"{g}.global_ssm.norm.bias", (d,), "bias"),
              (f"{g}.pool2.pool_proj.weight", (d, d), "dense"),
              (f"{g}.pool2.pool_proj.bias", (d,), "bias"),
              (f"{g}.norm1.weight", (d,), "ln_w"), (f"{g}.norm1.bias", (d,), "bias"),
              (f"{g}.norm2.weight", (d,), "ln_w"), (f"{g}.norm2.bias", (d,), "bias")]
    for name, shape in (("q_proj", (att, d)), ("k_proj", (att, d)), ("v_proj", (att, d)),
                        ("out_proj", (d, att))):
        specs += [(f"{g}.cross_attention.{name}.weight", shape, "dense"),
                  (f"{g}.cross_attention.{name}.bias", (shape[0],), "bias")]
    for name, shape in (("gate_proj", (d, 2 * d)), ("local_proj", (d, d)),
                        ("global_proj", (d, d)), ("out_proj", (d, d))):
        specs += [(f"{g}.fusion.{name}.weight", shape, "dense"),
                  (f"{g}.fusion.{name}.bias", (d,), "bias")]
    specs += [("ctc_head.norm.weight", (d,), "ln_w"), ("ctc_head.norm.bias", (d,), "bias"),
              ("ctc_head.proj.weight", (v, d), "dense"), ("ctc_head.proj.bias", (v,), "bias")]
    return specs


def _scale_offset(shape: tuple, kind: str) -> Tuple[float, float]:
    """A draw u ~ U(-1, 1) becomes offset + scale * u."""
    if kind == "dense":      # xavier-uniform
        return math.sqrt(6.0 / (shape[0] + shape[1])), 0.0
    if kind == "expert":     # xavier-uniform, the experts counted as receptive field
        return math.sqrt(6.0 / (shape[0] * (shape[1] + shape[2]))), 0.0
    if kind == "conv":       # kaiming (fan_out), as a uniform of the same std
        return math.sqrt(3.0) * math.sqrt(2.0 / (shape[0] * shape[-1])), 0.0
    if kind == "ln_w":
        return 0.1, 1.0
    if kind == "bias":
        return 0.05, 0.0
    if kind == "pe":
        return 0.035, 0.0
    if kind == "a_log":
        return 0.0, 0.0      # set exactly below
    raise ValueError(kind)


@torch.no_grad()
def make_params(m: dict, seed: int, device) -> Params:
    """Every parameter, fp32 on `device`, from one uniform draw of a
    generator on that device seeded by `seed`, scaled leaf by leaf in one
    more pass. ``A_log`` is log(1..N), as the architecture fixes it."""
    specs = param_specs(m)
    sizes = [math.prod(s) for _, s, _ in specs]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    flat = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    so = torch.tensor([_scale_offset(s, k) for _, s, k in specs], dtype=torch.float32,
                      device=device)
    counts = torch.tensor(sizes, device=device)
    flat = (flat * 2.0 - 1.0) * so[:, 0].repeat_interleave(counts) \
        + so[:, 1].repeat_interleave(counts)
    params = {}
    for (name, shape, kind), chunk in zip(specs, flat.split(sizes)):
        t = chunk.view(shape)
        if kind == "a_log":
            t.copy_(torch.log(torch.arange(1, shape[0] + 1, dtype=torch.float32,
                                           device=device)))
        params[name] = t
    return params


# ----- the forward -----------------------------------------------------------


def _ln(x, p, name, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps)


_FP8 = [False]


@contextlib.contextmanager
def fp8_products():
    """Within it, every weight product (each Dense, the experts' matmuls,
    the front conv) takes fp8 (e4m3) operands: the input scaled per row,
    the weight per output channel, each by its largest magnitude over 448,
    rounded to e4m3 (the control: the reference a precision below the
    configuration's bfloat16, as the card's fp8 tensor cores would take
    it). Gradients pass the rounding straight through. Attention, norms
    and the scan stay fp32."""
    _FP8[0] = True
    try:
        yield
    finally:
        _FP8[0] = False


def _q(t, dims):
    """t rounded to the control's fp8 operands, one scale per slice over `dims`."""
    if not _FP8[0]:
        return t
    scale = t.detach().abs().amax(dim=dims, keepdim=True).clamp(min=1e-12) / 448.0
    low = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (low - t.detach()) if t.requires_grad else low


def _dense(x, p, name, bias=True):
    y = _q(x, -1) @ _q(p[f"{name}.weight"], 1).T
    return y + p[f"{name}.bias"] if bias else y


def _dropout(x, rng, rate):
    """flax's dropout: keep with probability 1 - rate, scaled; the mask
    from torch.rand on the generator, as the trainer draws it."""
    if rng is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def _scan_steps(h, x, dt, a, b, c):
    """The recurrence over x's steps from state h: (y without the skip, last h)."""
    ys = []
    for t in range(x.shape[1]):
        h = torch.exp(dt[:, t, :, None] * a) * h + (dt[:, t] * x[:, t])[:, :, None] * b[:, t, None, :]
        ys.append((h * c[:, t, None, :]).sum(-1))
    return torch.stack(ys, dim=1), h


def scan(x, dt, a, b, c, d_skip, segment: int = 64):
    """y[t] = C[t] . h[t] + D x[t], h[t] = exp(dt[t] A) h[t-1] + dt[t] x[t] B[t],
    from h = 0: a loop over time in fp32. x, dt (B, L, Di); a (N,);
    b, c (B, L, N). Under autograd the loop runs in segments of
    `segment` steps whose states are recomputed in the backward
    (``torch.utils.checkpoint``), so a long sequence fits."""
    batch, length, d_inner = x.shape
    h = x.new_zeros(batch, d_inner, a.shape[0])
    if not torch.is_grad_enabled():
        return _scan_steps(h, x, dt, a, b, c)[0] + x * d_skip
    from torch.utils.checkpoint import checkpoint

    ys = []
    for s in range(0, length, segment):
        e = min(length, s + segment)
        y, h = checkpoint(_scan_steps, h, x[:, s:e], dt[:, s:e], a, b[:, s:e], c[:, s:e],
                          use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=1) + x * d_skip


def _selective_ssm(x, p, name):
    xz = _dense(x, p, f"{name}.in_proj", bias=False)
    xi, z = xz.chunk(2, dim=-1)
    bc = _dense(xi, p, f"{name}.x_proj", bias=False)
    b, c = bc.chunk(2, dim=-1)
    dt = F.softplus(_dense(xi, p, f"{name}.dt_proj"))
    a = -torch.exp(p[f"{name}.A_log"])
    y = scan(xi, dt, a, b, c, p[f"{name}.D"])
    return _dense(y * F.silu(z), p, f"{name}.out_proj", bias=False)


def _moe(x, p, name, m, rng, rate):
    """GShard top-k routing over groups of min(128, T) tokens of a row
    (the fold's padding masked), capacity min(S, max(1, ceil(k S f / E)))
    a group, as one-hot dispatch and combine tensors."""
    batch, t_len, d = x.shape
    n_exp, k_top, f = m["moe_experts"], m["moe_top_k"], m["moe_capacity_factor"]
    s = min(128, t_len)
    pad = (-t_len) % s
    g = (t_len + pad) // s
    xg = F.pad(x, (0, 0, 0, pad)).reshape(batch * g, s, d)
    valid = (torch.arange(t_len + pad, device=x.device) < t_len).float()
    valid = valid.expand(batch, -1).reshape(batch * g, s)
    cap = min(s, max(1, math.ceil(k_top * s * f / n_exp)))
    gates = torch.softmax(xg @ p[f"{name}.router.weight"].T, dim=-1)   # (G, S, E)
    remaining = gates.clone()
    counts = torch.zeros(batch * g, 1, n_exp, device=x.device)
    dispatch = torch.zeros(batch * g, s, n_exp, cap, device=x.device)
    gate_kept = []
    choice_masks = []
    for _ in range(k_top):
        choice = F.one_hot(remaining.argmax(-1), n_exp).float() * valid[..., None]
        slot = torch.cumsum(choice, dim=1) - choice + counts           # (G, S, E)
        kept = choice * (slot < cap).float()
        counts = counts + choice.sum(dim=1, keepdim=True)
        remaining = remaining * (1.0 - choice)
        slot_1h = F.one_hot(slot.clamp(max=cap - 1).long(), cap).float()
        dispatch = dispatch + kept[..., None] * slot_1h
        gate_kept.append((gates * kept).sum(-1))
        choice_masks.append(kept[..., None] * slot_1h)
    denom = torch.clamp(sum(gate_kept), min=1e-9)
    combine = sum(gk[..., None, None] / denom[..., None, None] * cm
                  for gk, cm in zip(gate_kept, choice_masks))
    expert_in = torch.einsum("gsec,gsd->egcd", dispatch, xg)
    h = torch.einsum("egcd,edh->egch", _q(expert_in, -1), _q(p[f"{name}.w_in"], 1)) \
        + p[f"{name}.b_in"][:, None, None, :]
    h = _dropout(F.gelu(h), rng, rate)
    out = torch.einsum("egch,ehd->egcd", _q(h, -1), _q(p[f"{name}.w_out"], 1)) \
        + p[f"{name}.b_out"][:, None, None, :]
    y = torch.einsum("gsec,egcd->gsd", combine, out)
    return y.reshape(batch, g * s, d)[:, :t_len]


def _block(x, p, name, kernel, m=None, rng=None, rate=0.0):
    h = _ln(x, p, f"{name}.norm1")
    w = p[f"{name}.conv.weight"]
    h = F.conv1d(F.pad(h.transpose(1, 2), (kernel - 1, 0)), w,
                 groups=w.shape[0]).transpose(1, 2) + p[f"{name}.conv.bias"]
    x = _dropout(_selective_ssm(h, p, f"{name}.ssm"), rng, rate) + x
    h = _ln(x, p, f"{name}.norm2")
    if f"{name}.moe.w_in" in p:
        h = _moe(h, p, f"{name}.moe", m, rng, rate)
    else:
        h = _dense(_dropout(F.gelu(_dense(h, p, f"{name}.ffn_in")), rng, rate), p,
                   f"{name}.ffn_out")
    return _dropout(h, rng, rate) + x


def _pool_matrix(length: int, size: int, device) -> torch.Tensor:
    """Adaptive average pooling: bin i averages [floor(iL/K), ceil((i+1)L/K))."""
    mat = torch.zeros(size, length, device=device)
    for i in range(size):
        lo, hi = (i * length) // size, -(-((i + 1) * length) // size)
        mat[i, lo:hi] = 1.0 / (hi - lo)
    return mat


def _time_encoding(length: int, dim: int, device) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.float64, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float64, device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros(length, dim, dtype=torch.float64, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div[: dim // 2])
    return pe.float()


def forward(p: Params, m: dict, mel: torch.Tensor, rng=None) -> torch.Tensor:
    """fp32 logits (B, (F + 1) // 2, V) of normalised mel (B, F, mel_bins).
    With `rng` (training) dropout draws at every site the architecture
    puts one, in the order a forward reaches them."""
    rate = m["dropout"] if rng is not None else 0.0
    d = m["d_model"]
    g = "global_context"
    x = F.conv1d(_q(mel, -1).transpose(1, 2), _q(p["temporal_binding.conv.weight"], (1, 2)),
                 stride=2, padding=1).transpose(1, 2) + p["temporal_binding.conv.bias"]
    x = F.gelu(x)
    length = x.shape[1]
    pe = torch.cat([_time_encoding(length, d // 2, x.device),
                    p["temporal_binding.pos_encoding.pe_freq"][0].expand(length, d // 2)], -1)
    x = _ln(x + pe, p, "temporal_binding.norm")
    for i in range(m["ssm_layers"]):
        x = _block(x, p, f"local_ssm.layers.{i}", m["ssm_kernel_size"], m, rng, rate)
    local = _ln(x, p, "local_ssm.norm")

    k1 = min(max(64, length // 8), length)
    k2 = min(min(64, max(16, k1 // 4)), k1)
    h = _dense(_pool_matrix(length, k1, x.device) @ local, p, f"{g}.pool1.pool_proj")
    for i in range(m["global_ssm_layers"]):
        h = _block(h, p, f"{g}.global_ssm.layers.{i}", 4, None, rng, rate)
    h = _ln(h, p, f"{g}.global_ssm.norm")
    kv = _ln(_dense(_pool_matrix(k1, k2, x.device) @ h, p, f"{g}.pool2.pool_proj"), p,
             f"{g}.norm1")
    q_in = _ln(local, p, f"{g}.norm2")
    heads, att = m["attention_heads"], m["attention_dim"]
    hd = att // heads

    def split(t):
        return t.reshape(t.shape[0], t.shape[1], heads, hd).transpose(1, 2)

    ca = f"{g}.cross_attention"
    q = split(_dense(q_in, p, f"{ca}.q_proj"))
    k = split(_dense(kv, p, f"{ca}.k_proj"))
    v = split(_dense(kv, p, f"{ca}.v_proj"))
    w = _dropout(torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1), rng, rate)
    ctx = _dense((w @ v).transpose(1, 2).reshape(q.shape[0], length, att), p, f"{ca}.out_proj")
    fu = f"{g}.fusion"
    gate = torch.sigmoid(_dense(torch.cat([local, ctx], -1), p, f"{fu}.gate_proj"))
    fused = _dense(gate * _dense(local, p, f"{fu}.local_proj")
                   + (1 - gate) * _dense(ctx, p, f"{fu}.global_proj"), p, f"{fu}.out_proj")
    return _dense(_dropout(_ln(fused, p, "ctc_head.norm"), rng, rate), p, "ctc_head.proj")
