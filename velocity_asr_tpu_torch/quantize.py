"""Quantization-aware training and int8 inference layers (mirrors
velocity_asr_tpu/quantize.py).

QAT: ``FakeQuantize`` fake-quantizes a tensor with a straight-through
gradient, ``x + (x_dq - x).detach()``. Its observers are non-persistent
buffers in the flax ``quant_stats`` layout: ``scale`` and ``zero_point``
((1, out) for a Dense kernel, (1, 1, out) for a conv kernel, () per
tensor), ``calibrated`` (a bool scalar) and the calibration range
``range_min`` / ``range_max`` (+inf / -inf until something is observed).
In training mode it recomputes scale and zero point from the live tensor
on every forward, with no EMA (over a mesh, from the range of the whole
tensor the JAX observer sees: ``FakeQuantize.groups``); while
``calibrating`` it accumulates the
range across batches; in eval mode it reads the stored stats and passes x
through unchanged until ``calibrated``. Weights are symmetric per output
channel, activations asymmetric per tensor with a fractional zero point
(``qmin - x_min / scale``), rounded half to even. ``QuantDense`` and
``QuantConv1d`` quantize their weight and their output;
``prepare_model_for_qat`` turns a model config into its QAT config, in
which the projections outside the SSM blocks and the temporal-binding
conv use them (the ``ssm_state_fp32`` rule keeps every SSM-block
projection in float).

Int8 inference: ``DynamicInt8Dense`` is a Dense whose product runs in
int8: per-output-channel weight codes against per-row dynamic activation
scales (``static=False``, the ONNX Runtime ``quantize_dynamic`` analog),
or one calibrated per-tensor scale (``static=True``, the
``quantize_static`` analog). Weight codes live in non-persistent buffers,
computed from the fp32 weight after every ``load_state_dict`` (a
post-hook) and after ``create_model``'s init, never in ``__init__``; so
``state_dict`` keys stay exactly the flax ``params`` tree's. The static
path's ``x_amax`` and ``calibrated`` buffers are its ``quant_stats``.

Where the JAX package passes a ``quant_stats`` tree, the port keeps the
stats in the model's buffers: ``quant_stats_to_numpy`` writes them as the
flax tree and ``load_quant_stats`` (with
``checkpoint.quant_stats_from_numpy``) reads one back.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .models.layers import Dense
from .parallel.mesh import DATA_AXIS, all_reduce_
from .ops.conv import strided_conv1d
from .ops.int8_matmul import dynamic_int8_dense, quantize_weight, scale_of

OBSERVERS = ("scale", "zero_point", "calibrated", "range_min", "range_max")
MIN_SCALE = 1e-10


@dataclass
class QuantizationConfig:
    """Quantization settings (the JAX package's, with its defaults)."""

    weight_bits: int = 8
    activation_bits: int = 8
    per_channel_weights: bool = True
    ssm_state_fp32: bool = True
    num_calibration_batches: int = 100
    symmetric_weights: bool = True
    symmetric_activations: bool = False


class FakeQuantize(nn.Module):
    """Fake quantization with a straight-through gradient.

    `channel_dim` is the channel's dim in the tensor the module sees (a
    torch weight's output dim, 0) and `stat_shape` the per-channel stats'
    flax shape; per tensor the stats are scalars. Arithmetic is the JAX
    module's: ranges in fp32, scale = max(|min|, |max|) / qmax
    (symmetric) or (max - min) / (qmax - qmin) with zero point qmin - min
    / max(scale, 1e-10) (asymmetric), scale floored at 1e-10, every
    division by a tensor (IEEE on every device); x_dq = (clip(round(x /
    scale + zp)) - zp) * scale in fp32, cast to x's dtype, and the STE
    sum formed in x's dtype.

    ``groups`` ({mesh axis: process group}) names the process groups whose
    ranks together hold the tensor the JAX observer sees, where this rank
    holds a part of it: in training mode the range is reduced over each
    (one MAX all-reduce of (max, -min) a group, in axis order: exact, so
    every rank ends with the same stats). ``observe_over`` and
    ``parallel.tp.shard_params_tp`` set them; calibration and evaluation
    reduce nothing.
    """

    def __init__(self, bits: int = 8, symmetric: bool = True, per_channel: bool = False,
                 channel_dim: int = 0, stat_shape: Tuple[int, ...] = ()):
        super().__init__()
        if per_channel and not stat_shape:
            raise ValueError("a per-channel FakeQuantize needs its stats' shape")
        self.bits = bits
        self.symmetric = symmetric
        self.per_channel = per_channel
        self.channel_dim = channel_dim
        self.stat_shape = tuple(stat_shape) if per_channel else ()
        self.qmin, self.qmax = ((-(2 ** (bits - 1)), 2 ** (bits - 1) - 1) if symmetric
                                else (0, 2 ** bits - 1))
        self.calibrating = False
        self.groups: Dict[str, Any] = {}
        shape = self.stat_shape
        self.register_buffer("scale", torch.ones(shape), persistent=False)
        self.register_buffer("zero_point", torch.zeros(shape), persistent=False)
        self.register_buffer("calibrated", torch.zeros((), dtype=torch.bool), persistent=False)
        self.register_buffer("range_min", torch.full(shape, float("inf")), persistent=False)
        self.register_buffer("range_max", torch.full(shape, float("-inf")), persistent=False)

    @torch.no_grad()
    def reset(self) -> None:
        """The stats before anything was observed (``init_quant_stats``)."""
        self.scale.fill_(1.0)
        self.zero_point.zero_()
        self.calibrated.fill_(False)
        self.reset_ranges()

    @torch.no_grad()
    def reset_ranges(self) -> None:
        self.range_min.fill_(float("inf"))
        self.range_max.fill_(float("-inf"))

    def _ranges(self, x: torch.Tensor):
        """(min, max) of x, per channel in the stats' shape (that of the
        buffers: a tensor-parallel slice's holds its channels only)."""
        v = x.detach().to(torch.float32)
        if not self.per_channel:
            return v.amin(), v.amax()
        dims = [d for d in range(v.dim()) if d != self.channel_dim % v.dim()]
        return (v.amin(dim=dims).reshape(self.scale.shape),
                v.amax(dim=dims).reshape(self.scale.shape))

    def _global_ranges(self, x: torch.Tensor):
        """``_ranges`` over the ranks of every group in ``groups``."""
        x_min, x_max = self._ranges(x)
        if not self.groups:
            return x_min, x_max
        pair = torch.stack([x_max, -x_min])
        for axis in sorted(self.groups):
            all_reduce_(pair, self.groups[axis], op=torch.distributed.ReduceOp.MAX)
        return -pair[1], pair[0]

    def _scale_zp(self, x_min: torch.Tensor, x_max: torch.Tensor):
        def const(value):
            return torch.full((), float(value), dtype=torch.float32, device=x_min.device)

        if self.symmetric:
            scale = torch.maximum(x_min.abs(), x_max.abs()) / const(self.qmax)
            zp = torch.zeros_like(scale)
        else:
            scale = (x_max - x_min) / const(self.qmax - self.qmin)
            zp = self.qmin - x_min / torch.clamp_min(scale, MIN_SCALE)
        return torch.clamp_min(scale, MIN_SCALE), zp

    def _broadcast(self, stat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """A stat laid out along x's channel dim."""
        if not self.per_channel:
            return stat
        shape = [1] * x.dim()
        shape[self.channel_dim % x.dim()] = -1
        return stat.reshape(shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            # refreshed from the live tensor every training forward (no EMA)
            scale, zp = self._scale_zp(*self._global_ranges(x))
            with torch.no_grad():
                self.scale.copy_(scale)
                self.zero_point.copy_(zp)
        elif self.calibrating:
            x_min, x_max = self._ranges(x)
            with torch.no_grad():
                self.range_min.copy_(torch.minimum(self.range_min, x_min))
                self.range_max.copy_(torch.maximum(self.range_max, x_max))
                scale, zp = self._scale_zp(self.range_min, self.range_max)
                self.scale.copy_(scale)
                self.zero_point.copy_(zp)
        else:
            scale, zp = self.scale, self.zero_point
        scale, zp = self._broadcast(scale, x), self._broadcast(zp, x)
        x_q = torch.clamp(torch.round(x.to(torch.float32) / scale + zp), self.qmin, self.qmax)
        x_dq = ((x_q - zp) * scale).to(x.dtype)
        fq = x + (x_dq - x).detach()
        if self.training or self.calibrating:
            return fq
        return torch.where(self.calibrated, fq, x)  # pass-through until calibrated


class QuantDense(Dense):
    """Dense with a fake-quantized weight (symmetric, per output channel)
    and output (asymmetric, per tensor): x @ fq(W) + b, then fq."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, weight_bits: int = 8,
                 activation_bits: int = 8):
        super().__init__(in_features, out_features, bias=bias, dtype=dtype)
        self.weight_quantizer = FakeQuantize(weight_bits, symmetric=True, per_channel=True,
                                             channel_dim=0, stat_shape=(1, out_features))
        self.activation_quantizer = FakeQuantize(activation_bits, symmetric=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = torch.matmul(x.to(dt), self.weight_quantizer(self.weight).to(dt).T)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return self.activation_quantizer(y)


class QuantConv1d(nn.Conv1d):
    """Strided Conv1d (``strided_conv1d``) with a fake-quantized weight and
    output. Its flax parameters are ``conv/{kernel,bias}`` (``flax_nested``),
    not the float binding's ``conv_kernel`` / ``conv_bias``."""

    flax_nested = True

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, dtype: torch.dtype = torch.float32,
                 weight_bits: int = 8, activation_bits: int = 8):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding)
        self.compute_dtype = dtype
        self.weight_quantizer = FakeQuantize(weight_bits, symmetric=True, per_channel=True,
                                             channel_dim=0, stat_shape=(1, 1, out_channels))
        self.activation_quantizer = FakeQuantize(activation_bits, symmetric=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = strided_conv1d(x.to(self.compute_dtype), self.weight_quantizer(self.weight),
                           self.bias, stride=self.stride[0], padding=self.padding[0])
        return self.activation_quantizer(y)


def prepare_model_for_qat(config, quant_config: Optional[QuantizationConfig] = None):
    """The QAT config of a model config: qat on, bit widths from
    `quant_config`. The QAT layers implement the default scheme only, so a
    non-default value of an untunable field raises."""
    qc = quant_config or QuantizationConfig()
    defaults = QuantizationConfig()
    for field in ("per_channel_weights", "symmetric_weights",
                  "symmetric_activations", "ssm_state_fp32"):
        if getattr(qc, field) != getattr(defaults, field):
            raise NotImplementedError(
                f"QuantizationConfig.{field}={getattr(qc, field)} is not "
                "supported: the QAT layers implement the reference's "
                "default scheme only (see QuantDense/QuantConv1d)"
            )
    return dataclasses.replace(config, qat=True, qat_weight_bits=qc.weight_bits,
                               qat_activation_bits=qc.activation_bits)


def fake_quantizers(model: nn.Module):
    return [m for m in model.modules() if isinstance(m, FakeQuantize)]


def observe_over(model: nn.Module, data_group) -> nn.Module:
    """Every per-tensor observer of `model` reduces its training range
    over `data_group`, the process group of the mesh's data axis, where
    each rank holds its rows of the global batch (None: over no data
    group), in place. Per-channel weight observers see whole channels on
    every rank and reduce nothing."""
    for fq in fake_quantizers(model):
        if fq.per_channel:
            continue
        if data_group is None:
            fq.groups.pop(DATA_AXIS, None)
        else:
            fq.groups[DATA_AXIS] = data_group
    return model


@torch.no_grad()
def init_quant_stats(model: nn.Module) -> nn.Module:
    """Every observer at its initial value (scale 1, zero point 0, not
    calibrated, no range)."""
    for fq in fake_quantizers(model):
        fq.reset()
    return model


@torch.no_grad()
def reset_calibration_ranges(model: nn.Module) -> nn.Module:
    """Every observer's calibration range back to (+inf, -inf)."""
    for fq in fake_quantizers(model):
        fq.reset_ranges()
    return model


@torch.no_grad()
def calibrate_model(model: nn.Module, batches: Iterable, num_batches: int = 100) -> nn.Module:
    """Calibrate a QAT model's observers in place: the ranges restart,
    eval forwards over up to `num_batches` mel batches ((batch, frames,
    mel_bins) arrays or tensors) accumulate them, dropout off, and every
    flag is then set. Returns the model."""
    quantizers = fake_quantizers(model)
    if not quantizers:
        raise ValueError("no FakeQuantize observers: build the model with qat=True "
                         "(prepare_model_for_qat)")
    device = next(model.parameters()).device
    was_training = model.training
    reset_calibration_ranges(model)
    model.eval()
    for fq in quantizers:
        fq.calibrating = True
    count = 0
    try:
        for batch in batches:
            if count >= num_batches:
                break
            model(torch.as_tensor(batch, dtype=torch.float32, device=device))
            count += 1
    finally:
        for fq in quantizers:
            fq.calibrating = False
        model.train(was_training)
    if count == 0:
        # marking never-observed stats (scale 1, zp 0) as calibrated would
        # clip every negative activation to zero
        raise ValueError("no calibration batches provided")
    return mark_calibrated(model)


def get_model_size_mb(model: nn.Module, bits_per_param: int = 32) -> float:
    """Size in MB of a model's parameters at `bits_per_param` bits each."""
    return sum(p.numel() for p in model.parameters()) * (bits_per_param / 8) / (1024 * 1024)


def _requantize_after_load(module, incompatible_keys) -> None:
    module.requantize()


class DynamicInt8Dense(Dense):
    """Dense with int8 weights and int8 activations.

    static=False: each row of the input gets its own scale, so co-batched
    utterances never change each other's grid.

    static=True: the activation scale is max(x_amax / 127, 1e-10) from a
    calibrated running max-abs. While ``calibrating`` the layer is the
    plain Dense in the compute dtype and accumulates x_amax; until
    ``calibrated`` it falls back to one dynamic scale for the whole tensor
    (not per row), as the JAX package does.
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, static: bool = False):
        super().__init__(in_features, out_features, bias=bias, dtype=dtype)
        self.static = static
        self.calibrating = False
        self.register_buffer("w_q", torch.empty(out_features, in_features, dtype=torch.int8),
                             persistent=False)
        self.register_buffer("w_scale", torch.empty(out_features), persistent=False)
        if static:
            self.register_buffer("x_amax", torch.zeros(()), persistent=False)
            self.register_buffer("calibrated", torch.zeros((), dtype=torch.bool),
                                 persistent=False)
        self.register_load_state_dict_post_hook(_requantize_after_load)

    @torch.no_grad()
    def requantize(self) -> None:
        """Recompute the weight codes from the current fp32 weight."""
        w_q, w_scale = quantize_weight(self.weight)
        self.w_q.copy_(w_q)
        self.w_scale.copy_(w_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.calibrating:
            amax = x.detach().to(torch.float32).abs().amax()
            self.x_amax.copy_(torch.maximum(self.x_amax, amax))
            dt = self.compute_dtype
            y = torch.matmul(x.to(dt), self.weight.to(dt).T)
            return y if self.bias is None else y + self.bias.to(dt)
        x_scale = None
        if self.static:
            x_scale = scale_of(torch.where(self.calibrated, self.x_amax,
                                           x.detach().to(torch.float32).abs().amax()))
        return dynamic_int8_dense(x, self.w_q, self.w_scale, self.bias, x_scale)


def _static_layers(model: nn.Module):
    return [m for m in model.modules() if isinstance(m, DynamicInt8Dense) and m.static]


@torch.no_grad()
def calibrate_int8_model(model: nn.Module, batches: Iterable, num_batches: int = 100):
    """Calibrate a static-int8 model's activation scales in place.

    The model must be built with int8_inference=True, int8_static=True.
    Every x_amax restarts from 0, then eval forwards over up to
    `num_batches` mel batches ((batch, frames, mel_bins) arrays or
    tensors) accumulate each layer's running max-abs (MinMax
    calibration); the flags are then set. Returns the model.
    """
    layers = _static_layers(model)
    if not layers:
        raise ValueError("no static int8 layers: build the model with "
                         "int8_inference=True, int8_static=True")
    device = next(model.parameters()).device
    for layer in layers:
        layer.x_amax.zero_()
        layer.calibrated.fill_(False)
        layer.calibrating = True
    count = 0
    try:
        for batch in batches:
            if count >= num_batches:
                break
            model(torch.as_tensor(batch, dtype=torch.float32, device=device))
            count += 1
    finally:
        for layer in layers:
            layer.calibrating = False
    if count == 0:
        raise ValueError("no calibration batches provided")
    return mark_calibrated(model)


@torch.no_grad()
def reset_quant_stats(model: nn.Module) -> nn.Module:
    """Every quantization stat at its state before any calibration: each
    static int8 layer's x_amax 0 and flag off, each observer as
    ``init_quant_stats`` leaves it."""
    for layer in _static_layers(model):
        layer.x_amax.zero_()
        layer.calibrated.fill_(False)
    return init_quant_stats(model)


@torch.no_grad()
def mark_calibrated(model: nn.Module, value: bool = True) -> nn.Module:
    """Set every ``calibrated`` flag: each observer's and each static
    int8 layer's."""
    for module in fake_quantizers(model) + _static_layers(model):
        module.calibrated.fill_(value)
    return model


def quant_stats_buffers(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every quantization stat of the model by buffer name, in module
    order: each observer's ``OBSERVERS`` and each static int8 layer's
    ``x_amax`` and ``calibrated`` (the flax ``quant_stats`` leaves)."""
    out = {}
    for name, module in model.named_modules():
        if isinstance(module, FakeQuantize):
            keys = OBSERVERS
        elif isinstance(module, DynamicInt8Dense) and module.static:
            keys = ("x_amax", "calibrated")
        else:
            continue
        for key in keys:
            out[f"{name}.{key}"] = getattr(module, key)
    return out


def quant_stats_to_numpy(model: nn.Module) -> Dict[str, Any]:
    """The model's quantization stats as the flax ``quant_stats`` tree
    (nested dicts of 0-d or flax-shaped numpy arrays; ``layers.i`` becomes
    ``layers_i``), what ``checkpoint.write_msgpack`` writes as the JAX
    package's ``quant_stats.msgpack``."""
    tree: Dict[str, Any] = {}
    for name, value in quant_stats_buffers(model).items():
        parts = name.split(".")
        path = []
        i = 0
        while i < len(parts) - 1:
            if parts[i] == "layers" and parts[i + 1].isdigit():
                path.append(f"layers_{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[parts[-1]] = np.array(value.detach().cpu().numpy())
    return tree


@torch.no_grad()
def load_quant_stats(model: nn.Module, stats: Dict[str, torch.Tensor]) -> nn.Module:
    """Copy quantization stats (by buffer name, as
    ``checkpoint.quant_stats_from_numpy`` names them) into the model's
    buffers. Every stat must be covered and every key used."""
    buffers = quant_stats_buffers(model)
    if set(stats) != set(buffers):
        raise KeyError(f"quant_stats keys differ: missing {sorted(set(buffers) - set(stats))}, "
                       f"unexpected {sorted(set(stats) - set(buffers))}")
    for key, value in stats.items():
        buffers[key].copy_(torch.as_tensor(value).reshape(buffers[key].shape))
    return model
