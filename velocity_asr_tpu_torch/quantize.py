"""Int8 inference layers (mirrors the int8 half of velocity_asr_tpu/quantize.py).

``DynamicInt8Dense`` is a Dense whose product runs in int8: per-output-
channel weight codes against per-row dynamic activation scales
(``static=False``, the ONNX Runtime ``quantize_dynamic`` analog), or one
calibrated per-tensor scale (``static=True``, the ``quantize_static``
analog). QAT (``FakeQuantize``, ``QuantDense``) is not ported yet.

Weight codes live in non-persistent buffers, computed from the fp32
weight after every ``load_state_dict`` (a post-hook) and after
``create_model``'s init, never in ``__init__``; so ``state_dict`` keys
stay exactly the flax ``params`` tree's. The static path's ``x_amax`` and
``calibrated`` buffers are the flax ``quant_stats`` collection: also
non-persistent, filled by ``calibrate_int8_model`` or by
``load_quant_stats`` from ``checkpoint.quant_stats_from_numpy``.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch
import torch.nn as nn

from .models.layers import Dense
from .ops.int8_matmul import dynamic_int8_dense, quantize_weight, scale_of


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
    reset_quant_stats(model)
    for layer in layers:
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
    """Clear every static int8 layer's x_amax and calibrated flag (their
    state before any calibration)."""
    for layer in _static_layers(model):
        layer.x_amax.zero_()
        layer.calibrated.fill_(False)
    return model


def mark_calibrated(model: nn.Module, value: bool = True) -> nn.Module:
    """Set every static int8 layer's ``calibrated`` flag."""
    for layer in _static_layers(model):
        layer.calibrated.fill_(value)
    return model


@torch.no_grad()
def load_quant_stats(model: nn.Module, stats: Dict[str, torch.Tensor]) -> nn.Module:
    """Copy quant_stats (``x_amax`` / ``calibrated`` per static layer, as
    ``checkpoint.quant_stats_from_numpy`` names them) into the model's
    buffers. Every static layer must be covered and every key used."""
    buffers = {}
    for name, layer in model.named_modules():
        if isinstance(layer, DynamicInt8Dense) and layer.static:
            buffers[f"{name}.x_amax"] = layer.x_amax
            buffers[f"{name}.calibrated"] = layer.calibrated
    if set(stats) != set(buffers):
        raise KeyError(f"quant_stats keys differ: missing {sorted(set(buffers) - set(stats))}, "
                       f"unexpected {sorted(set(stats) - set(buffers))}")
    for key, value in stats.items():
        buffers[key].copy_(value.reshape(()))
    return model
