"""VELOCITY-ASR model assembly (mirrors velocity_asr_tpu/models/model.py),
offline inference only.

``from_pretrained`` reads the JAX package's checkpoint directory
(``config.json`` + flax ``params.msgpack``) with no JAX or flax.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch
import torch.nn as nn

from ..checkpoint import params_from_numpy, read_params
from ..device import resolve_device
from .attention import HierarchicalGlobalContext
from .config import VelocityASRConfig
from .layers import CTCOutputHead, TemporalBindingLayer
from .ssm import LocalSSMProcessor

PARAMS_FILE = "params.msgpack"
CONFIG_FILE = "config.json"

# Options of the JAX package that this port does not implement yet: a
# config that sets one must not load as a model that silently ignores it.
_UNSUPPORTED = {
    "qat": False, "int8_inference": False, "int8_static": False,
    "moe_experts": 0, "num_languages": 0,
}


class VelocityASR(nn.Module):
    """TemporalBinding -> LocalSSM -> HierarchicalGlobalContext -> CTC head."""

    def __init__(self, config: VelocityASRConfig):
        super().__init__()
        for name, default in _UNSUPPORTED.items():
            if getattr(config, name) != default:
                raise NotImplementedError(
                    f"{name}={getattr(config, name)!r} is not ported yet"
                )
        self.config = cfg = config
        dtype = cfg.compute_dtype
        self.temporal_binding = TemporalBindingLayer(cfg.mel_bins, cfg.d_model, dtype=dtype)
        self.local_ssm = LocalSSMProcessor(
            cfg.d_model, cfg.ssm_layers, cfg.ssm_state_dim, cfg.ssm_expand_ratio,
            cfg.ssm_kernel_size, cfg.scan_mode, dtype,
        )
        self.global_context = HierarchicalGlobalContext(
            cfg.d_model, cfg.attention_heads, cfg.attention_dim, cfg.global_ssm_layers,
            cfg.global_ssm_state_dim, cfg.scan_mode, dtype,
        )
        self.ctc_head = CTCOutputHead(cfg.d_model, cfg.vocab_size, dtype)

    def forward(self, mel_spectrogram: torch.Tensor, return_features: bool = False):
        """(batch, frames, mel_bins) -> fp32 logits (batch, (frames+1)//2, vocab)
        [, features dict]."""
        x = self.temporal_binding(mel_spectrogram)
        local_features = self.local_ssm(x)
        fused_features = self.global_context(local_features)
        logits = self.ctc_head(fused_features).to(torch.float32)
        if return_features:
            return logits, {
                "temporal_binding": x,
                "local_features": local_features,
                "fused_features": fused_features,
            }
        return logits

    @staticmethod
    def get_output_length(input_length: int) -> int:
        """Stride-2 temporal binding halves the frames."""
        return (input_length + 1) // 2


def create_model(config: Optional[VelocityASRConfig] = None,
                 device="cuda") -> VelocityASR:
    """An uninitialised model on `device`: load weights with
    ``load_state_dict(checkpoint.params_from_numpy(tree))`` or use
    ``from_pretrained``."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = VelocityASR(config or VelocityASRConfig())
    return model.to_empty(device=device).eval()


@torch.inference_mode()
def forward(model: VelocityASR, mel: torch.Tensor, return_features: bool = False):
    """Inference forward pass (no gradients; dropout is never applied)."""
    return model(mel, return_features=return_features)


def from_pretrained(path: str, device="cuda", **overrides) -> VelocityASR:
    """Load ``config.json`` + ``params.msgpack`` from a local directory.
    `overrides` replace config fields (e.g. scan_mode, dtype)."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"checkpoint directory not found: {path!r}")
    with open(os.path.join(path, CONFIG_FILE)) as f:
        payload = json.load(f)
    cfg_dict = dict(payload.get("config", {}))
    cfg_dict.update(overrides)
    model = create_model(VelocityASRConfig.from_dict(cfg_dict), device)
    tree = read_params(os.path.join(path, PARAMS_FILE))
    model.load_state_dict(params_from_numpy(tree), strict=True)
    return model
