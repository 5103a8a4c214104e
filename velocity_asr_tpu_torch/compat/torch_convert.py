"""Convert reference PyTorch VELOCITY-ASR checkpoints (a copy of
velocity_asr_tpu/compat/torch_convert.py, numpy only).

The reference state_dict layout maps onto the flax parameter tree that
the JAX package and ``checkpoint.read_params`` use: torch Linear weights
(out, in) become Dense kernels (in, out), Conv1d weights (out,
in/groups, k) become conv kernels (k, in/groups, out), LayerNorm
``weight`` becomes ``scale`` and ``layers.{i}`` becomes ``layers_{i}``.
``checkpoint.params_from_numpy`` then loads the tree into the port's
model (the inverse map). Every tensor must be consumed except the fixed
``pos_encoding.pe_time`` tables, which are recomputed.

    config, tree = load_torch_checkpoint("reference.pt")
    model = create_model(config, device="cuda")
    model.load_state_dict(params_from_numpy(tree), strict=True)
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np


def _linear(sd: Dict[str, np.ndarray], prefix: str, bias: bool = True):
    out = {"kernel": np.ascontiguousarray(sd[f"{prefix}.weight"].T)}
    if bias:
        # raise at the malformed checkpoint, not at a later shape mismatch
        if f"{prefix}.bias" not in sd:
            raise KeyError(
                f"checkpoint is missing expected bias '{prefix}.bias' "
                "(truncated or filtered state_dict?)"
            )
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def _layernorm(sd: Dict[str, np.ndarray], prefix: str):
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


class _ConsumptionTracked(dict):
    """A dict that records the keys read, so the converter can prove the
    whole checkpoint was consumed."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._read: set = set()

    def __getitem__(self, key):
        self._read.add(key)
        return super().__getitem__(key)

    def unconsumed(self):
        return set(self) - self._read


def _ssm_block(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    conv_w = sd[f"{prefix}.conv.weight"]  # (d, 1, k) -> (k, 1, d)
    return {
        "norm1": _layernorm(sd, f"{prefix}.norm1"),
        "norm2": _layernorm(sd, f"{prefix}.norm2"),
        "conv_kernel": np.ascontiguousarray(conv_w.transpose(2, 1, 0)),
        "conv_bias": sd[f"{prefix}.conv.bias"],
        "ssm": {
            "in_proj": _linear(sd, f"{prefix}.ssm.in_proj", bias=False),
            "x_proj": _linear(sd, f"{prefix}.ssm.x_proj", bias=False),
            "dt_proj": _linear(sd, f"{prefix}.ssm.dt_proj"),
            "out_proj": _linear(sd, f"{prefix}.ssm.out_proj", bias=False),
            "A_log": sd[f"{prefix}.ssm.A_log"],
            "D": sd[f"{prefix}.ssm.D"],
        },
        "ffn_in": _linear(sd, f"{prefix}.ffn.0"),
        "ffn_out": _linear(sd, f"{prefix}.ffn.3"),
    }


def convert_torch_state_dict(state_dict: Dict[str, Any], ssm_layers: int = 8,
                             global_ssm_layers: int = 2) -> Dict[str, Any]:
    """A reference state_dict (tensors or ndarrays) as the flax parameter
    tree (numpy leaves); a tensor left unconsumed raises."""
    sd = _ConsumptionTracked({
        k: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
        for k, v in state_dict.items()
    })
    params: Dict[str, Any] = {
        "temporal_binding": {
            "conv_kernel": np.ascontiguousarray(
                sd["temporal_binding.conv.weight"].transpose(2, 1, 0)),
            "conv_bias": sd["temporal_binding.conv.bias"],
            "pos_encoding": {"pe_freq": sd["temporal_binding.pos_encoding.pe_freq"]},
            "norm": _layernorm(sd, "temporal_binding.norm"),
        },
        "local_ssm": {
            **{f"layers_{i}": _ssm_block(sd, f"local_ssm.layers.{i}")
               for i in range(ssm_layers)},
            "norm": _layernorm(sd, "local_ssm.norm"),
        },
        "global_context": {
            "pool1": {"pool_proj": _linear(sd, "global_context.pool1.pool_proj")},
            "pool2": {"pool_proj": _linear(sd, "global_context.pool2.pool_proj")},
            "global_ssm": {
                **{f"layers_{i}": _ssm_block(sd, f"global_context.global_ssm.layers.{i}")
                   for i in range(global_ssm_layers)},
                "norm": _layernorm(sd, "global_context.global_ssm.norm"),
            },
            "cross_attention": {
                name: _linear(sd, f"global_context.cross_attention.{name}")
                for name in ("q_proj", "k_proj", "v_proj", "out_proj")
            },
            "norm1": _layernorm(sd, "global_context.norm1"),
            "norm2": _layernorm(sd, "global_context.norm2"),
            "fusion": {
                "gate_proj": _linear(sd, "global_context.fusion.gate_proj.0"),
                "local_proj": _linear(sd, "global_context.fusion.local_proj"),
                "global_proj": _linear(sd, "global_context.fusion.global_proj"),
                "out_proj": _linear(sd, "global_context.fusion.out_proj"),
            },
        },
        "ctc_head": {
            "norm": _layernorm(sd, "ctc_head.proj.0"),
            "proj": _linear(sd, "ctc_head.proj.2"),
        },
    }
    # every tensor must have landed somewhere (the fixed sinusoidal table
    # is recomputed): a leftover means more layers or modules than the
    # config says, which would give wrong logits with no error
    leftover = sorted(k for k in sd.unconsumed() if not k.endswith(".pos_encoding.pe_time"))
    if leftover:
        raise ValueError(
            f"{len(leftover)} checkpoint tensors were not consumed by the "
            f"conversion (config mismatch?): {leftover[:8]}"
            + ("..." if len(leftover) > 8 else "")
        )
    return params


def load_torch_checkpoint(path: str) -> Tuple[Any, Dict[str, Any]]:
    """(VelocityASRConfig, flax parameter tree) of a reference ``.pt``
    checkpoint: its inference format {config, model_state_dict}, or a bare
    state_dict (the config then inferred from its shapes)."""
    import torch

    from ..models.config import VelocityASRConfig

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        cfg = VelocityASRConfig.from_dict(ckpt.get("config", {}))
        sd = ckpt["model_state_dict"]
    else:
        sd = ckpt
        cfg = _infer_config_from_state_dict(sd, VelocityASRConfig)
    params = convert_torch_state_dict(sd, ssm_layers=cfg.ssm_layers,
                                      global_ssm_layers=cfg.global_ssm_layers)
    return cfg, params


def _infer_config_from_state_dict(sd, config_cls):
    """The architecture read off a bare state_dict's shapes (layer counts,
    widths, state dims, vocabulary); attention_heads, which no shape shows,
    keeps the dataclass default."""

    def shape(key):
        return tuple(sd[key].shape)

    def count_layers(prefix):
        n = 0
        while f"{prefix}.{n}.norm1.weight" in sd:
            n += 1
        return n

    conv = shape("temporal_binding.conv.weight")  # (d_model, mel_bins, k)
    d_model, mel_bins = conv[0], conv[1]
    a_log = shape("local_ssm.layers.0.ssm.A_log")  # (N,)
    in_proj = shape("local_ssm.layers.0.ssm.in_proj.weight")  # (2 * d_inner, d_model)
    block_conv = shape("local_ssm.layers.0.conv.weight")  # (d_model, 1, k)
    kw = dict(
        mel_bins=mel_bins,
        d_model=d_model,
        ssm_layers=count_layers("local_ssm.layers"),
        ssm_state_dim=a_log[0],
        ssm_expand_ratio=max(1, round(in_proj[0] / (2 * d_model))),
        ssm_kernel_size=block_conv[2],
        global_ssm_layers=count_layers("global_context.global_ssm.layers"),
        global_ssm_state_dim=shape("global_context.global_ssm.layers.0.ssm.A_log")[0],
        attention_dim=shape("global_context.cross_attention.q_proj.weight")[0],
        vocab_size=shape("ctc_head.proj.2.weight")[0],
    )
    return config_cls(**{k: int(v) for k, v in kw.items()})
