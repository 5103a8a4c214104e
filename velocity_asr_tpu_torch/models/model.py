"""VELOCITY-ASR model assembly (mirrors velocity_asr_tpu/models/model.py),
offline and streaming, for inference and training.

``create_model`` initialises every parameter from the distributions the
JAX package's ``init_params`` draws from; ``from_pretrained`` reads the
JAX package's checkpoint directory (``config.json`` + flax
``params.msgpack``) with no JAX or flax, and ``save_pretrained`` writes
one that the JAX package's ``from_pretrained`` reads. ``module.train()``
turns dropout on; its masks come from the generator passed as ``rng``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch
import torch.nn as nn

from ..checkpoint import params_from_numpy, params_to_numpy, read_params, write_params
from ..device import resolve_device
from ..ops.pooling import adaptive_avg_pool1d
from .attention import HierarchicalGlobalContext
from .config import VelocityASRConfig
from .layers import CTCOutputHead, PositionalEncoding2D, TemporalBindingLayer
from .ssm import LocalSSMProcessor, SelectiveSSM

PARAMS_FILE = "params.msgpack"
CONFIG_FILE = "config.json"

# Options of the JAX package that this port does not implement yet: a
# config that sets one must not load as a model that silently ignores it.
_UNSUPPORTED = {"qat": False, "moe_experts": 0, "num_languages": 0}


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
            cfg.ssm_kernel_size, cfg.scan_mode, dtype, cfg.dropout,
            checkpoint=cfg.gradient_checkpointing,
        )
        int8 = {"int8": cfg.int8_inference, "int8_static": cfg.int8_static}
        self.global_context = HierarchicalGlobalContext(
            cfg.d_model, cfg.attention_heads, cfg.attention_dim, cfg.global_ssm_layers,
            cfg.global_ssm_state_dim, cfg.scan_mode, dtype, dropout=cfg.dropout, **int8,
        )
        self.ctc_head = CTCOutputHead(cfg.d_model, cfg.vocab_size, dtype, dropout=cfg.dropout,
                                      **int8)

    def forward(self, mel_spectrogram: torch.Tensor, stream_state: Optional[dict] = None,
                time_offset=0, return_state: bool = False, frozen_mem: bool = False,
                return_features: bool = False, rng: Optional[torch.Generator] = None):
        """(batch, frames, mel_bins) -> fp32 logits (batch, (frames+1)//2, vocab)
        [, features dict] offline. In training mode both forwards apply
        dropout with masks from `rng` (a ``torch.Generator`` on the model's
        device), at the JAX package's sites.

        Streaming (``stream_state`` given or ``return_state``): one chunk
        of an even number of frames, its first output frame at
        ``time_offset`` (an int, or a (batch,) tensor: one offset per row,
        the independent sessions of a shared step). The local path carries its state exactly; the
        chunk's local features pool to ``stream_summary_tokens`` summary
        tokens that advance the global context's SSM and rolling memory
        (``HierarchicalGlobalContext``). With ``return_state`` it returns
        (logits, new state), the state a dict with the keys of
        ``streaming.init_stream_state``, every leaf fp32 (``gc_init``
        bool) and, under autograd, in the graph: the streaming-aware
        objective differentiates through the carried state
        (``streaming.streaming_forward``). ``frozen_mem`` is the lookahead
        emit pass: the global
        context attends over ``stream_state["gc_mem"]`` as given and the
        gc_* leaves echo the inputs, while the local state still advances
        (a caller re-decoding an old chunk discards it).
        """
        cfg = self.config
        streaming = return_state or stream_state is not None
        if frozen_mem and stream_state is None:
            raise ValueError(
                "frozen_mem requires a stream_state produced by at least "
                "one advancing streaming step"
            )
        if not streaming:
            x = self.temporal_binding(mel_spectrogram)
            local_features = self.local_ssm(x, rng=rng)
            fused_features = self.global_context(local_features, rng=rng)
            logits = self.ctc_head(fused_features, rng=rng).to(torch.float32)
            if return_features:
                return logits, {
                    "temporal_binding": x,
                    "local_features": local_features,
                    "fused_features": fused_features,
                }
            return logits

        state = stream_state or init_stream_state(cfg, mel_spectrogram.shape[0],
                                                  mel_spectrogram.device)
        x, mel_carry = self.temporal_binding(
            mel_spectrogram, carry=state["mel_carry"], time_offset=time_offset,
            return_carry=True)
        local_features, block_states = self.local_ssm(x, state["blocks"], return_state=True,
                                                      rng=rng)
        summary = adaptive_avg_pool1d(local_features.to(torch.float32),
                                      cfg.stream_summary_tokens)
        gc_state = {"mem": state["gc_mem"], "blocks": state["gc_blocks"],
                    "init": state["gc_init"]}
        fused_features, new_gc = self.global_context(local_features, summary=summary,
                                                     gc_state=gc_state, frozen=frozen_mem,
                                                     rng=rng)
        logits = self.ctc_head(fused_features, rng=rng).to(torch.float32)
        if not return_state:
            return logits
        return logits, {
            "mel_carry": mel_carry.to(torch.float32),  # the mel's dtype otherwise
            "blocks": block_states,
            "gc_mem": new_gc["mem"],
            "gc_blocks": new_gc["blocks"],
            "gc_init": new_gc["init"],
        }

    @staticmethod
    def get_output_length(input_length: int) -> int:
        """Stride-2 temporal binding halves the frames."""
        return (input_length + 1) // 2


def init_stream_state(cfg: VelocityASRConfig, batch: int, device="cpu") -> dict:
    """Fresh carried state for `batch` independent streams, fp32 on
    `device` (the JAX package's ``streaming.init_stream_state``): the mel
    carry, per local block its conv tail and scan state (batch, d_inner,
    N), the global memory, per global block the same (expand 2, kernel 4,
    fixed as in the JAX package), and per row whether its memory is warm."""
    def zeros(*shape):
        return torch.zeros(*shape, dtype=torch.float32, device=device)

    k = cfg.ssm_kernel_size
    return {
        "mel_carry": zeros(batch, 1, cfg.mel_bins),
        "blocks": [{"conv": zeros(batch, k - 1, cfg.d_model),
                    "ssm": zeros(batch, cfg.d_inner, cfg.ssm_state_dim)}
                   for _ in range(cfg.ssm_layers)],
        "gc_mem": zeros(batch, cfg.stream_memory_chunks * cfg.stream_summary_tokens,
                        cfg.d_model),
        "gc_blocks": [{"conv": zeros(batch, 3, cfg.d_model),
                       "ssm": zeros(batch, 2 * cfg.d_model, cfg.global_ssm_state_dim)}
                      for _ in range(cfg.global_ssm_layers)],
        "gc_init": torch.zeros(batch, dtype=torch.bool, device=device),
    }


def _empty_model(config: VelocityASRConfig, device) -> VelocityASR:
    """A model whose parameters are allocated on `device` but not written;
    the int8 layers' calibration statistics start cleared."""
    from ..quantize import reset_quant_stats

    device = resolve_device(device)
    with torch.device("meta"):
        model = VelocityASR(config)
    return reset_quant_stats(model.to_empty(device=device)).eval()


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter as the JAX package's ``init_params`` draws it:

    - Dense kernels xavier-uniform (bound sqrt(6 / (in + out))), biases 0;
    - conv kernels kaiming-normal, fan_out = out * k, std sqrt(2 / fan_out),
      biases 0 (``layers.kaiming_conv_init``);
    - ``A_log = log(1..N)`` and ``D = 1`` in every SelectiveSSM;
    - LayerNorm weight 1 and bias 0; ``pe_freq`` normal with std 0.02.

    The draws come from `generator` (a CPU generator, so the tensors must
    be on the CPU): the distributions are JAX's, the values are not.
    Int8 layers then recompute their weight codes.
    """
    from ..quantize import DynamicInt8Dense

    for module in model.modules():
        if isinstance(module, nn.Linear):
            nn.init.xavier_uniform_(module.weight, generator=generator)
            if module.bias is not None:
                nn.init.zeros_(module.bias)
        elif isinstance(module, nn.Conv1d):
            nn.init.kaiming_normal_(module.weight, mode="fan_out", nonlinearity="relu",
                                    generator=generator)
            nn.init.zeros_(module.bias)
        elif isinstance(module, nn.LayerNorm):
            nn.init.ones_(module.weight)
            nn.init.zeros_(module.bias)
        elif isinstance(module, SelectiveSSM):
            n = module.A_log.shape[0]
            module.A_log.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32)))
            nn.init.ones_(module.D)
        elif isinstance(module, PositionalEncoding2D):
            nn.init.normal_(module.pe_freq, std=0.02, generator=generator)
    for module in model.modules():
        if isinstance(module, DynamicInt8Dense):
            module.requantize()
    return model


def create_model(config: Optional[VelocityASRConfig] = None, device="cuda",
                 generator: Optional[torch.Generator] = None) -> VelocityASR:
    """A freshly initialised model on `device` (``init_parameters``).

    Randomness comes from `generator`, a CPU ``torch.Generator``; None
    means one seeded with 0, so two calls give the same weights.
    """
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = init_parameters(_empty_model(config or VelocityASRConfig(), "cpu"), generator)
    return model.to(device)


@torch.inference_mode()
def forward(model: VelocityASR, mel: torch.Tensor, return_features: bool = False):
    """Inference forward pass (no gradients; dropout is never applied)."""
    return model(mel, return_features=return_features)


def save_pretrained(path: str, config: VelocityASRConfig, model: nn.Module,
                    extra: Optional[dict] = None) -> None:
    """Write ``config.json`` ({"config": ..., **extra}) and a flax-format
    ``params.msgpack`` of `model`'s parameters into the directory `path`:
    what the JAX package's ``save_pretrained`` writes, so both packages'
    ``from_pretrained`` read it."""
    os.makedirs(path, exist_ok=True)
    payload = {"config": config.to_dict()}
    if extra:
        payload.update(extra)
    with open(os.path.join(path, CONFIG_FILE), "w") as f:
        json.dump(payload, f, indent=2)
    write_params(os.path.join(path, PARAMS_FILE), params_to_numpy(model))


def from_pretrained(path: str, device="cuda", **overrides) -> VelocityASR:
    """Load ``config.json`` + ``params.msgpack`` from a local directory.
    `overrides` replace config fields (e.g. scan_mode, dtype)."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"checkpoint directory not found: {path!r}")
    with open(os.path.join(path, CONFIG_FILE)) as f:
        payload = json.load(f)
    cfg_dict = dict(payload.get("config", {}))
    cfg_dict.update(overrides)
    model = _empty_model(VelocityASRConfig.from_dict(cfg_dict), device)
    tree = read_params(os.path.join(path, PARAMS_FILE))
    model.load_state_dict(params_from_numpy(tree), strict=True)
    return model
