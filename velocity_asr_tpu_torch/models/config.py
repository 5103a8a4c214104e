"""Model configuration (mirrors velocity_asr_tpu/models/config.py).

The field set and defaults are the JAX package's, so a ``config.json``
written by either package loads in both. ``dtype`` names the compute
dtype; parameters stay float32 and the SSM recurrence always runs in
float32.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict

import torch


@dataclass
class VelocityASRConfig:
    mel_bins: int = 80
    d_model: int = 192
    ssm_layers: int = 8
    ssm_state_dim: int = 64
    ssm_expand_ratio: int = 2
    ssm_kernel_size: int = 4
    global_ssm_layers: int = 2
    global_ssm_state_dim: int = 32
    attention_heads: int = 4
    attention_dim: int = 48
    vocab_size: int = 1000
    dropout: float = 0.1
    gradient_checkpointing: bool = False
    # "sequential" runs the plain time loop; "pallas" (and "parallel",
    # the JAX package's default) run the CUDA selective-scan kernel on a
    # CUDA tensor and its plain version on a CPU tensor (ops/scan.py);
    # "associative", the log-depth scan in stock operations, is for
    # exported graphs only (export.export_graph_config); "sp" shards each
    # scan's time axis over the ranks of an active
    # parallel.sequence_parallel context.
    scan_mode: str = "parallel"
    use_compile: bool = False
    dtype: str = "float32"
    qat: bool = False
    qat_weight_bits: int = 8
    qat_activation_bits: int = 8
    int8_inference: bool = False
    int8_static: bool = False
    stream_summary_tokens: int = 64
    stream_memory_chunks: int = 16
    num_languages: int = 0
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def d_inner(self) -> int:
        return self.d_model * self.ssm_expand_ratio

    @classmethod
    def from_preset(cls, name: str, **overrides) -> "VelocityASRConfig":
        """Named model-family presets (the JAX package's):

        - "tiny": 4 SSM layers at d_model 128, for edge use and smoke runs;
        - "base": the defaults (6.2M parameters, vocabulary 1,000);
        - "large-vocab": the base encoder with a 50,000-token vocabulary
          (the CTC head alone ~9.6M parameters; tensor parallelism shards
          it over the vocabulary);
        - "moe": the base encoder with an 8-expert top-2 MoE FFN in every
          local block (expert parallelism shards the experts).

        `overrides` replace fields after the preset's."""
        presets: Dict[str, Dict[str, Any]] = {
            "tiny": dict(d_model=128, ssm_layers=4, ssm_state_dim=32,
                         global_ssm_layers=1, global_ssm_state_dim=16,
                         attention_dim=32, vocab_size=1000),
            "base": {},
            "large-vocab": dict(vocab_size=50000),
            "moe": dict(moe_experts=8),
        }
        if name not in presets:
            raise ValueError(f"unknown preset {name!r}; options: {sorted(presets)}")
        return cls(**{**presets[name], **overrides})

    @classmethod
    def from_dict(cls, config_dict: Dict[str, Any]) -> "VelocityASRConfig":
        """Create a config from a dict, ignoring unknown keys. The
        reference's "mamba" scan mode maps to "pallas"."""
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in config_dict.items() if k in fields}
        if kwargs.get("scan_mode") == "mamba":
            kwargs["scan_mode"] = "pallas"
        return cls(**kwargs)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)
