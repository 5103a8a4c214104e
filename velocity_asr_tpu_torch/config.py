"""YAML config loading (mirrors velocity_asr_tpu/utils/config.py).

``load_yaml`` reads the subset of YAML that ``configs/*.yaml`` use, with
no YAML package: nested maps by indentation, plain scalars (integers,
floats, booleans, null and strings as YAML 1.1 resolves them, the way
PyYAML's ``safe_load`` does), inline lists ``[a, b]`` and comments.
Anything else (quoted scalars, block lists, anchors, inline maps,
multi-line scalars) raises. ``model_config_from_yaml`` and
``training_config_from_yaml`` map the dicts onto the port's configs with
the JAX package's defaults and key spellings.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

from .augment import SpecAugmentConfig
from .models.config import VelocityASRConfig
from .training import TrainingConfig

# YAML 1.1 scalar resolution (PyYAML's resolver) for the forms in use.
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_BOOL = {"true": True, "yes": True, "on": True, "false": False, "no": False, "off": False}
_NULL = {"", "~", "null"}


def _strip_comment(line: str) -> str:
    """The line without a trailing comment (a # at its start or after a
    space)."""
    match = re.search(r"(^|\s)#", line)
    return line[:match.start()] if match else line


def _scalar(text: str) -> Any:
    text = text.strip()
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        return [_scalar(part) for part in inner.split(",")] if inner else []
    if (text and text[0] in "'\"{&*!|>%@`") or text.startswith("- "):
        raise ValueError(f"unsupported YAML value {text!r}")
    low = text.lower()
    if low in _NULL:
        return None
    if low in _BOOL:
        return _BOOL[low]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and text not in (".", "+.", "-."):
        return float(text.replace("_", ""))
    return text


def parse_yaml(text: str) -> Dict[str, Any]:
    """Parse the YAML subset described in the module docstring."""
    root: Dict[str, Any] = {}
    stack: List[tuple] = [(-1, root)]
    opened: List[tuple] = []  # (parent, key) of every map opened by "key:"
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        body = line.lstrip(" ")
        if body.startswith("\t") or body.startswith("- "):
            raise ValueError(f"line {lineno}: unsupported YAML: {raw!r}")
        indent = len(line) - len(body)
        key, sep, rest = body.partition(":")
        if not sep or (rest and not rest.startswith(" ")):
            raise ValueError(f"line {lineno}: expected 'key: value': {raw!r}")
        key = _scalar(key)
        while stack[-1][0] >= indent:
            stack.pop()
        parent = stack[-1][1]
        if rest.strip():
            parent[key] = _scalar(rest)
        else:
            parent[key] = {}
            stack.append((indent, parent[key]))
            opened.append((parent, key))
    for parent, key in opened:  # "key:" with nothing under it is null
        if parent[key] == {}:
            parent[key] = None
    return root


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        return parse_yaml(f.read()) or {}


def model_config_from_yaml(cfg: Dict[str, Any]) -> VelocityASRConfig:
    """Map a model.yaml dict onto VelocityASRConfig, with the JAX
    package's defaults (the reference's "mamba" scan mode is "pallas")."""
    model = cfg.get("model") or cfg
    ssm = cfg.get("ssm") or {}
    glob = cfg.get("global_context") or {}
    out = cfg.get("output") or {}
    perf = cfg.get("performance") or {}
    scan_mode = perf.get("scan_mode", model.get("scan_mode", "parallel"))
    if scan_mode == "mamba":
        scan_mode = "pallas"
    return VelocityASRConfig(
        mel_bins=model.get("mel_bins", 80),
        d_model=model.get("d_model", 192),
        ssm_layers=ssm.get("num_layers", model.get("ssm_layers", 8)),
        ssm_state_dim=ssm.get("state_dim", model.get("ssm_state_dim", 64)),
        ssm_expand_ratio=ssm.get("expand_ratio", model.get("ssm_expand_ratio", 2)),
        ssm_kernel_size=ssm.get("kernel_size", model.get("ssm_kernel_size", 4)),
        global_ssm_layers=glob.get("ssm_layers", model.get("global_ssm_layers", 2)),
        global_ssm_state_dim=glob.get("ssm_state_dim", model.get("global_ssm_state_dim", 32)),
        attention_heads=glob.get("attention_heads", model.get("attention_heads", 4)),
        attention_dim=glob.get("attention_dim", model.get("attention_dim", 48)),
        vocab_size=out.get("vocab_size", model.get("vocab_size", 1000)),
        dropout=model.get("dropout", 0.1),
        gradient_checkpointing=perf.get(
            "gradient_checkpointing", model.get("gradient_checkpointing", False)),
        scan_mode=scan_mode,
        dtype=perf.get("dtype", model.get("dtype", "float32")),
        num_languages=int(out.get("num_languages", model.get("num_languages", 0))),
        moe_experts=int(ssm.get("moe_experts", model.get("moe_experts", 0))),
        moe_top_k=int(ssm.get("moe_top_k", model.get("moe_top_k", 2))),
        moe_capacity_factor=float(
            ssm.get("moe_capacity_factor", model.get("moe_capacity_factor", 1.25))),
    )


def training_config_from_yaml(cfg: Dict[str, Any]) -> TrainingConfig:
    """Map a train.yaml dict onto TrainingConfig, with the JAX package's
    defaults; the augmentation stanza is this repo's top-level
    ``augmentation:`` or the reference's ``data.augmentation:``."""
    aug = cfg.get("augmentation") or (cfg.get("data") or {}).get("augmentation") or {}
    opt = cfg.get("optimizer") or {}
    trn = cfg.get("training") or {}
    log = cfg.get("logging") or {}
    ckpt = cfg.get("checkpoint") or {}
    dist = cfg.get("distributed") or {}
    return TrainingConfig(
        learning_rate=float(opt.get("learning_rate", 1e-4)),
        weight_decay=float(opt.get("weight_decay", 0.01)),
        warmup_steps=int(opt.get("warmup_steps", 10000)),
        lr_total_steps=int(opt["lr_total_steps"]) if opt.get("lr_total_steps") else None,
        lr_parity_horizon=bool(opt.get("lr_parity_horizon", False)),
        max_steps=int(trn.get("max_steps", 80000)),
        grad_clip_norm=float(opt.get("grad_clip_norm", 1.0)),
        batch_size=int(trn.get("batch_size", 32)),
        gradient_accumulation_steps=int(trn.get("gradient_accumulation_steps", 1)),
        use_amp=bool(trn.get("use_amp", True)),
        streaming_chunks=int(trn.get("streaming_chunks", 0)),
        streaming_aux_weight=float(trn.get("streaming_aux_weight", 0.5)),
        lid_loss_weight=float(trn.get("lid_loss_weight", 0.0)),
        moe_aux_weight=float(trn.get("moe_aux_weight", 0.01)),
        log_interval=int(log.get("log_interval", 100)),
        eval_interval=int(log.get("eval_interval", 1000)),
        save_interval=int(ckpt.get("save_interval", 5000)),
        checkpoint_dir=ckpt.get("dir", "./checkpoints"),
        keep_last=int(ckpt.get("keep_last", 5)),
        num_data_shards=dist.get("num_data_shards", None),
        num_model_shards=int(dist.get("num_model_shards", 1)),
        num_pipeline_stages=int(dist.get("num_pipeline_stages", 1)),
        pipeline_microbatches=(int(dist["pipeline_microbatches"])
                               if dist.get("pipeline_microbatches") else None),
        profile_dir=log.get("profile_dir", None),
        metrics_path=log.get("metrics_path", None),
        augment=spec_augment_from_yaml(aug),
    )


def spec_augment_from_yaml(aug: Dict[str, Any]) -> Optional[SpecAugmentConfig]:
    """The augmentation stanza as a SpecAugmentConfig, or None when nothing
    is on. enabled / spec_augment gates the masking; noise_injection and
    speed_perturb are their own switches (speed_perturb may be a
    [min, max] list)."""
    masking = bool(aug.get("enabled", aug.get("spec_augment", False)))
    noise = bool(aug.get("noise_injection", False))
    sp = aug.get("speed_perturb", False)
    if isinstance(sp, (list, tuple)):
        if len(sp) != 2 or not sp[0] <= sp[1]:
            raise ValueError(f"augmentation.speed_perturb: expected true/false or "
                             f"[min, max] with min <= max, got {sp!r}")
        speed_min, speed_max = float(sp[0]), float(sp[1])
        speed = True
    else:
        speed, speed_min, speed_max = bool(sp), 0.9, 1.1
    if not masking and not noise and not speed:
        return None
    return SpecAugmentConfig(
        enabled=True,
        num_time_masks=(int(aug.get("num_time_masks", aug.get("time_mask_num", 2)))
                        if masking else 0),
        time_mask_frames=int(aug.get("time_mask_frames", aug.get("time_mask_param", 50))),
        num_freq_masks=(int(aug.get("num_freq_masks", aug.get("freq_mask_num", 2)))
                        if masking else 0),
        freq_mask_bins=int(aug.get("freq_mask_bins", aug.get("freq_mask_param", 15))),
        noise_injection=noise,
        noise_min_snr_db=float(aug.get("noise_min_snr_db", 10.0)),
        noise_max_snr_db=float(aug.get("noise_max_snr_db", 40.0)),
        speed_perturb=speed,
        speed_min=speed_min,
        speed_max=speed_max,
    )
