"""Model export (mirrors velocity_asr_tpu/export.py): a ``torch.export``
program and the int8 weight package.

``export_program`` writes the forward as a ``torch.export`` artifact
(``.pt2``), the weights baked in, at one input shape; ``load_exported``
reads it back as a callable of the mel. As the JAX package does for its
StableHLO artifact, the exported graph is normalised
(``export_graph_config``): no int8 or QAT layer (the weights are the
float ones) and a scan in stock operations, the log-depth
``ops.scan.selective_scan_parallel`` (scan mode "associative"), so no
CUDA kernel is baked into the artifact. Only the exported graph runs that
scan; every other path keeps the CUDA kernels.

The int8 weight package is the JAX package's ``int8-v1`` format:
``config.json`` ({"config": ..., "format": "int8-v1", "fp32_mb",
"int8_mb", "quantized_tensors"[, "calibrated"]}), ``weights_int8.npz``
holding each flax leaf under its ``/``-joined path, a quantized one as
``<path>.int8`` codes and ``<path>.scale`` in flax's (in, out) layout with
the scale's kept dims, and for a calibrated package ``quant_stats.msgpack``
(the static int8 layers' ``x_amax`` and ``calibrated``), which turns the
packaged config's ``int8_inference`` and ``int8_static`` on. A leaf is
quantized when it has two or more dims, none of them 1, and no "ssm" in
its path; its grid is ``ops/int8_matmul.py`` ``quantize_weight``'s
(amax / 127, clipped to +-127), so a loaded package's runtime
requantization lands on the package's codes. There is no TFLite
converter here (``export_model --tflite`` refuses), and no ONNX, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .checkpoint import (_sorted_tree, params_from_numpy, quant_stats_from_numpy, read_params,
                         write_params)
from .models.config import VelocityASRConfig
from .models.layers import _time_encoding
from .models.model import VelocityASR, _empty_model
from .ops.pooling import _device_pool_matrix
from .quantize import load_quant_stats

INT8_FORMAT = "int8-v1"
INT8_WEIGHTS = "weights_int8.npz"
QUANT_STATS_FILE = "quant_stats.msgpack"


def export_graph_config(cfg: VelocityASRConfig) -> VelocityASRConfig:
    """A checkpoint config normalised for an exported graph: the scan in
    stock operations ("associative") and no int8 or QAT layer."""
    return dataclasses.replace(cfg, scan_mode="associative", int8_inference=False,
                               int8_static=False, qat=False)


def _clear_tensor_caches() -> None:
    """Drop the cached time-encoding tables and pooling matrices: tracing
    must neither reuse eager tensors nor leave traced ones behind."""
    _time_encoding.cache_clear()
    _device_pool_matrix.cache_clear()


def export_program(model: VelocityASR, output_path: str,
                   input_shape: Optional[Tuple[int, int, int]] = None) -> str:
    """Export `model`'s eval forward at `input_shape` (default (1, 500,
    mel_bins)) as a ``torch.export`` program on the model's device, its
    weights inside, normalised by ``export_graph_config``; writes
    `output_path` (.pt2) and returns it."""
    cfg = model.config
    if input_shape is None:
        input_shape = (1, 500, cfg.mel_bins)
    device = next(model.parameters()).device
    graph = _empty_model(export_graph_config(cfg), device)
    graph.load_state_dict(model.state_dict(), strict=True)
    mel = torch.zeros(input_shape, dtype=torch.float32, device=device)
    _clear_tensor_caches()
    try:
        program = torch.export.export(graph.eval(), (mel,))
    finally:
        _clear_tensor_caches()
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    torch.export.save(program, output_path)
    return output_path


def load_exported(path: str):
    """An exported program as a callable of the mel (its export shape),
    returning fp32 logits."""
    return torch.export.load(path).module()


# ----- the int8 weight package ------------------------------------------------


def quantize_weights_int8(params: Dict[str, Any],
                          skip_ssm: bool = True) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Per-channel symmetric int8 of a flax parameter tree
    (``checkpoint.params_to_numpy``): each matrix leaf outside the SSM
    blocks (with `skip_ssm`) becomes {"int8": codes, "scale": amax / 127
    over every axis but the last, floored at 1e-10, dims kept}; the rest
    stays fp32. Returns (tree, {"fp32_mb", "int8_mb", "quantized_tensors"})."""
    tree = _sorted_tree(params)
    fp32_bytes = q_bytes = n_quantized = 0

    def visit(node, path):
        nonlocal fp32_bytes, q_bytes, n_quantized
        if isinstance(node, dict):
            return {k: visit(v, path + (k,)) for k, v in node.items()}
        leaf = np.asarray(node)
        fp32_bytes += leaf.nbytes
        is_matrix = leaf.ndim >= 2 and min(leaf.shape) > 1
        if is_matrix and not (skip_ssm and "ssm" in "/".join(path).lower()):
            amax = np.abs(leaf).max(axis=tuple(range(leaf.ndim - 1)), keepdims=True)
            scale = np.maximum(amax / 127.0, 1e-10).astype(np.float32)
            q = np.clip(np.round(leaf / scale), -127, 127).astype(np.int8)
            q_bytes += q.nbytes + scale.nbytes
            n_quantized += 1
            return {"int8": q, "scale": scale}
        q_bytes += leaf.nbytes
        return leaf

    qtree = visit(tree, ())
    return qtree, {"fp32_mb": fp32_bytes / 1024 / 1024, "int8_mb": q_bytes / 1024 / 1024,
                   "quantized_tensors": n_quantized}


def _is_quantized(node) -> bool:
    return isinstance(node, dict) and set(node) == {"int8", "scale"}


def dequantize_weights(qtree: Dict[str, Any]) -> Dict[str, Any]:
    """fp32 parameters from an int8 tree: codes times scale."""
    if _is_quantized(qtree):
        return (qtree["int8"].astype(np.float32) * qtree["scale"]).astype(np.float32)
    if isinstance(qtree, dict):
        return {k: dequantize_weights(v) for k, v in qtree.items()}
    return qtree


def save_int8_checkpoint(path: str, config: VelocityASRConfig, params: Dict[str, Any],
                         quant_stats: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Write an int8 package directory from a flax parameter tree.
    `quant_stats`, a calibrated static-int8 model's flax tree
    (``quantize.quant_stats_to_numpy``), goes beside it as
    ``quant_stats.msgpack`` and turns the packaged config's static int8
    path on. Returns the size info."""
    if quant_stats is not None:
        config = dataclasses.replace(config, int8_inference=True, int8_static=True)
    qtree, info = quantize_weights_int8(params)
    os.makedirs(path, exist_ok=True)
    if quant_stats is not None:
        write_params(os.path.join(path, QUANT_STATS_FILE), quant_stats)
        info["calibrated"] = True
    arrays: Dict[str, np.ndarray] = {}

    def flatten(prefix: str, node) -> None:
        if _is_quantized(node):
            arrays[prefix + ".int8"] = node["int8"]
            arrays[prefix + ".scale"] = node["scale"]
        elif isinstance(node, dict):
            for k, v in node.items():
                flatten(f"{prefix}/{k}" if prefix else k, v)
        else:
            arrays[prefix] = np.asarray(node)

    flatten("", qtree)
    np.savez_compressed(os.path.join(path, INT8_WEIGHTS), **arrays)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"config": config.to_dict(), "format": INT8_FORMAT, **info}, f, indent=2)
    return info


def load_int8_checkpoint(path: str) -> Tuple[VelocityASRConfig, Dict[str, Any]]:
    """An int8 package as (config, dequantized fp32 flax parameter tree)."""
    with open(os.path.join(path, "config.json")) as f:
        meta = json.load(f)
    if meta.get("format") != INT8_FORMAT:
        raise ValueError(f"{path!r} is not an {INT8_FORMAT} package (format "
                         f"{meta.get('format')!r})")
    config = VelocityASRConfig.from_dict(meta["config"])
    tree: Dict[str, Any] = {}
    with np.load(os.path.join(path, INT8_WEIGHTS)) as data:
        for key in data.files:
            if key.endswith(".scale"):
                continue
            parts = key.split("/")
            leaf = parts[-1]
            if leaf.endswith(".int8"):
                leaf = leaf[: -len(".int8")]
                value = (data[key].astype(np.float32)
                         * data[key[: -len(".int8")] + ".scale"]).astype(np.float32)
            else:
                value = data[key]
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[leaf] = value
    return config, tree


def load_int8_quant_stats(path: str, model: nn.Module) -> Optional[Dict[str, Any]]:
    """Load a calibrated package's ``quant_stats.msgpack`` into `model`'s
    static int8 layers; returns the flax tree, or None for an
    uncalibrated package (the model left as it is)."""
    stats_path = os.path.join(path, QUANT_STATS_FILE)
    if not os.path.exists(stats_path):
        return None
    tree = read_params(stats_path)
    load_quant_stats(model, quant_stats_from_numpy(tree))
    return tree


def load_int8_model(path: str, device="cuda") -> VelocityASR:
    """An int8 package as a model ready to run on `device`: the dequantized
    weights; for a calibrated package, int8_inference and int8_static on
    and the calibrated scales loaded (its projections run the static int8
    kernel); for an uncalibrated one, float Dense layers."""
    config, tree = load_int8_checkpoint(path)
    model = _empty_model(config, device)
    model.load_state_dict(params_from_numpy(tree), strict=True)
    stats = load_int8_quant_stats(path, model)
    if config.int8_static and stats is None:
        raise ValueError(f"int8 package {path!r} declares int8_static but has no "
                         f"{QUANT_STATS_FILE}: corrupt or incomplete package")
    return model

