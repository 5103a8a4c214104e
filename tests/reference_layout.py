"""A VELOCITY-ASR flax parameter tree written back as a reference PyTorch
state_dict (the names and layouts that ``compat/torch_convert.py`` reads),
numpy only, so that a test or a script on a machine without JAX can make a
reference checkpoint from a trained model.

    state_dict = reference_state_dict(params_to_numpy(model))
"""

import numpy as np


def _linear(sd, prefix, node):
    sd[f"{prefix}.weight"] = np.ascontiguousarray(np.asarray(node["kernel"]).T)
    if "bias" in node:
        sd[f"{prefix}.bias"] = np.asarray(node["bias"])


def _layernorm(sd, prefix, node):
    sd[f"{prefix}.weight"] = np.asarray(node["scale"])
    sd[f"{prefix}.bias"] = np.asarray(node["bias"])


def _conv(sd, prefix, node):
    sd[f"{prefix}.conv.weight"] = np.ascontiguousarray(
        np.asarray(node["conv_kernel"]).transpose(2, 1, 0))
    sd[f"{prefix}.conv.bias"] = np.asarray(node["conv_bias"])


def _ssm_stack(sd, prefix, node):
    i = 0
    while f"layers_{i}" in node:
        block, p = node[f"layers_{i}"], f"{prefix}.layers.{i}"
        _layernorm(sd, f"{p}.norm1", block["norm1"])
        _layernorm(sd, f"{p}.norm2", block["norm2"])
        _conv(sd, p, block)
        ssm = block["ssm"]
        for name in ("in_proj", "x_proj", "dt_proj", "out_proj"):
            _linear(sd, f"{p}.ssm.{name}", ssm[name])
        sd[f"{p}.ssm.A_log"] = np.asarray(ssm["A_log"])
        sd[f"{p}.ssm.D"] = np.asarray(ssm["D"])
        _linear(sd, f"{p}.ffn.0", block["ffn_in"])
        _linear(sd, f"{p}.ffn.3", block["ffn_out"])
        i += 1
    _layernorm(sd, f"{prefix}.norm", node["norm"])


def reference_state_dict(tree, pe_time_frames=16):
    """The reference state_dict (numpy values) of a dense VelocityASR
    flax tree, with a `pe_time_frames`-row sinusoidal ``pe_time`` buffer
    (which the converter skips, as it recomputes the table)."""
    sd = {}
    tb = tree["temporal_binding"]
    _conv(sd, "temporal_binding", tb)
    sd["temporal_binding.pos_encoding.pe_freq"] = np.asarray(tb["pos_encoding"]["pe_freq"])
    d_model = sd["temporal_binding.conv.weight"].shape[0]
    pos = np.arange(pe_time_frames, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-np.log(10000.0) / d_model))
    pe = np.zeros((pe_time_frames, d_model), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div[: d_model // 2])
    sd["temporal_binding.pos_encoding.pe_time"] = pe
    _layernorm(sd, "temporal_binding.norm", tb["norm"])
    _ssm_stack(sd, "local_ssm", tree["local_ssm"])
    gc = tree["global_context"]
    _linear(sd, "global_context.pool1.pool_proj", gc["pool1"]["pool_proj"])
    _linear(sd, "global_context.pool2.pool_proj", gc["pool2"]["pool_proj"])
    _ssm_stack(sd, "global_context.global_ssm", gc["global_ssm"])
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _linear(sd, f"global_context.cross_attention.{name}", gc["cross_attention"][name])
    _layernorm(sd, "global_context.norm1", gc["norm1"])
    _layernorm(sd, "global_context.norm2", gc["norm2"])
    fusion = gc["fusion"]
    _linear(sd, "global_context.fusion.gate_proj.0", fusion["gate_proj"])
    for name in ("local_proj", "global_proj", "out_proj"):
        _linear(sd, f"global_context.fusion.{name}", fusion[name])
    _layernorm(sd, "ctc_head.proj.0", tree["ctc_head"]["norm"])
    _linear(sd, "ctc_head.proj.2", tree["ctc_head"]["proj"])
    return sd
