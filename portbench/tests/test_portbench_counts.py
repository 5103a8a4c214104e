"""The frozen counts reproduce the kernel table's bounds and the model's
weight count."""

import math

import pytest

from portbench import counts
from portbench.reference.model import param_specs

BASE = dict(mel_bins=80, d_model=192, ssm_layers=8, ssm_state_dim=64, ssm_expand_ratio=2,
            ssm_kernel_size=4, global_ssm_layers=2, global_ssm_state_dim=32,
            attention_heads=4, attention_dim=48, vocab_size=1000, moe_experts=0)


def ms(seconds):
    return round(seconds * 1e3, 5)


@pytest.mark.parametrize("fn, shape, want", [
    (counts.scan_fwd_seconds, (16, 300, 384, 64), 0.01235),     # operations
    (counts.scan_fwd_seconds, (1, 200, 384, 64), 0.00051),      # operations
    (counts.scan_fwd_seconds, (1, 64, 384, 32), 0.00009),       # bytes
    (counts.scan_fwd_bounds_seconds, (16, 300, 384, 64), 0.01626),
    (counts.scan_fwd_bounds_seconds, (16, 64, 384, 32), 0.00243),
    (counts.scan_bwd_seconds, (16, 300, 384, 64), 0.03521),
    (counts.scan_bwd_seconds, (16, 64, 384, 32), 0.00376),
    (counts.scan_bwd_seconds, (8, 1200, 384, 64), 0.07043),
])
def test_scan_bounds_match_the_kernel_table(fn, shape, want):
    assert ms(fn(*shape)) == want


def test_log_mel_counts_the_int16_read_and_the_mel_write():
    frames = 400
    assert counts.log_mel_bytes(2, frames) == 2 * (2 * 399 * 160 + 4 * 400 * 80)
    assert counts.log_mel_seconds(1, frames) == counts.log_mel_bytes(1, frames) / 3.35e12


def test_forward_flops_are_twice_the_weights_plus_attention_and_scans():
    # At 32 mel frames (16 local frames) both pools keep all 16 tokens, so
    # every Dense and conv runs once a frame.
    weights = sum(math.prod(shape) for _, shape, kind in param_specs(BASE)
                  if kind in ("dense", "conv"))
    length = 16
    attention = 2 * 2 * length * length * 48
    scans = length * (8 * (7 * 384 * 64 + 384) + 2 * (7 * 384 * 32 + 384))
    assert counts.forward_flops(BASE, 32) == 2 * weights * length + attention + scans
    assert counts.train_flops(BASE, 32) == 3 * counts.forward_flops(BASE, 32)


def test_weight_specs_are_the_ports_parameters():
    import torch
    from velocity_asr_tpu_torch.models.config import VelocityASRConfig
    from velocity_asr_tpu_torch.models.model import VelocityASR

    for extra in ({}, {"moe_experts": 8, "moe_top_k": 2, "vocab_size": 30}):
        keys = {**BASE, **extra}
        with torch.device("meta"):
            model = VelocityASR(VelocityASRConfig.from_dict(keys))
        ours = {name: shape for name, shape, _ in param_specs(keys)}
        theirs = {name: tuple(p.shape) for name, p in model.named_parameters()}
        assert ours == theirs


def test_base_flops_per_audio_second():
    # 2 s buckets of 200 frames: about 0.58 GFLOP an audio second at 8 s
    per_s = counts.forward_flops(BASE, 800) / 8.0
    assert 0.5e9 < per_s < 0.7e9


def test_moe_counts_its_top_k_experts():
    moe = {**BASE, "moe_experts": 8, "moe_top_k": 2, "moe_capacity_factor": 1.25}
    length = 16
    extra = 8 * length * (2 * 192 * 384 + 192 * 8)   # one more expert and the router
    assert counts.forward_flops(moe, 32) - counts.forward_flops(BASE, 32) == 2 * extra
