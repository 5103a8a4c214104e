"""Parity of the PyTorch port's modules with the JAX package's, module by
module, at a small size (d_model 32, 2 layers, fp32).

Each JAX module is initialised from a PRNG key, every parameter is then
perturbed with numpy noise (so LayerNorm scales, biases, D and A_log are
not at their init values), and the same numpy weights and inputs go
through both. Tolerance atol 1e-5 (rtol 1e-5): fp32 on both sides, with
different summation orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velocity_asr_tpu.models import attention as jattn
from velocity_asr_tpu.models import layers as jlayers
from velocity_asr_tpu.models import ssm as jssm
from velocity_asr_tpu.ops import conv as jconv
from velocity_asr_tpu.ops import pooling as jpool
from velocity_asr_tpu_torch.checkpoint import params_from_numpy
from velocity_asr_tpu_torch.models import attention as tattn
from velocity_asr_tpu_torch.models import layers as tlayers
from velocity_asr_tpu_torch.models import ssm as tssm
from velocity_asr_tpu_torch.ops import conv as tconv
from velocity_asr_tpu_torch.ops import pooling as tpool

ATOL = 1e-5
D_MODEL = 32


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.1 * rng.standard_normal(p.shape)).astype(np.float32),
        tree,
    )


def _jax_apply(module, seed, *inputs, **kwargs):
    params = module.init(jax.random.PRNGKey(seed), *inputs, **kwargs)["params"]
    params = _perturb(jax.device_get(params), seed + 100)
    out = module.apply({"params": params}, *inputs, **kwargs)
    return params, out


def _port(module_fn, params):
    with torch.device("meta"):
        module = module_fn()
    module = module.to_empty(device="cpu")
    module.load_state_dict(params_from_numpy(params), strict=True)
    return module.eval()


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(port_out, jax_out, atol=ATOL):
    np.testing.assert_allclose(
        port_out.detach().numpy(), np.asarray(jax_out), rtol=1e-5, atol=atol
    )


def test_sinusoidal_time_encoding_matches_jax():
    np.testing.assert_array_equal(
        tlayers.sinusoidal_time_encoding(50, 16), jlayers.sinusoidal_time_encoding(50, 16)
    )


def test_positional_encoding_2d():
    x = _x(0, 2, 24, D_MODEL)
    params, ref = _jax_apply(jlayers.PositionalEncoding2D(d_model=D_MODEL), 0, x)
    port = _port(lambda: tlayers.PositionalEncoding2D(D_MODEL), params)
    _close(port(torch.from_numpy(x)), ref)


@pytest.mark.parametrize("frames", [24, 25])
def test_temporal_binding(frames):
    mel = _x(1, 2, frames, 16)
    params, ref = _jax_apply(jlayers.TemporalBindingLayer(mel_bins=16, d_model=D_MODEL), 1, mel)
    port = _port(lambda: tlayers.TemporalBindingLayer(16, D_MODEL), params)
    out = port(torch.from_numpy(mel))
    assert out.shape == (2, (frames + 1) // 2, D_MODEL)
    _close(out, ref)


def test_ctc_output_head():
    x = _x(2, 2, 12, D_MODEL)
    params, ref = _jax_apply(jlayers.CTCOutputHead(d_model=D_MODEL, vocab_size=30), 2, x)
    port = _port(lambda: tlayers.CTCOutputHead(D_MODEL, 30), params)
    _close(port(torch.from_numpy(x)), ref)


def test_causal_depthwise_conv1d():
    x, k, b = _x(3, 2, 20, 8), _x(4, 4, 8), _x(5, 8)
    ref = jconv.causal_depthwise_conv1d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    w = torch.from_numpy(np.ascontiguousarray(k.T[:, None, :]))  # (d, 1, k)
    _close(tconv.causal_depthwise_conv1d(torch.from_numpy(x), w, torch.from_numpy(b)), ref)


@pytest.mark.parametrize("length", [20, 21])
def test_strided_conv1d(length):
    x, k, b = _x(6, 2, length, 8), _x(7, 3, 8, 12), _x(8, 12)
    ref = jconv.strided_conv1d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    w = torch.from_numpy(np.ascontiguousarray(k.transpose(2, 1, 0)))  # (out, in, k)
    out = tconv.strided_conv1d(torch.from_numpy(x), w, torch.from_numpy(b))
    assert out.shape[1] == (length + 1) // 2
    _close(out, ref)


@pytest.mark.parametrize("seq_len,pool", [(100, 64), (64, 16), (37, 10), (16, 16)])
def test_adaptive_pool_matrix_and_pool(seq_len, pool):
    np.testing.assert_array_equal(
        tpool.adaptive_pool_matrix(seq_len, pool), jpool.adaptive_pool_matrix(seq_len, pool)
    )
    x = _x(9, 2, seq_len, 8)
    _close(tpool.adaptive_avg_pool1d(torch.from_numpy(x), pool),
           jpool.adaptive_avg_pool1d(jnp.asarray(x), pool))
    ref_torch = torch.nn.functional.adaptive_avg_pool1d(
        torch.from_numpy(x).transpose(1, 2), pool).transpose(1, 2)
    _close(tpool.adaptive_avg_pool1d(torch.from_numpy(x), pool), ref_torch.numpy())


@pytest.mark.parametrize("seq_len", [8, 64, 100, 800, 2000])
def test_pool_sizes(seq_len):
    k1 = tpool.pool_size_level1(seq_len)
    assert k1 == jpool.pool_size_level1(seq_len)
    assert tpool.pool_size_level2(k1) == jpool.pool_size_level2(k1)


def test_selective_ssm():
    x = _x(10, 2, 30, D_MODEL)
    mod = jssm.SelectiveSSM(d_model=D_MODEL, state_dim=8, scan_mode="sequential")
    params, ref = _jax_apply(mod, 10, x)
    port = _port(lambda: tssm.SelectiveSSM(D_MODEL, 8, scan_mode="pallas"), params)
    _close(port(torch.from_numpy(x)), ref)


def test_ssm_block():
    x = _x(11, 2, 30, D_MODEL)
    mod = jssm.SSMBlock(d_model=D_MODEL, state_dim=8, scan_mode="sequential")
    params, ref = _jax_apply(mod, 11, x)
    port = _port(lambda: tssm.SSMBlock(D_MODEL, 8, scan_mode="pallas"), params)
    _close(port(torch.from_numpy(x)), ref)


def test_local_ssm_processor():
    x = _x(12, 2, 30, D_MODEL)
    mod = jssm.LocalSSMProcessor(d_model=D_MODEL, num_layers=2, state_dim=8,
                                 scan_mode="sequential")
    params, ref = _jax_apply(mod, 12, x)
    port = _port(lambda: tssm.LocalSSMProcessor(D_MODEL, 2, 8, scan_mode="pallas"), params)
    _close(port(torch.from_numpy(x)), ref)


def test_global_ssm():
    x = _x(13, 2, 16, D_MODEL)
    mod = jssm.GlobalSSM(d_model=D_MODEL, num_layers=2, state_dim=4, scan_mode="sequential")
    params, ref = _jax_apply(mod, 13, x)
    port = _port(lambda: tssm.GlobalSSM(D_MODEL, 2, 4, scan_mode="pallas"), params)
    _close(port(torch.from_numpy(x)), ref)


@pytest.mark.parametrize("level", [1, 2])
def test_adaptive_pool_module(level):
    x = _x(14, 2, 80, D_MODEL)
    kwargs = {"prev_pool_size": 64} if level == 2 else {}
    params, (ref, ref_size) = _jax_apply(
        jattn.AdaptivePool(level=level, d_model=D_MODEL), 14, x, **kwargs)
    port = _port(lambda: tattn.AdaptivePool(level, D_MODEL), params)
    out, size = port(torch.from_numpy(x), **kwargs)
    assert size == ref_size
    _close(out, ref)


def test_multi_head_attention():
    q, kv = _x(15, 2, 30, D_MODEL), _x(16, 2, 16, D_MODEL)
    mod = jattn.MultiHeadAttention(d_model=D_MODEL, num_heads=4, attention_dim=16)
    params, ref = _jax_apply(mod, 15, q, kv, kv)
    port = _port(lambda: tattn.MultiHeadAttention(D_MODEL, 4, 16), params)
    _close(port(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv)), ref)


def test_gated_fusion():
    a, b = _x(17, 2, 30, D_MODEL), _x(18, 2, 30, D_MODEL)
    params, ref = _jax_apply(jattn.GatedFusion(d_model=D_MODEL), 17, a, b)
    port = _port(lambda: tattn.GatedFusion(D_MODEL), params)
    _close(port(torch.from_numpy(a), torch.from_numpy(b)), ref)


@pytest.mark.parametrize("seq_len", [40, 100])
def test_hierarchical_global_context(seq_len):
    x = _x(19, 2, seq_len, D_MODEL)
    mod = jattn.HierarchicalGlobalContext(
        d_model=D_MODEL, num_heads=4, attention_dim=16, global_ssm_layers=2,
        global_ssm_state_dim=4, scan_mode="sequential")
    params, ref = _jax_apply(mod, 19, x)
    port = _port(lambda: tattn.HierarchicalGlobalContext(
        D_MODEL, 4, 16, 2, 4, scan_mode="pallas"), params)
    _close(port(torch.from_numpy(x)), ref)
