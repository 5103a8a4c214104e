"""create_model initialises as the JAX package's create_model + init_params
do (models/model.py init_parameters).

The draws come from a torch.Generator and not from jax.random, so the
values differ; what is held is the distributions:
  - A_log = log(1..N) exactly (correctly rounded in fp32; the JAX
    package's XLA log is within one ulp of it), D = 1, LayerNorm weight
    1 and bias 0, every bias 0: exact;
  - Dense kernels xavier-uniform: every value within sqrt(6 / (in + out))
    and the sample variance within 5% of bound^2 / 3 for tensors of at
    least 5,000 values (the sampling error there is under 1.3%), and
    within 5% of the variance of JAX's own draw of the same kernel;
  - conv kernels kaiming-normal with fan_out = out * k: sample std within
    5% of sqrt(2 / fan_out) and of JAX's draw at 5,000 values or more,
    within 15% below that (sampling error under 5%);
  - the same generator seed gives the same weights; another seed other
    weights.
"""

import jax
import numpy as np
import pytest
import torch

from velocity_asr_tpu.models import config as jconfig
from velocity_asr_tpu.models import model as jmodel
from velocity_asr_tpu_torch.checkpoint import params_from_numpy
from velocity_asr_tpu_torch.models import model as tmodel
from velocity_asr_tpu_torch.models.config import VelocityASRConfig
from velocity_asr_tpu_torch.ops.int8_matmul import quantize_weight

SMALL = dict(d_model=64, ssm_layers=2, ssm_state_dim=16, global_ssm_layers=1,
             global_ssm_state_dim=8, attention_heads=4, attention_dim=16, vocab_size=40)


def _port(seed=0, **cfg):
    return tmodel.create_model(VelocityASRConfig(**cfg), device="cpu",
                               generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def pair():
    """The port's init and JAX's init_params of the same small config, the
    JAX tree mapped to the port's names and layouts."""
    jm = jmodel.create_model(jconfig.VelocityASRConfig(**SMALL))
    params = jax.device_get(jax.jit(lambda key: jmodel.init_params(jm, key, example_frames=16))(
        jax.random.PRNGKey(0)))
    jax_sd = {k: v.numpy() for k, v in params_from_numpy(params).items()}
    port_sd = {k: v.numpy() for k, v in _port(**SMALL).state_dict().items()}
    assert set(port_sd) == set(jax_sd)
    return port_sd, jax_sd


def _kind(key, value):
    if key.endswith("A_log") or key.endswith(".D"):
        return "ssm"
    if key.endswith("pe_freq"):
        return "pe"
    if key.endswith("conv.weight"):
        return "conv"
    if key.endswith(".weight") and value.ndim == 2:
        return "dense"
    return "exact"  # LayerNorm weight/bias and every bias


def test_every_parameter_finite_and_of_jax_shape(pair):
    port_sd, jax_sd = pair
    for key, value in port_sd.items():
        assert value.shape == jax_sd[key].shape, key
        assert np.isfinite(value).all(), key


def test_deterministic_parameters_exact(pair):
    port_sd, jax_sd = pair
    n_checked = 0
    for key, value in port_sd.items():
        kind = _kind(key, value)
        if kind == "exact":
            np.testing.assert_array_equal(value, jax_sd[key], err_msg=key)
            assert set(np.unique(value)) <= {0.0, 1.0}, key
        elif key.endswith(".D"):
            np.testing.assert_array_equal(value, np.ones_like(value), err_msg=key)
        elif key.endswith("A_log"):
            n = value.shape[0]
            want = np.log(np.arange(1, n + 1, dtype=np.float64)).astype(np.float32)
            np.testing.assert_array_equal(value, want, err_msg=key)
            np.testing.assert_allclose(value, jax_sd[key], rtol=2.0 ** -23, atol=0, err_msg=key)
        else:
            continue
        n_checked += 1
    assert n_checked >= 20


def test_dense_kernels_xavier_uniform(pair):
    port_sd, jax_sd = pair
    n_checked = 0
    for key, value in port_sd.items():
        if _kind(key, value) != "dense":
            continue
        fan_out, fan_in = value.shape
        bound = np.sqrt(6.0 / (fan_in + fan_out))
        assert np.abs(value).max() <= bound and np.abs(jax_sd[key]).max() <= bound, key
        if value.size >= 5000:
            var = value.astype(np.float64).var()
            assert abs(var / (bound ** 2 / 3) - 1) <= 0.05, key
            assert abs(var / jax_sd[key].astype(np.float64).var() - 1) <= 0.05, key
            n_checked += 1
    assert n_checked >= 10


def test_conv_kernels_kaiming_normal_fan_out(pair):
    port_sd, jax_sd = pair
    keys = [k for k, v in port_sd.items() if _kind(k, v) == "conv"]
    assert len(keys) == 1 + SMALL["ssm_layers"] + SMALL["global_ssm_layers"]
    for key in keys:
        value = port_sd[key].astype(np.float64)
        out, _, k = value.shape
        want = np.sqrt(2.0 / (out * k))
        tol = 0.05 if value.size >= 5000 else 0.15
        assert abs(value.std() / want - 1) <= tol, key
        assert abs(value.std() / jax_sd[key].std() - 1) <= tol, key
        assert abs(value.mean()) <= 4 * want / np.sqrt(value.size), key


def test_positional_frequencies_normal_002(pair):
    port_sd, jax_sd = pair
    value = port_sd["temporal_binding.pos_encoding.pe_freq"].astype(np.float64)
    assert value.shape == (1, 1, SMALL["d_model"] // 2)
    assert 0.012 <= value.std() <= 0.028 and 0.012 <= jax_sd[
        "temporal_binding.pos_encoding.pe_freq"].std() <= 0.028


def test_generator_seed_decides_the_weights():
    a, b, c = (_port(seed, **SMALL).state_dict() for seed in (3, 3, 4))
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    assert not torch.equal(a["ctc_head.proj.weight"], c["ctc_head.proj.weight"])
    default = tmodel.create_model(VelocityASRConfig(**SMALL), device="cpu")
    torch.testing.assert_close(default.state_dict()["ctc_head.proj.weight"],
                               _port(0, **SMALL).state_dict()["ctc_head.proj.weight"],
                               rtol=0, atol=0)


def test_fresh_model_runs_and_int8_codes_follow_the_init():
    model = _port(1, int8_inference=True, int8_static=True, **SMALL)
    logits = tmodel.forward(model, torch.randn(2, 64, 80, generator=torch.Generator()
                                               .manual_seed(0)))
    assert logits.shape == (2, 32, SMALL["vocab_size"]) and torch.isfinite(logits).all()
    codes, scales = quantize_weight(model.ctc_head.proj.weight)
    torch.testing.assert_close(model.ctc_head.proj.w_q, codes, rtol=0, atol=0)
    torch.testing.assert_close(model.ctc_head.proj.w_scale, scales, rtol=0, atol=0)
    assert not bool(model.ctc_head.proj.calibrated) and model.ctc_head.proj.x_amax.item() == 0
