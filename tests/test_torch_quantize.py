"""Quantization-aware training in the port against the JAX package, on
the CPU, at the JAX ``tests/test_quantize.py`` size (d_model 16, 1 local
and 1 global SSM block, N = 4, vocabulary 20, dropout 0), inputs from a
numpy seed:

- ``FakeQuantize`` symmetric per channel and asymmetric per tensor, in
  training, calibrating and eval modes, fp32 and bf16: outputs, scales
  and zero points bit-equal to the flax module's, and the STE gradient
  bit-equal to ``jax.grad``'s (the same elementwise operations in the
  same order; min and max are exact); pass-through until calibrated;
- ``QuantDense`` and ``QuantConv1d`` against the flax modules: outputs
  within 1e-6 (the product's summation order differs), weight observers
  bit-equal, activation observers within 1e-6 relative;
- the tiny QAT model: a training forward's logits within 1e-4, weight
  observers bit-equal and activation observers within 1e-5 relative (they
  follow the layer outputs, which differ in the last bits); gradients
  against ``jax.value_and_grad`` within 1e-4 of max|grad|;
  ``calibrate_model`` over two batches: ranges, scales and zero points
  within 1e-6 relative; the ``ssm_state_fp32`` path rule;
- one Trainer micro-step against the JAX Trainer (loss 1e-5 relative,
  weights as ``test_torch_training.py`` holds them, observers as above),
  the two JAX refusals, gradient checkpointing beside QAT;
- the train CLI with ``quantization.enabled`` on dummy data, the
  observers' ``quant_stats.msgpack`` in both directions.
"""

import dataclasses
import json

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velocity_asr_tpu import quantize as jquant
from velocity_asr_tpu import training as jtraining
from velocity_asr_tpu.models import config as jconfig
from velocity_asr_tpu.models import model as jmodel
from velocity_asr_tpu_torch import quantize as tquant
from velocity_asr_tpu_torch import train as ttrain
from velocity_asr_tpu_torch import training as ttraining
from velocity_asr_tpu_torch.checkpoint import (_flatten, float_params_tree, params_to_numpy,
                                               qat_params_tree, quant_stats_from_numpy,
                                               read_params, write_params)
from velocity_asr_tpu_torch.models import model as tmodel
from velocity_asr_tpu_torch.models import ssm as tssm
from velocity_asr_tpu_torch.models.config import VelocityASRConfig

SMALL = dict(d_model=16, ssm_layers=1, ssm_state_dim=4, global_ssm_layers=1,
             global_ssm_state_dim=4, attention_heads=2, attention_dim=8, vocab_size=20,
             dropout=0.0)
LOGITS_ATOL = 1e-4
ACT_STATS_RTOL = 1e-5  # activation observers of the whole model
GRAD_REL = 1e-4  # of max|grad|
CALIB_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: several test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _mel(seed, frames=32, batch=2):
    return np.random.default_rng(seed).standard_normal((batch, frames, 80)).astype(np.float32)


# ----- FakeQuantize ----------------------------------------------------------------


SCHEMES = {"symmetric_per_channel": dict(symmetric=True, per_channel=True),
           "asymmetric_per_tensor": dict(symmetric=False, per_channel=False)}


def _fq_pair(scheme, n_out=6):
    kw = SCHEMES[scheme]
    jfq = jquant.FakeQuantize(bits=8, channel_axis=-1, **kw)
    tfq = tquant.FakeQuantize(8, channel_dim=0, stat_shape=(1, n_out), **kw)
    return jfq, tfq


def _stats_equal(jstats, tfq):
    for key in ("scale", "zero_point", "range_min", "range_max"):
        np.testing.assert_array_equal(getattr(tfq, key).numpy(), np.asarray(jstats[key]),
                                      err_msg=key)
    assert bool(tfq.calibrated) == bool(jstats["calibrated"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["training", "calibrating", "eval"])
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_fake_quantize_matches_flax(scheme, mode, dtype):
    """Outputs, scales, zero points and ranges bit-equal to the flax
    module's; the tensor is a torch weight (out, in) = (6, 5), the flax
    module sees its (in, out) transpose. Calibrating accumulates over two
    tensors; eval reads training-mode stats, calibrated or not."""
    rng = np.random.default_rng(0)
    ws = [(rng.standard_normal((6, 5)) * s + b).astype(np.float32)
          for s, b in ((2.0, 0.3), (3.0, -0.5))]
    jfq, tfq = _fq_pair(scheme)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jx = [jnp.asarray(w.T).astype(dtype) for w in ws]
    tx = [torch.from_numpy(w).to(tdt) for w in ws]
    stats = jfq.init(jax.random.PRNGKey(0), jx[0], update_stats=True)["quant_stats"]
    if mode == "training":
        tfq.train()
        jout, stats = jfq.apply({"quant_stats": stats}, jx[0], update_stats=True,
                                mutable=["quant_stats"])
        stats = stats["quant_stats"]
        tout = tfq(tx[0])
    elif mode == "calibrating":
        tfq.eval()
        tfq.calibrating = True
        for jv, tv in zip(jx, tx):
            jout, stats = jfq.apply({"quant_stats": stats}, jv, mutable=["quant_stats"])
            stats = stats["quant_stats"]
            tout = tfq(tv)
    else:
        tfq.train()
        _, stats = jfq.apply({"quant_stats": stats}, jx[0], update_stats=True,
                             mutable=["quant_stats"])
        stats = stats["quant_stats"]
        tfq(tx[0])
        tfq.eval()
        for flag in (False, True):
            stats = jquant.mark_calibrated(stats, flag)
            tfq.calibrated.fill_(flag)
            jout = jfq.apply({"quant_stats": stats}, jx[1])
            tout = tfq(tx[1])
            assert tout.dtype == tdt
            np.testing.assert_array_equal(tout.float().numpy(), _np(jout).T)
            if not flag:  # pass-through until calibrated
                assert torch.equal(tout, tx[1])
    assert tout.dtype == tdt
    np.testing.assert_array_equal(tout.float().numpy(), _np(jout).T)
    _stats_equal(stats, tfq)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_fake_quantize_ste_gradient_matches_jax(scheme, dtype):
    """The straight-through gradient of sum(fq(x)^2) is jax.grad's."""
    w = (np.random.default_rng(1).standard_normal((6, 5)) * 2).astype(np.float32)
    jfq, tfq = _fq_pair(scheme)
    jx = jnp.asarray(w.T).astype(dtype)
    stats = jfq.init(jax.random.PRNGKey(0), jx, update_stats=True)["quant_stats"]

    def loss(x):
        out, _ = jfq.apply({"quant_stats": stats}, x, update_stats=True,
                           mutable=["quant_stats"])
        return jnp.sum(out.astype(jnp.float32) ** 2)

    ref = jax.grad(loss)(jx)
    tx = torch.from_numpy(w).to(getattr(torch, dtype)).requires_grad_(True)
    tfq.train()
    (tfq(tx).float() ** 2).sum().backward()
    np.testing.assert_array_equal(tx.grad.float().numpy(), _np(ref).T)


def test_fake_quantize_zero_point_is_fractional():
    """The asymmetric zero point is qmin - min / scale, not rounded (the
    trap of torch's fake_quantize_per_tensor_affine), and the gradient
    passes everywhere, outside the range too (it is one)."""
    x = torch.tensor([[-1.3, 0.7, 2.9]], requires_grad=True)
    fq = tquant.FakeQuantize(8, symmetric=False)
    fq.train()
    fq(x).sum().backward()
    zp = fq.zero_point.item()
    assert zp != round(zp)
    assert torch.equal(x.grad, torch.ones_like(x))


# ----- QuantDense and QuantConv1d ---------------------------------------------------


@pytest.mark.parametrize("layer", ["dense", "conv"])
def test_quant_layers_match_flax(layer):
    """A training forward of QuantDense (8 -> 6 features) and QuantConv1d
    (80 -> 6 channels, k 3, stride 2, pad 1), then the gradients of
    sum(out^2) for the weight and the input."""
    rng = np.random.default_rng(2)
    if layer == "dense":
        x = rng.standard_normal((2, 7, 8)).astype(np.float32)
        jl = jquant.QuantDense(6)
        tl = tquant.QuantDense(8, 6)
    else:
        x = rng.standard_normal((2, 9, 80)).astype(np.float32)
        jl = jquant.QuantConv1d(6, kernel_size=3, stride=2, padding=1)
        tl = tquant.QuantConv1d(80, 6, 3, stride=2, padding=1)
    variables = jl.init(jax.random.PRNGKey(3), jnp.asarray(x), train=True)
    params = jax.device_get(variables["params"])
    with torch.no_grad():
        kernel = np.array(params["kernel"])
        tl.weight.copy_(torch.from_numpy(kernel.T if kernel.ndim == 2
                                         else kernel.transpose(2, 1, 0)))
        tl.bias.copy_(torch.from_numpy(rng.standard_normal(6).astype(np.float32)))
    params = {"kernel": kernel, "bias": tl.bias.detach().numpy()}

    def loss(p, xx):
        out, stats = jl.apply({"params": p, "quant_stats": variables["quant_stats"]}, xx,
                              train=True, mutable=["quant_stats"])
        return jnp.sum(out ** 2), (out, stats["quant_stats"])

    (_, (jout, jstats)), (jg, jgx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    tl.train()
    tx = torch.from_numpy(x).requires_grad_(True)
    tout = tl(tx)
    (tout ** 2).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=0, atol=1e-6)
    _stats_equal(jstats["weight_quantizer"], tl.weight_quantizer)
    for key in ("scale", "zero_point"):
        np.testing.assert_allclose(getattr(tl.activation_quantizer, key).numpy(),
                                   np.asarray(jstats["activation_quantizer"][key]), rtol=1e-6)
    gw = tl.weight.grad.numpy()
    gw = gw.T if gw.ndim == 2 else gw.transpose(2, 1, 0)
    top = np.abs(np.asarray(jg["kernel"])).max()
    np.testing.assert_allclose(gw, np.asarray(jg["kernel"]), rtol=0, atol=1e-5 * top)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jgx)).max())


# ----- the tiny QAT model ------------------------------------------------------------


def _port_model(seed=0, **overrides):
    cfg = tquant.prepare_model_for_qat(VelocityASRConfig(**{**SMALL, **overrides}))
    return tmodel.create_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))


def _jax_model(**overrides):
    return jmodel.create_model(jquant.prepare_model_for_qat(
        jconfig.VelocityASRConfig(**{**SMALL, **overrides})))


# Under jax.jit, XLA turns the observers' division by the constant qmax
# (127, or 255 per tensor) into a multiplication by its rounded
# reciprocal, one ulp off the IEEE division that the port and the
# unjitted flax module compute: against a jitted JAX step (calibration,
# the Trainer) a weight observer agrees to within that ulp.
JIT_WEIGHT_RTOL = 2.0 ** -23


def _check_stats(jstats, port, act_rtol, weight_rtol=0.0):
    """Weight observers within weight_rtol relative (0: bit-equal),
    activation observers within act_rtol relative, flags equal, the same
    leaves."""
    ref = {k: np.asarray(v) for k, v in _flatten(jax.device_get(jstats))}
    ours = dict(_flatten(tquant.quant_stats_to_numpy(port)))
    assert set(ours) == set(ref)
    for key, value in ref.items():
        assert ours[key].shape == value.shape and ours[key].dtype == value.dtype, key
        if value.dtype == bool or ("weight_quantizer" in key and not weight_rtol):
            np.testing.assert_array_equal(ours[key], value, err_msg=str(key))
        else:
            rtol = weight_rtol if "weight_quantizer" in key else act_rtol
            np.testing.assert_allclose(ours[key], value, rtol=rtol, err_msg=str(key))


@pytest.fixture(scope="module")
def qat_pair():
    """The port's QAT model, its weights in the JAX QAT model's tree, and
    the JAX model's initial quant_stats."""
    port = _port_model()
    params = params_to_numpy(port)
    jm = _jax_model()
    stats = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 80)),
                    train=False)["quant_stats"]
    return port, params, jm, stats


def test_qat_params_tree_is_the_flax_tree(qat_pair):
    """The QAT model's state_dict maps onto the JAX QAT model's parameter
    tree (temporal_binding/conv/{kernel, bias}, every shape), and the
    observers are not in the state_dict."""
    port, params, jm, _ = qat_pair
    ref = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 80)))["params"]
    shapes = {k: np.shape(v) for k, v in _flatten(jax.device_get(ref))}
    assert {k: v.shape for k, v in _flatten(params)} == shapes
    assert ("temporal_binding", "conv", "kernel") in shapes
    assert not any("quantizer" in k for k in port.state_dict())
    assert set(float_params_tree(params)["temporal_binding"]) == {
        "conv_kernel", "conv_bias", "pos_encoding", "norm"}
    assert qat_params_tree(float_params_tree(params)).keys() == params.keys()


def test_qat_training_forward_and_gradients_match_jax(qat_pair):
    port, params, jm, stats = qat_pair
    mel = _mel(3)

    def loss(p):
        logits, mutated = jm.apply({"params": p, "quant_stats": stats}, jnp.asarray(mel),
                                   train=True, mutable=["quant_stats"])
        return jnp.sum(logits ** 2), (logits, mutated["quant_stats"])

    (_, (jlogits, jstats)), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    port.train()
    tquant.init_quant_stats(port)
    logits = port(torch.from_numpy(mel))
    grads = torch.autograd.grad((logits ** 2).sum(), list(port.parameters()))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=0,
                               atol=LOGITS_ATOL)
    _check_stats(jstats, port, ACT_STATS_RTOL)
    ref = dict(_flatten(jax.device_get(jgrads)))
    top = max(np.abs(g).max() for g in ref.values())
    with torch.no_grad():
        saved = [p.clone() for p in port.parameters()]
        for p, g in zip(port.parameters(), grads):
            p.copy_(g)
        ours = dict(_flatten(params_to_numpy(port)))
        for p, s in zip(port.parameters(), saved):
            p.copy_(s)
    assert set(ours) == set(ref)
    for key, value in ref.items():
        np.testing.assert_allclose(ours[key], value, rtol=0, atol=GRAD_REL * top,
                                   err_msg=str(key))


def test_qat_calibration_matches_jax(qat_pair):
    """calibrate_model over two batches of different lengths: ranges,
    scales and zero points; an uncalibrated eval forward is the float
    model's; the calibrated eval forward (observers frozen) within the
    logits tolerance of the JAX model's on the port's observers (on its
    own, one-ulp-apart scales an activation code may flip: 0.024 on a
    logit)."""
    port, params, jm, stats = qat_pair
    batches = [_mel(4), _mel(5, frames=48)]
    jcal = jquant.calibrate_model(jm, params, stats, batches, num_batches=2)
    tquant.init_quant_stats(port)
    port.eval()
    uncalibrated = port(torch.from_numpy(batches[0]))
    float_model = tmodel.create_model(VelocityASRConfig(**SMALL), device="cpu",
                                      generator=torch.Generator().manual_seed(0))
    assert torch.equal(uncalibrated, float_model(torch.from_numpy(batches[0])))
    tquant.calibrate_model(port, batches, num_batches=2)
    assert not port.training
    _check_stats(jcal, port, CALIB_RTOL, JIT_WEIGHT_RTOL)
    ref = jm.apply({"params": params, "quant_stats": tquant.quant_stats_to_numpy(port)},
                   jnp.asarray(batches[0]))
    out = port(torch.from_numpy(batches[0]))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=LOGITS_ATOL)
    assert (out - uncalibrated).abs().max() > 0  # quantization is active


def test_qat_quant_stats_only_outside_ssm(qat_pair):
    """The ssm_state_fp32 rule (JAX test_qat_quant_stats_only_outside_ssm):
    nothing under the SSM stacks is observed; the global context's
    attention, pools and fusion, the CTC head and the temporal conv are."""
    port = qat_pair[0]
    paths = {"/".join(k) for k, _ in _flatten(tquant.quant_stats_to_numpy(port))}
    assert not any("local_ssm" in p or "global_ssm" in p for p in paths)
    for prefix in ("global_context/cross_attention", "global_context/pool1",
                   "global_context/fusion", "ctc_head", "temporal_binding/conv"):
        assert any(p.startswith(prefix) for p in paths), prefix
    assert not any(isinstance(m, tquant.QuantDense)
                   for m in port.local_ssm.modules()) and not any(
        isinstance(m, tquant.QuantDense) for m in port.global_context.global_ssm.modules())


def test_qat_streaming_front_end_refuses():
    with pytest.raises(NotImplementedError, match="streaming QAT"):
        _port_model()(torch.zeros(1, 32, 80), return_state=True)


def test_prepare_model_for_qat_refuses_other_schemes():
    cfg = VelocityASRConfig(**SMALL)
    qcfg = tquant.prepare_model_for_qat(cfg, tquant.QuantizationConfig(weight_bits=4))
    assert qcfg.qat and qcfg.qat_weight_bits == 4 and qcfg.qat_activation_bits == 8
    assert qcfg.to_dict() == jquant.prepare_model_for_qat(
        jconfig.VelocityASRConfig(**SMALL), jquant.QuantizationConfig(weight_bits=4)).to_dict()
    for field in ("per_channel_weights", "symmetric_weights", "ssm_state_fp32"):
        with pytest.raises(NotImplementedError, match=field):
            tquant.prepare_model_for_qat(cfg, tquant.QuantizationConfig(**{field: False}))
    with pytest.raises(NotImplementedError, match="symmetric_activations"):
        tquant.prepare_model_for_qat(cfg, tquant.QuantizationConfig(symmetric_activations=True))
    assert dataclasses.asdict(tquant.QuantizationConfig()) == dataclasses.asdict(
        jquant.QuantizationConfig())


def test_model_size_accounting_matches_jax():
    """Full width: the port's parameter count gives the JAX sizes."""
    port = tmodel.create_model(VelocityASRConfig(), device="cpu")
    jm = jmodel.create_model(jconfig.VelocityASRConfig())
    params = jmodel.init_params(jm, jax.random.PRNGKey(0), example_frames=8)
    for bits in (32, 8):
        assert tquant.get_model_size_mb(port, bits) == jquant.get_model_size_mb(params, bits)


def test_quant_stats_msgpack_both_directions(qat_pair, tmp_path):
    """The observers written by the port read through flax's from_bytes
    into the JAX model's template (inf sentinels and bool flags kept), and
    a JAX-written file loads into the port's buffers."""
    port, params, jm, stats = qat_pair
    tquant.init_quant_stats(port)
    port.train()
    port(torch.from_numpy(_mel(6)))
    port.global_context.fusion.gate_proj.activation_quantizer.range_max.fill_(3.5)
    tquant.mark_calibrated(port)
    path = str(tmp_path / "quant_stats.msgpack")
    write_params(path, tquant.quant_stats_to_numpy(port))
    with open(path, "rb") as f:
        data = f.read()
    restored = flax.serialization.from_bytes(stats, data)
    _check_stats(restored, port, 0.0)
    leaves = dict(_flatten(jax.device_get(restored)))
    assert np.isinf(leaves[("ctc_head", "proj", "activation_quantizer", "range_min")])
    assert leaves[("ctc_head", "proj", "weight_quantizer", "calibrated")].dtype == bool
    # and back: a file flax wrote
    back = _port_model()
    with open(tmp_path / "jax.msgpack", "wb") as f:
        f.write(flax.serialization.to_bytes(jax.device_get(restored)))
    tquant.load_quant_stats(back, quant_stats_from_numpy(read_params(str(tmp_path /
                                                                        "jax.msgpack"))))
    for key, value in tquant.quant_stats_buffers(port).items():
        assert torch.equal(tquant.quant_stats_buffers(back)[key], value), key


# ----- the Trainer ---------------------------------------------------------------------


def _batch(seed, frames=64, lengths=(64, 50), target_lengths=(10, 7)):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((len(lengths), frames, 80)).astype(np.float32)
    for i, n in enumerate(lengths):
        mel[i, n:] = 0.0
    targets = np.full((len(lengths), 32), 2, np.int32)
    for i, n in enumerate(target_lengths):
        targets[i, :n] = rng.integers(3, 20, n)
    return {"mel_spectrogram": mel, "targets": targets,
            "input_lengths": np.asarray(lengths, np.int32),
            "target_lengths": np.asarray(target_lengths, np.int32)}


def test_qat_trainer_step_matches_jax_trainer(tmp_path):
    """One micro-step of the JAX Trainer and the port's on the same QAT
    weights and batch: the loss, the updated weights (those whose gradient
    exceeds 1e-5 within 1e-6, every weight within 2 lr: Adam's first step
    is lr * sign(g) where |g| >> 1e-8) and the refreshed observers. Then
    eval reads them unchanged, and the trainer checkpoint carries them."""
    port = _port_model(seed=1)
    params = params_to_numpy(port)
    kw = dict(learning_rate=1e-3, warmup_steps=2, max_steps=4, grad_clip_norm=1.0,
              weight_decay=0.01, log_interval=100)
    batch = _batch(1)
    jt = jtraining.Trainer(_jax_model(), jtraining.TrainingConfig(**kw), iter([batch]),
                           params=params)
    tt = ttraining.Trainer(port, ttraining.TrainingConfig(**kw), iter([batch]))
    ref, ours = jt.train_step(batch), tt.train_step(batch)
    np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=1e-5)
    _check_stats(jt.quant_stats, port, ACT_STATS_RTOL, JIT_WEIGHT_RTOL)
    lr = tt.optimizer.last_lr()
    grads_model = _port_model(seed=1)
    grads_model.train()
    loss = ttraining.Trainer(grads_model, ttraining.TrainingConfig(), iter(()))._loss(
        tt._to_device(batch), None)
    grads = dict(zip([n for n, _ in grads_model.named_parameters()],
                     torch.autograd.grad(loss, list(grads_model.parameters()))))
    with torch.no_grad():
        for n, p in grads_model.named_parameters():
            p.copy_(grads[n])
    big_grads = dict(_flatten(params_to_numpy(grads_model)))
    after = dict(_flatten(params_to_numpy(port)))
    for key, value in _flatten(jax.device_get(jt.params)):
        assert np.abs(after[key] - value).max() <= 2 * lr, key
        big = np.abs(big_grads[key]) > 1e-5
        np.testing.assert_allclose(after[key][big], value[big], rtol=0, atol=1e-6,
                                   err_msg=str(key))
    before = {k: v.clone() for k, v in tquant.quant_stats_buffers(port).items()}
    tt.eval_step(batch)
    for key, value in tquant.quant_stats_buffers(port).items():
        assert torch.equal(value, before[key]), key
    tt.save_checkpoint(str(tmp_path / "ckpt"))
    resumed = ttraining.Trainer(_port_model(seed=5), ttraining.TrainingConfig(**kw), iter(()))
    resumed.load_checkpoint(str(tmp_path / "ckpt"))
    for key, value in tquant.quant_stats_buffers(resumed.model).items():
        assert torch.equal(value, before[key]), key


@pytest.mark.parametrize("change,match", [
    ({"train": {"streaming_chunks": 200}}, "QAT \\+ the streaming-aware objective"),
    ({"model": {"moe_experts": 4}}, "QAT \\+ MoE"),
])
def test_qat_trainer_refusals(change, match):
    """The JAX Trainer's ValueErrors, raised when the Trainer is built."""
    model = _port_model()
    model.config = dataclasses.replace(model.config, **change.get("model", {}))
    with pytest.raises(ValueError, match=match):
        ttraining.Trainer(model, ttraining.TrainingConfig(**change.get("train", {})), iter(()))
    jm = _jax_model(**change.get("model", {}))
    with pytest.raises(ValueError, match=match):
        jtraining.Trainer(jm, jtraining.TrainingConfig(**change.get("train", {})), iter(()))


def test_gradient_checkpointing_leaves_qat_observers_alone(monkeypatch):
    """The quantizers sit outside the local SSM blocks that
    CheckpointedBlock replays: with gradient checkpointing a QAT micro-step
    replays every block, refreshes each observer once (the replay runs no
    quantizer) and gives the plain step's loss, gradients and observers."""
    calls = []
    forward = tquant.FakeQuantize.forward
    monkeypatch.setattr(tquant.FakeQuantize, "forward",
                        lambda self, x: calls.append(1) or forward(self, x))
    remat = []
    apply = tssm.CheckpointedBlock.apply
    monkeypatch.setattr(tssm.CheckpointedBlock, "apply",
                        staticmethod(lambda *a: remat.append(1) or apply(*a)))
    results = []
    for checkpointing in (False, True):
        model = _port_model(seed=2, ssm_layers=2, gradient_checkpointing=checkpointing)
        trainer = ttraining.Trainer(model, ttraining.TrainingConfig(), iter(()))
        model.train()
        calls.clear()
        loss = trainer._loss(trainer._to_device(_batch(2)), None)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        results.append((loss, grads, len(calls), tquant.quant_stats_buffers(model)))
    (loss_a, grads_a, calls_a, stats_a), (loss_b, grads_b, calls_b, stats_b) = results
    assert len(remat) == 2 and calls_a == calls_b == len(tquant.fake_quantizers(model))
    assert torch.equal(loss_a, loss_b)
    for a, b in zip(grads_a, grads_b):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    for key, value in stats_a.items():
        assert torch.equal(stats_b[key], value), key


# ----- the train CLI -------------------------------------------------------------------


SMALL_MODEL_YAML = (
    "model:\n  d_model: 16\n  dropout: 0.0\nssm:\n  num_layers: 1\n  state_dim: 4\n"
    "global_context:\n  ssm_layers: 1\n  ssm_state_dim: 4\n  attention_heads: 2\n"
    "  attention_dim: 8\noutput:\n  vocab_size: 20\n")


def _train_yaml(tmp_path, quantization):
    path = tmp_path / "train.yaml"
    path.write_text("training:\n  batch_size: 2\n  max_steps: 2\n  use_amp: false\n"
                    "optimizer:\n  warmup_steps: 1\nlogging:\n  log_interval: 1\n"
                    f"quantization:\n{quantization}")
    return str(path)


def _cli(tmp_path, quantization, *extra, run="run"):
    model_yaml = tmp_path / "model.yaml"
    model_yaml.write_text(SMALL_MODEL_YAML)
    return ttrain.main(["--config", _train_yaml(tmp_path, quantization), "--model-config",
                        str(model_yaml), "--max-steps", "2", "--num-workers", "0",
                        "--device", "cpu", "--checkpoint-dir", str(tmp_path / run), *extra])


def test_train_cli_qat_on_dummy_data(tmp_path):
    """quantization.enabled on dummy data: a QAT run whose final_pretrained
    is the float model (qat false, conv_kernel / conv_bias, the trained
    weights), loadable by both packages, with the trained observers in
    quant_stats.msgpack; the trainer checkpoint keeps the QAT config."""
    out = _cli(tmp_path, "  enabled: true\n  start_step: 100\n  weight_bits: 8\n")
    trainer = out["trainer"]
    assert trainer.model.config.qat and all(np.isfinite(out["history"]["train_loss"]))
    pretrained = tmp_path / "run" / "final_pretrained"
    cfg = json.loads((pretrained / "config.json").read_text())["config"]
    assert cfg["qat"] is False and cfg["vocab_size"] == 20
    meta = json.loads((tmp_path / "run" / "final_model" / "trainer_meta.json").read_text())
    assert meta["model_config"]["qat"] is True
    tree = read_params(str(pretrained / "params.msgpack"))
    assert "conv_kernel" in tree["temporal_binding"] and "conv" not in tree["temporal_binding"]
    loaded = tmodel.from_pretrained(str(pretrained), device="cpu")
    for key, value in trainer.model.state_dict().items():
        assert torch.equal(loaded.state_dict()[key], value), key
    jm, jparams = jmodel.from_pretrained(str(pretrained))
    assert not jm.config.qat
    stats = read_params(str(pretrained / "quant_stats.msgpack"))
    template = _jax_model().init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 80)))["quant_stats"]
    with open(pretrained / "quant_stats.msgpack", "rb") as f:
        flax.serialization.from_bytes(template, f.read())
    for key, value in quant_stats_from_numpy(stats).items():
        assert torch.equal(value, tquant.quant_stats_buffers(trainer.model)[key]), key


def test_train_cli_unknown_quantization_key_raises(tmp_path):
    with pytest.raises(ValueError, match="unknown quantization config keys: \\['bogus'\\]"):
        _cli(tmp_path, "  enabled: true\n  bogus: 1\n")


def test_train_cli_init_from_float_into_qat(tmp_path):
    """--init-from a float checkpoint into a QAT run: the float tree's
    conv_kernel / conv_bias land in the QAT model's conv (the JAX CLI's
    renesting), every weight as saved."""
    float_model = tmodel.create_model(VelocityASRConfig(**SMALL), device="cpu",
                                      generator=torch.Generator().manual_seed(9))
    tmodel.save_pretrained(str(tmp_path / "float"), float_model.config, float_model)
    seen = {}
    step = ttraining.Trainer._step

    def first_step(self, batch):
        if not seen:
            seen.update({k: v.clone() for k, v in self.model.state_dict().items()})
        return step(self, batch)

    ttraining.Trainer._step = first_step
    try:
        _cli(tmp_path, "  enabled: true\n", "--init-from", str(tmp_path / "float"))
    finally:
        ttraining.Trainer._step = step
    tree = qat_params_tree(read_params(str(tmp_path / "float" / "params.msgpack")))
    assert set(tree["temporal_binding"]["conv"]) == {"kernel", "bias"}
    np.testing.assert_array_equal(
        seen["temporal_binding.conv.weight"].numpy(),
        tree["temporal_binding"]["conv"]["kernel"].transpose(2, 1, 0))
    for key, value in float_model.state_dict().items():
        assert torch.equal(seen[key], value), key
