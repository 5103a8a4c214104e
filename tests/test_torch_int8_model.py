"""The int8 model (int8_inference, int8_static) of the port against the
JAX package's, on the committed checkpoint and on a tiny config.

Tolerances. Every int8 layer matches the flax one exactly on the same
input (tests/test_torch_int8.py), but the two models' fp32 activations
differ by a few ulps upstream (other summation orders), and an
activation that sits near a rounding boundary then takes the next int8
code: one quantization step on its row's outputs. A 1e-7 relative
change of the mel moves the int8 model's logits by about 0.05, so an
absolute bound of 1e-3 (which the fp32 model meets) cannot hold for the
int8 one. The bounds are therefore:
  - fp32 compute: argmax agreement >= 99%, and the port's int8 logits at
    most half as far from the JAX package's int8 logits as from its own
    unquantized logits (they follow JAX's quantization, not just any);
  - bf16 compute: argmax agreement >= 99%;
  - JAX-calibrated static scales carried by quant_stats_from_numpy: the
    port's buffers equal the JAX stats exactly, logits as for fp32;
  - calibration itself on a tiny bf16 config (three batches offered, two
    taken): every x_amax within one bf16 ulp of the JAX package's.
"""

import json

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velocity_asr_tpu import quantize as jquant
from velocity_asr_tpu.audio import compute_mel_spectrogram_np
from velocity_asr_tpu.models import config as jconfig
from velocity_asr_tpu.models import model as jmodel
from velocity_asr_tpu_torch import quantize as tquant
from velocity_asr_tpu_torch import synth as tsynth
from velocity_asr_tpu_torch.checkpoint import params_from_numpy, quant_stats_from_numpy
from velocity_asr_tpu_torch.models import model as tmodel
from velocity_asr_tpu_torch.models.config import VelocityASRConfig

CKPT = "checkpoints/synth_run/final_pretrained"
N_INT8_LAYERS = 11  # 10 in the global context, 1 in the CTC head


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU ops: with several test
    workers on the same cores, torch's thread pool otherwise spends most
    of its time waiting at barriers (a 1-second evaluation took 2 minutes
    under 3 workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mel():
    """Two held-out utterances, host mel, padded to 200 frames."""
    out = np.zeros((2, 200, 80), np.float32)
    for i in range(2):
        m = compute_mel_spectrogram_np(tsynth.utterance(i)[1])[:200]
        out[i, : m.shape[0]] = m
    return out


@pytest.fixture(scope="module")
def jax_params():
    """The checkpoint's flax params (the tree is the same for every dtype
    and int8 option), restored without the op-by-op init from_pretrained
    runs for its template."""
    with open(f"{CKPT}/params.msgpack", "rb") as f:
        return flax.serialization.msgpack_restore(f.read())


@pytest.fixture(scope="module")
def logits32(mel):
    """The port's unquantized fp32 logits: what int8 is measured from."""
    return _logits(_port(dtype="float32"), mel)


def _jax_model(**overrides):
    with open(f"{CKPT}/config.json") as f:
        cfg = json.load(f)["config"]
    return jmodel.create_model(jconfig.VelocityASRConfig.from_dict(
        dict(cfg, scan_mode="sequential", **overrides)))


def _jax_logits(jm, params, mel, quant_stats=None):
    fwd = jax.jit(lambda p, x, s: jmodel.forward(jm, p, x, quant_stats=s))
    return np.asarray(fwd(params, jnp.asarray(mel), quant_stats))


def _port(**overrides):
    return tmodel.from_pretrained(CKPT, device="cpu", **overrides)


def _logits(model, mel):
    return tmodel.forward(model, torch.from_numpy(mel)).numpy()


def _int8_layers(model):
    return [m for m in model.modules() if isinstance(m, tquant.DynamicInt8Dense)]


def test_int8_dynamic_checkpoint_logits_match_jax(mel, jax_params, logits32):
    ref8 = _jax_logits(_jax_model(dtype="float32", int8_inference=True), jax_params, mel)
    port8 = _port(dtype="float32", int8_inference=True)
    assert len(_int8_layers(port8)) == N_INT8_LAYERS
    assert not any(m.static for m in _int8_layers(port8))
    out8 = _logits(port8, mel)
    assert out8.shape == ref8.shape == (2, 100, 30)
    assert (out8.argmax(-1) == ref8.argmax(-1)).mean() >= 0.99
    assert np.abs(out8 - ref8).max() <= 0.5 * np.abs(out8 - logits32).max()


def test_int8_dynamic_checkpoint_bf16_argmax_matches_jax(mel, jax_params):
    ref = _jax_logits(_jax_model(int8_inference=True), jax_params, mel)  # the checkpoint's bf16
    port = _port(int8_inference=True)
    assert port.config.compute_dtype == torch.bfloat16
    out = _logits(port, mel)
    assert np.isfinite(out).all()
    assert (out.argmax(-1) == ref.argmax(-1)).mean() >= 0.99


def _jax_calibrate(jm, params, batches):
    """The JAX package's calibrate_int8_model, step for step (init the
    quant_stats collection, eval forwards with it mutable, mark it
    calibrated), with the init jitted: unjitted, as that function runs
    it, it costs tens of seconds of op-by-op compiles on the CPU."""
    stats = jax.jit(lambda x: jm.init({"params": jax.random.PRNGKey(0)}, x, train=False))(
        jnp.zeros((1, 64, jm.config.mel_bins)))["quant_stats"]
    observe = jax.jit(lambda s, x: jm.apply({"params": params, "quant_stats": s}, x,
                                             train=False, mutable=["quant_stats"])[1])
    for batch in batches:
        stats = observe(stats, jnp.asarray(batch))["quant_stats"]
    return jax.device_get(jquant.mark_calibrated(stats))


def test_int8_static_with_jax_calibrated_stats_matches_jax(mel, jax_params, logits32):
    jm = _jax_model(dtype="float32", int8_inference=True, int8_static=True)
    stats = _jax_calibrate(jm, jax_params, [mel[:1], mel[1:]])
    ref = _jax_logits(jm, jax_params, mel, stats)

    port = _port(dtype="float32", int8_inference=True, int8_static=True)
    carried = quant_stats_from_numpy(stats)
    assert len(carried) == 2 * N_INT8_LAYERS
    tquant.load_quant_stats(port, carried)
    for name, layer in port.named_modules():
        if isinstance(layer, tquant.DynamicInt8Dense):
            assert layer.static and bool(layer.calibrated)
            assert layer.x_amax.item() == carried[f"{name}.x_amax"].item() > 0
    out = _logits(port, mel)
    assert (out.argmax(-1) == ref.argmax(-1)).mean() >= 0.99
    assert np.abs(out - ref).max() <= 0.5 * np.abs(out - logits32).max()
    with pytest.raises(KeyError):
        tquant.load_quant_stats(port, dict(list(carried.items())[1:]))


def _bf16_ulp(v):
    return 2.0 ** (np.floor(np.log2(np.abs(v))) - 7)


def test_calibration_matches_jax_on_a_tiny_config():
    cfg = jconfig.VelocityASRConfig(
        d_model=32, ssm_layers=2, ssm_state_dim=8, global_ssm_layers=1,
        global_ssm_state_dim=4, attention_heads=4, attention_dim=16, vocab_size=30,
        scan_mode="parallel", dtype="bfloat16", int8_inference=True, int8_static=True)
    jm = jmodel.create_model(cfg)
    params = jax.device_get(jax.jit(lambda key: jmodel.init_params(jm, key, example_frames=64))(
        jax.random.PRNGKey(5)))
    rng = np.random.default_rng(5)
    batches = [rng.standard_normal((2, 64, 80)).astype(np.float32) for _ in range(3)]
    stats = quant_stats_from_numpy(_jax_calibrate(jm, params, batches[:2]))

    port = tmodel.create_model(VelocityASRConfig.from_dict(dict(cfg.to_dict(),
                                                                scan_mode="pallas")),
                               device="cpu")
    port.load_state_dict(params_from_numpy(params), strict=True)
    tquant.calibrate_int8_model(port, batches, num_batches=2)
    layers = dict(port.named_modules())
    assert len(stats) == 2 * N_INT8_LAYERS
    for key, value in stats.items():
        name, leaf = key.rsplit(".", 1)
        got = getattr(layers[name], leaf)
        if leaf == "calibrated":
            assert bool(got) and bool(value)
        else:
            want = value.item()
            assert want > 0
            assert abs(got.item() - want) <= _bf16_ulp(want), key
