"""Export in the port against the JAX package, on the CPU, at the JAX
``tests/test_export.py`` size (d_model 16, 1 + 1 SSM blocks, N = 4,
vocabulary 24):

- the int8 weight package in both directions: one written by the port
  loads through the JAX ``load_int8_model`` and one written by the JAX
  package through the port's; the ``weights_int8.npz`` key sets are
  identical and the arrays bit-equal, the size info equal, the
  calibrated ``quant_stats.msgpack`` read by ``flax.serialization``; every
  quantized leaf's codes are ``ops.int8_matmul.quantize_weight``'s, and a
  loaded static model requantizes onto them; no SSM weight is quantized;
  the loaded static model's logits within 1e-4 of the JAX package's on
  the same package;
- ``selective_scan_parallel`` against the JAX function at 1e-5, with and
  without a carried state;
- the ``.pt2`` program against the eager port at 1e-5, its graph growing
  by a few nodes, not by L, when L doubles, int8 and QAT configs
  normalised away, eager calls unharmed after an export;
- ``export_model --quantize --calibrate synthetic --verify`` on a tiny
  checkpoint, and ``--tflite`` refused.
"""

import dataclasses
import json
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velocity_asr_tpu import export as jexport
from velocity_asr_tpu import quantize as jquant
from velocity_asr_tpu.models import config as jconfig
from velocity_asr_tpu.models import model as jmodel
from velocity_asr_tpu.ops import scan as jscan
from velocity_asr_tpu_torch import export as texport
from velocity_asr_tpu_torch import export_model as texport_model
from velocity_asr_tpu_torch import quantize as tquant
from velocity_asr_tpu_torch.checkpoint import _flatten, params_to_numpy, read_params
from velocity_asr_tpu_torch.models import model as tmodel
from velocity_asr_tpu_torch.models.config import VelocityASRConfig
from velocity_asr_tpu_torch.ops import scan as tscan
from velocity_asr_tpu_torch.ops.int8_matmul import quantize_weight

TINY = dict(d_model=16, ssm_layers=1, ssm_state_dim=4, global_ssm_layers=1,
            global_ssm_state_dim=4, attention_heads=2, attention_dim=8, vocab_size=24,
            dropout=0.0)
N_INT8_LAYERS = 11


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: several test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tiny():
    """The port's tiny float model and its flax parameter tree."""
    model = tmodel.create_model(VelocityASRConfig(**TINY), device="cpu",
                                generator=torch.Generator().manual_seed(3))
    return model, params_to_numpy(model)


def _mel(seed, batch=1, frames=64):
    return np.random.default_rng(seed).standard_normal((batch, frames, 80)).astype(np.float32)


def _static_model(model):
    static = tmodel.create_model(dataclasses.replace(model.config, int8_inference=True,
                                                     int8_static=True), device="cpu")
    static.load_state_dict(model.state_dict())
    return static


def _calibrated(model):
    return tquant.calibrate_int8_model(_static_model(model), [_mel(5), _mel(6, frames=48)])


def _jax_static():
    return jmodel.create_model(jconfig.VelocityASRConfig(**TINY, int8_inference=True,
                                                         int8_static=True))


def _npz(path):
    with np.load(os.path.join(path, "weights_int8.npz")) as data:
        return {k: data[k] for k in data.files}


# ----- the int8 weight package ------------------------------------------------------


def test_quantize_weights_int8_matches_jax(tiny):
    """The same tree, codes, scales and size info as the JAX function."""
    _, params = tiny
    ours, info = texport.quantize_weights_int8(params)
    ref, ref_info = jexport.quantize_weights_int8(params)
    assert info == ref_info and info["quantized_tensors"] > 0
    ref = dict(_flatten(jax.device_get(ref)))
    ours = dict(_flatten(ours))
    assert list(ours) == list(ref)
    for key, value in ref.items():
        assert ours[key].dtype == value.dtype, key
        np.testing.assert_array_equal(ours[key], value, err_msg=str(key))
    deq = dict(_flatten(texport.dequantize_weights(texport.quantize_weights_int8(params)[0])))
    for key, value in _flatten(jexport.dequantize_weights(jexport.quantize_weights_int8(
            params)[0])):
        np.testing.assert_array_equal(deq[key], np.asarray(value), err_msg=str(key))


@pytest.mark.parametrize("calibrated", [False, True])
def test_port_package_equals_jax_package(tiny, tmp_path, calibrated):
    """The port and the JAX package write the same package from the same
    weights (and the port's calibrated stats): identical npz keys, arrays
    bit-equal, the same config.json; each loads through the other's
    load_int8_model."""
    model, params = tiny
    stats = _calibrated(model) if calibrated else None
    tree = None if stats is None else tquant.quant_stats_to_numpy(stats)
    info = texport.save_int8_checkpoint(str(tmp_path / "port"), model.config, params, tree)
    ref_info = jexport.save_int8_checkpoint(str(tmp_path / "jax"), jconfig.VelocityASRConfig(
        **TINY), params, quant_stats=tree)
    assert info == ref_info and info.get("calibrated", False) == calibrated
    ours, ref = _npz(str(tmp_path / "port")), _npz(str(tmp_path / "jax"))
    assert list(ours) == list(ref)
    for key, value in ref.items():
        assert ours[key].dtype == value.dtype, key
        np.testing.assert_array_equal(ours[key], value, err_msg=key)
    meta = [json.loads((tmp_path / d / "config.json").read_text()) for d in ("port", "jax")]
    assert meta[0] == meta[1] and meta[0]["format"] == "int8-v1"
    assert meta[0]["config"]["int8_static"] == calibrated
    jm, jparams, jstats = jexport.load_int8_model(str(tmp_path / "port"))
    assert jm.config.int8_static == calibrated and (jstats is None) == (not calibrated)
    back = texport.load_int8_model(str(tmp_path / "jax"), device="cpu")
    assert back.config.int8_static == calibrated
    ours_params = dict(_flatten(params_to_numpy(back)))
    for key, value in _flatten(jax.device_get(jparams)):
        np.testing.assert_array_equal(ours_params[key], value, err_msg=str(key))
    if calibrated:
        jleaves = dict(_flatten(jax.device_get(jstats)))
        for key, value in _flatten(tquant.quant_stats_to_numpy(back)):
            np.testing.assert_array_equal(value, np.asarray(jleaves[key]), err_msg=str(key))
        with open(tmp_path / "port" / "quant_stats.msgpack", "rb") as f:
            template = jax.jit(lambda x: _jax_static().init(
                {"params": jax.random.PRNGKey(0)}, x))(jnp.zeros((1, 64, 80)))["quant_stats"]
            restored = flax.serialization.from_bytes(template, f.read())
        assert len(dict(_flatten(jax.device_get(restored)))) == 2 * N_INT8_LAYERS


def test_jax_calibrated_package_runs_in_the_port(tiny, tmp_path):
    """A package the JAX package calibrated and wrote: the port loads its
    stats exactly, and its static int8 logits are the JAX package's on the
    same package within 1e-4."""
    _, params = tiny
    jm = _jax_static()
    stats = jax.jit(lambda x: jm.init({"params": jax.random.PRNGKey(0)}, x))(
        jnp.zeros((1, 64, 80)))["quant_stats"]
    observe = jax.jit(lambda s, x: jm.apply({"params": params, "quant_stats": s}, x,
                                             mutable=["quant_stats"])[1]["quant_stats"])
    for batch in (_mel(5), _mel(6, frames=48)):
        stats = observe(stats, jnp.asarray(batch))
    stats = jax.device_get(jquant.mark_calibrated(stats))
    path = str(tmp_path / "jax")
    jexport.save_int8_checkpoint(path, jconfig.VelocityASRConfig(**TINY), params,
                                 quant_stats=stats)
    port = texport.load_int8_model(path, device="cpu")
    leaves = dict(_flatten(stats))
    for key, value in _flatten(tquant.quant_stats_to_numpy(port)):
        np.testing.assert_array_equal(value, np.asarray(leaves[key]), err_msg=str(key))
    jm2, jparams, jstats = jexport.load_int8_model(path)
    mel = _mel(7)
    ref = np.asarray(jmodel.forward(jm2, jparams, jnp.asarray(mel), quant_stats=jstats))
    out = tmodel.forward(port, torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_package_codes_are_the_runtime_grid(tiny, tmp_path):
    """Every quantized Dense leaf's codes and scales are quantize_weight's
    on the float weight, and a loaded static model's requantized codes
    are the package's (scales within an ulp: amax of the dequantized
    weight is 127 * scale, rounded)."""
    model, _ = tiny
    path = str(tmp_path / "pkg")
    texport.save_int8_checkpoint(path, model.config, params_to_numpy(model),
                                 tquant.quant_stats_to_numpy(_calibrated(model)))
    arrays = _npz(path)
    loaded = texport.load_int8_model(path, device="cpu")
    checked = 0
    for name, module in model.named_modules():
        if not isinstance(module, torch.nn.Linear):
            continue
        key = name.replace("layers.", "layers_").replace(".", "/") + "/kernel"
        if key + ".int8" not in arrays:
            continue
        codes, scale = quantize_weight(module.weight)
        np.testing.assert_array_equal(arrays[key + ".int8"], codes.numpy().T)
        np.testing.assert_array_equal(arrays[key + ".scale"], scale.numpy()[None])
        int8_layer = loaded.get_submodule(name)
        assert torch.equal(int8_layer.w_q, codes)
        torch.testing.assert_close(int8_layer.w_scale, scale, rtol=2.0 ** -23, atol=0)
        checked += 1
    assert checked == N_INT8_LAYERS


def test_ssm_weights_not_quantized(tiny):
    """Only matrices outside the SSM blocks are quantized: the 11
    projections and the temporal-binding conv."""
    _, params = tiny
    qtree, info = texport.quantize_weights_int8(params)
    quantized = ["/".join(k[:-1]) for k, _ in _flatten(qtree) if k[-1] == "int8"]
    assert not any("ssm" in k for k in quantized)
    assert len(quantized) == info["quantized_tensors"] == N_INT8_LAYERS + 1
    assert "temporal_binding/conv_kernel" in quantized
    assert any("ssm" in "/".join(k) for k, _ in _flatten(qtree))


# ----- the exported program -----------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True])
def test_selective_scan_parallel_matches_jax(with_state):
    rng = np.random.default_rng(4)
    b, length, d, n = 2, 37, 6, 4
    x = rng.standard_normal((b, length, d)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, length, d)))).astype(np.float32) * 0.5
    a = -np.arange(1, n + 1, dtype=np.float32)
    bb, cc = (rng.standard_normal((b, length, n)).astype(np.float32) for _ in range(2))
    dd = rng.standard_normal(d).astype(np.float32)
    h0 = rng.standard_normal((b, d, n)).astype(np.float32) if with_state else None
    ref = jscan.selective_scan_parallel(*map(jnp.asarray, (x, dt, a, bb, cc, dd)),
                                        h0=None if h0 is None else jnp.asarray(h0),
                                        return_state=True)
    out = tscan.selective_scan_parallel(*map(torch.from_numpy, (x, dt, a, bb, cc, dd)),
                                        h0=None if h0 is None else torch.from_numpy(h0),
                                        return_state=True)
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the "associative" mode dispatches to it
    y = tscan.selective_scan(*map(torch.from_numpy, (x, dt, a, bb, cc, dd)),
                             mode="associative")
    np.testing.assert_allclose(y.numpy(), np.asarray(ref[0]) if h0 is None else
                               tscan.selective_scan_parallel(
                                   *map(torch.from_numpy, (x, dt, a, bb, cc, dd))).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_exported_program_matches_eager(tiny, tmp_path):
    """The .pt2 program against the eager port (its plain scan) at 1e-5;
    eager forwards after the export are unharmed (the traced cache entries
    are dropped); the graph grows by a few nodes a doubling of L, not by
    L (log-depth scan)."""
    model, _ = tiny
    mel = torch.from_numpy(_mel(8, batch=2))
    live = tmodel.forward(model, mel)
    sizes = []
    for frames in (64, 128):
        path = texport.export_program(model, str(tmp_path / f"m{frames}.pt2"), (2, frames, 80))
        sizes.append(len(torch.export.load(path).graph.nodes))
    out = texport.load_exported(str(tmp_path / "m64.pt2"))(mel)
    np.testing.assert_allclose(out.detach().numpy(), live.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(tmodel.forward(model, mel), live)
    assert 0 < sizes[1] - sizes[0] < 40  # 32 -> 64 output frames: one more step a block


@pytest.mark.parametrize("flags", [{"int8_inference": True, "int8_static": True},
                                   {"qat": True}])
def test_export_normalizes_int8_and_qat_flags(tiny, tmp_path, flags):
    """An int8 or QAT checkpoint exports its float graph: the program runs
    the float model's function on the same weights."""
    model, _ = tiny
    other = tmodel.create_model(dataclasses.replace(model.config, **flags), device="cpu")
    other.load_state_dict(model.state_dict())
    path = texport.export_program(other, str(tmp_path / "m.pt2"), (1, 64, 80))
    mel = torch.from_numpy(_mel(9))
    out = texport.load_exported(path)(mel)
    np.testing.assert_allclose(out.detach().numpy(), tmodel.forward(model, mel).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_export_model_cli(tiny, tmp_path):
    """--quantize --calibrate synthetic --verify on a tiny checkpoint: the
    program verifies, the package is calibrated and runs the static int8
    path."""
    model, _ = tiny
    ckpt = str(tmp_path / "ckpt")
    tmodel.save_pretrained(ckpt, model.config, model)
    out_dir = tmp_path / "export"
    out = texport_model.main(["--checkpoint", ckpt, "--output-dir", str(out_dir), "--frames",
                              "64", "--quantize", "--calibrate", "synthetic",
                              "--calibrate-batches", "2", "--calibrate-batch-size", "2",
                              "--verify", "--device", "cpu"])
    assert out["verify"]["max_abs"] <= 1e-3 and out["verify"]["argmax_agreement"] >= 0.99
    assert out["int8"]["calibrated"] and (out_dir / "velocity_asr.pt2").exists()
    package = texport.load_int8_model(str(out_dir / "int8"), device="cpu")
    layers = [m for m in package.modules() if isinstance(m, tquant.DynamicInt8Dense)]
    assert len(layers) == N_INT8_LAYERS and all(m.static and bool(m.calibrated)
                                                for m in layers)
    assert read_params(str(out_dir / "int8" / "quant_stats.msgpack"))
    assert np.isfinite(tmodel.forward(package, torch.from_numpy(_mel(1))).numpy()).all()


def test_export_model_tflite_refuses(tiny, tmp_path):
    """No TFLite converter: --tflite exits non-zero, saying so, and writes
    nothing."""
    model, _ = tiny
    ckpt = str(tmp_path / "ckpt")
    tmodel.save_pretrained(ckpt, model.config, model)
    with pytest.raises(SystemExit) as exc:
        texport_model.main(["--checkpoint", ckpt, "--output-dir", str(tmp_path / "out"),
                            "--tflite", "--device", "cpu"])
    assert exc.value.code not in (0, None) and "TFLite" in str(exc.value.code)
    assert not (tmp_path / "out").exists()
