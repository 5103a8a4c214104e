"""The port's msgpack reader and weight mapping (checkpoint.py), and the
config it loads (models/config.py), against flax and the JAX package."""

import json

import flax.serialization
import jax
import msgpack
import numpy as np
import pytest
import torch

from velocity_asr_tpu.models import config as jconfig
from velocity_asr_tpu.models import model as jmodel
from velocity_asr_tpu_torch import checkpoint as tckpt
from velocity_asr_tpu_torch.models import model as tmodel
from velocity_asr_tpu_torch.models.config import VelocityASRConfig

CKPT = "checkpoints/synth_run/final_pretrained"


def test_reader_matches_flax_on_committed_checkpoint():
    path = f"{CKPT}/params.msgpack"
    ours = tckpt.read_params(path)
    with open(path, "rb") as f:
        ref = flax.serialization.msgpack_restore(f.read())
    ours_leaves = jax.tree_util.tree_leaves_with_path(ours)
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert len(ours_leaves) == len(ref_leaves) == 207
    for (p_ours, a), (p_ref, b) in zip(ours_leaves, ref_leaves):
        assert p_ours == p_ref
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1,
    None, True, False, 1.5, -2.25e300, "", "x" * 31, "y" * 32, "z" * 300, "é" * 40000,
    b"", b"\x01" * 300, b"\x02" * 70000,
    [], list(range(15)), list(range(16)), list(range(70000)),
    {}, {str(i): i for i in range(15)}, {str(i): [i, None] for i in range(20)},
])
def test_reader_decodes_msgpack_types(value):
    data = msgpack.packb(value, use_bin_type=True)
    assert tckpt.read_msgpack(data) == value


def test_reader_decodes_single_precision_float():
    data = msgpack.packb(1.25, use_single_float=True)
    assert data[0] == 0xCA and tckpt.read_msgpack(data) == 1.25


@pytest.mark.parametrize("arr", [
    np.arange(6, dtype=np.float32).reshape(2, 3),
    np.zeros((0, 4), np.float32),
    np.arange(5, dtype=np.int32),
    np.array(3.5, np.float64),
    np.float32(2.5),  # a numpy scalar leaf (ext type 3)
])
def test_reader_decodes_flax_array_leaves(arr):
    data = flax.serialization.msgpack_serialize({"a": {"b": arr}})
    out = tckpt.read_msgpack(data)["a"]["b"]
    ref = flax.serialization.msgpack_restore(data)["a"]["b"]
    assert type(out) is type(ref)
    np.testing.assert_array_equal(out, ref)
    assert np.asarray(out).dtype == np.asarray(ref).dtype


def test_reader_rejects_trailing_and_truncated_data():
    data = msgpack.packb([1, 2, 3])
    with pytest.raises(ValueError, match="trailing"):
        tckpt.read_msgpack(data + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        tckpt.read_msgpack(data[:-1])


def _small_jax_config(**kw):
    base = dict(d_model=32, ssm_layers=2, ssm_state_dim=8, global_ssm_layers=2,
                global_ssm_state_dim=4, attention_heads=4, attention_dim=16,
                vocab_size=30, mel_bins=80, scan_mode="sequential")
    base.update(kw)
    return jconfig.VelocityASRConfig(**base)


def test_params_from_numpy_maps_a_random_init_model():
    cfg = _small_jax_config()
    params = jax.device_get(jmodel.init_params(jmodel.create_model(cfg), jax.random.PRNGKey(3),
                                               example_frames=16))
    sd = tckpt.params_from_numpy(params)
    port = tmodel.create_model(VelocityASRConfig.from_dict(cfg.to_dict()), device="cpu")
    port.load_state_dict(sd, strict=True)  # every key present, every shape right

    ssm = params["local_ssm"]["layers_1"]
    np.testing.assert_array_equal(sd["local_ssm.layers.1.ssm.in_proj.weight"].numpy(),
                                  ssm["ssm"]["in_proj"]["kernel"].T)
    np.testing.assert_array_equal(sd["local_ssm.layers.1.conv.weight"].numpy(),
                                  ssm["conv_kernel"].transpose(2, 1, 0))
    np.testing.assert_array_equal(sd["local_ssm.layers.1.norm1.weight"].numpy(),
                                  ssm["norm1"]["scale"])
    tb = params["temporal_binding"]
    np.testing.assert_array_equal(sd["temporal_binding.conv.weight"].numpy(),
                                  tb["conv_kernel"].transpose(2, 1, 0))
    assert sd["temporal_binding.conv.weight"].shape == (32, 80, 3)
    assert sd["local_ssm.layers.0.conv.weight"].shape == (32, 1, 4)
    assert sd["ctc_head.proj.weight"].shape == (30, 32)
    n_ours = sum(v.numel() for v in port.state_dict().values())
    assert n_ours == jmodel.count_parameters(params)


def test_config_from_dict_matches_jax():
    with open(f"{CKPT}/config.json") as f:
        d = json.load(f)["config"]
    ours, ref = VelocityASRConfig.from_dict(d), jconfig.VelocityASRConfig.from_dict(d)
    assert ours.to_dict() == ref.to_dict()
    assert ours.d_inner == ref.d_inner == 384
    assert ours.compute_dtype == torch.bfloat16
    d2 = dict(d, scan_mode="mamba", unknown_key=1, dtype="float32")
    assert VelocityASRConfig.from_dict(d2).scan_mode == "pallas"
    assert VelocityASRConfig.from_dict(d2).compute_dtype == torch.float32
    assert VelocityASRConfig().to_dict() == jconfig.VelocityASRConfig().to_dict()


def test_from_pretrained_loads_committed_checkpoint_and_overrides():
    model = tmodel.from_pretrained(CKPT, device="cpu", scan_mode="sequential")
    assert model.config.scan_mode == "sequential" and model.config.vocab_size == 30
    assert sum(p.numel() for p in model.parameters()) == 5_985_486
    assert all(p.dtype == torch.float32 for p in model.parameters())


# Every option of the JAX package's model config is ported now. QAT and
# int8_inference: with both on, the JAX package's quant_mode picks QAT,
# and the model builds with QAT projections. MoE and the language-ID head
# build, and a saved model loads back with them.
@pytest.mark.parametrize("option", [
    {"qat": True}, {"int8_inference": True, "qat": True}, {"moe_experts": 8},
    {"num_languages": 4},
])
def test_unported_options_raise(option, tmp_path):
    if option.get("qat"):
        from velocity_asr_tpu_torch.quantize import DynamicInt8Dense, QuantDense

        model = tmodel.create_model(VelocityASRConfig(d_model=32, **option), device="cpu")
        assert isinstance(model.ctc_head.proj, QuantDense)
        assert not any(isinstance(m, DynamicInt8Dense) for m in model.modules())
        return
    cfg = VelocityASRConfig(d_model=32, ssm_layers=2, **option)
    model = tmodel.create_model(cfg, device="cpu")
    blocks = model.local_ssm.layers
    assert all((b.moe is not None) == ("moe_experts" in option) for b in blocks)
    assert (model.lid_head is not None) == ("num_languages" in option)
    tmodel.save_pretrained(str(tmp_path), cfg, model)
    back = tmodel.from_pretrained(str(tmp_path), device="cpu")
    for key, value in model.state_dict().items():
        assert torch.equal(back.state_dict()[key], value), key


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    torch.backends.cudnn.allow_tf32 = True  # torch's default
    with pytest.raises(RuntimeError, match="cuda"):
        tmodel.create_model(VelocityASRConfig(d_model=32), device="cuda")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
