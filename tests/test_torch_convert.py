"""The port's reference-checkpoint converter
(``velocity_asr_tpu_torch/compat/torch_convert.py``) against the JAX
package's, on state_dicts in the reference layout written from the
committed ``synth_run`` weights and from a small model
(``tests/reference_layout.py``):

- the converted tree is bit-equal to the JAX converter's and to the tree
  it was written from, and ``checkpoint.params_from_numpy`` loads it into
  the port's model, whose logits equal ``from_pretrained``'s bit for bit;
- ``load_torch_checkpoint`` on the {config, model_state_dict} format and
  on a bare state_dict, the config inferred from the shapes as JAX infers
  it;
- a leftover tensor and a missing bias raise the JAX messages.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.reference_layout import reference_state_dict
from velocity_asr_tpu.compat import torch_convert as jconvert
from velocity_asr_tpu_torch.checkpoint import params_from_numpy, params_to_numpy, read_params
from velocity_asr_tpu_torch.compat import torch_convert as tconvert
from velocity_asr_tpu_torch.models import model as tmodel
from velocity_asr_tpu_torch.models.config import VelocityASRConfig

CKPT = "checkpoints/synth_run/final_pretrained"
SMALL = dict(d_model=16, ssm_layers=3, ssm_state_dim=4, global_ssm_layers=1,
             global_ssm_state_dim=6, attention_heads=2, attention_dim=8, vocab_size=30,
             dropout=0.0, dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: under xdist the workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def assert_trees_equal(a, b):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert set(fa) == set(fb)
    for key, value in fa.items():
        assert value.dtype == fb[key].dtype and value.shape == fb[key].shape, key
        np.testing.assert_array_equal(value, fb[key], err_msg=str(key))


@pytest.fixture(scope="module")
def committed():
    tree = read_params(f"{CKPT}/params.msgpack")
    return tree, reference_state_dict(tree)


def test_committed_tree_round_trips_equal_to_jax(committed):
    tree, sd = committed
    ours = tconvert.convert_torch_state_dict(sd)
    assert_trees_equal(ours, tree)
    assert_trees_equal(ours, jconvert.convert_torch_state_dict(sd))
    # torch tensors convert as numpy arrays do
    assert_trees_equal(tconvert.convert_torch_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}), tree)


def test_converted_model_logits_equal_from_pretrained(committed, tmp_path):
    """The reference checkpoint format, written with the checkpoint's
    config, loads into a model whose logits on held-out mel are
    bit-equal to from_pretrained's."""
    tree, sd = committed
    ref = tmodel.from_pretrained(CKPT, device="cpu", dtype="float32")
    path = tmp_path / "ref.pt"
    torch.save({"config": ref.config.to_dict(),
                "model_state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    cfg, converted = tconvert.load_torch_checkpoint(str(path))
    assert cfg == ref.config
    model = tmodel.create_model(dataclasses.replace(cfg, dtype="float32"), device="cpu")
    model.load_state_dict(params_from_numpy(converted), strict=True)
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 120, 80))
                           .astype(np.float32))
    with torch.no_grad():
        assert torch.equal(model.eval()(mel), ref(mel))


def test_bare_state_dict_infers_the_config_as_jax(tmp_path):
    cfg = VelocityASRConfig(**SMALL)
    tree = params_to_numpy(tmodel.create_model(cfg, device="cpu",
                                               generator=torch.Generator().manual_seed(5)))
    sd = reference_state_dict(tree)
    path = tmp_path / "bare.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    ours_cfg, ours = tconvert.load_torch_checkpoint(str(path))
    jax_cfg, theirs = jconvert.load_torch_checkpoint(str(path))
    assert ours_cfg.to_dict() == jax_cfg.to_dict()
    expect = {k: SMALL[k] for k in SMALL if k not in ("attention_heads", "dropout", "dtype")}
    assert {k: getattr(ours_cfg, k) for k in expect} == expect
    assert_trees_equal(ours, theirs)
    assert_trees_equal(ours, tree)


@pytest.mark.parametrize("fault", ["leftover", "extra_layer", "missing_bias"])
def test_malformed_state_dicts_raise_as_jax(committed, fault):
    _, sd = committed
    sd = dict(sd)
    if fault == "leftover":
        sd["global_context.extra.weight"] = np.zeros(3, np.float32)
        kind, match = ValueError, "not consumed"
    elif fault == "extra_layer":
        for key in [k for k in sd if k.startswith("local_ssm.layers.0.")]:
            sd[key.replace("layers.0.", "layers.8.")] = sd[key]
        kind, match = ValueError, "17 checkpoint tensors were not consumed"
    else:
        del sd["local_ssm.layers.2.ffn.0.bias"]
        kind, match = KeyError, "missing expected bias 'local_ssm.layers.2.ffn.0.bias'"
    msgs = []
    for mod in (tconvert, jconvert):
        with pytest.raises(kind, match=match) as err:
            mod.convert_torch_state_dict(sd)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
