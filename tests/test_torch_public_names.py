"""The port's public names against the JAX package's: every name of its
``__all__`` and of its lazily imported list is importable from
``velocity_asr_tpu_torch``, or is listed here with the reason it is not;
and the helpers that item brought behave as the JAX ones (exactly, or
at rtol 1e-6 for the schedule, both evaluated in fp32)."""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import velocity_asr_tpu as jpkg
import velocity_asr_tpu_torch as tpkg
from velocity_asr_tpu import audio as jaudio
from velocity_asr_tpu import training as jtraining
from velocity_asr_tpu_torch import training as ttraining

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX-package names the port does not export, and why.
NOT_PORTED = {
    # named for its framework: the port's device beam is beam.ctc_beam_search_torch
    "ctc_beam_search_jax": "ctc_beam_search_torch",
}


def _jax_lazy_names():
    """The names the JAX package's __getattr__ resolves (read from its
    source: the tuples and the single names it compares `name` with)."""
    with open(os.path.join(ROOT, "velocity_asr_tpu", "__init__.py")) as f:
        tree = ast.parse(f.read())
    getattr_fn = next(n for n in tree.body
                      if isinstance(n, ast.FunctionDef) and n.name == "__getattr__")
    names = []
    for node in ast.walk(getattr_fn):
        if isinstance(node, ast.Compare) and isinstance(node.left, ast.Name):
            for comp in node.comparators:
                if isinstance(comp, ast.Tuple):
                    names += [e.value for e in comp.elts]
                elif isinstance(comp, ast.Constant):
                    names.append(comp.value)
    return names


JAX_ALL = list(jpkg.__all__)
JAX_LAZY = _jax_lazy_names()


def test_jax_lists_are_read():
    assert len(JAX_ALL) == 52 and len(JAX_LAZY) == 35
    assert "Trainer" in JAX_LAZY and "HotwordBooster" in JAX_LAZY


@pytest.mark.parametrize("name", JAX_ALL)
def test_jax_all_name_is_exported(name):
    assert name in tpkg.__all__
    assert getattr(tpkg, name) is not None


@pytest.mark.parametrize("name", JAX_LAZY)
def test_jax_lazy_name_resolves(name):
    if name in NOT_PORTED:
        with pytest.raises(AttributeError):
            getattr(tpkg, name)
        assert getattr(tpkg, NOT_PORTED[name]) is not None
        return
    value = getattr(tpkg, name)
    assert value is not None and value.__module__.startswith("velocity_asr_tpu_torch.")


def test_unknown_name_raises():
    with pytest.raises(AttributeError, match="no_such_name"):
        tpkg.no_such_name  # noqa: B018


def test_audio_helpers_match_jax():
    audio = np.random.default_rng(0).standard_normal((2, 1000)).astype(np.float32)
    for n in (0, 160, 1000, 16000, 16001):
        assert tpkg.audio_to_frames(n) == jaudio.audio_to_frames(n)
        assert tpkg.frames_to_audio(n) == jaudio.frames_to_audio(n)
    for target in (500, 1000, 1500):
        ref = np.asarray(jaudio.pad_or_trim(jnp.asarray(audio), target))
        np.testing.assert_array_equal(tpkg.pad_or_trim(audio, target), ref)
        out = tpkg.pad_or_trim(torch.from_numpy(audio), target)
        assert isinstance(out, torch.Tensor)
        np.testing.assert_array_equal(out.numpy(), ref)
    transform = tpkg.MelSpectrogramTransform(normalize=False)
    mel = transform(torch.from_numpy(audio[0]))
    assert mel.shape == (1 + 1000 // 160, 80)
    assert torch.equal(mel, tpkg.compute_mel_spectrogram(torch.from_numpy(audio[0]),
                                                         normalize=False))
    np.testing.assert_allclose(
        mel.numpy(), np.asarray(jaudio.MelSpectrogramTransform(normalize=False)(
            jnp.asarray(audio[0]))), rtol=1e-4, atol=1e-4)


def test_ctc_loss_and_scheduler_wrappers_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 12, 10)).astype(np.float32)
    targets = np.array([[3, 4, 5, 0], [6, 6, 7, 0]], np.int32)
    args = (logits, targets, np.array([12, 10], np.int32), np.array([3, 3], np.int32))
    ours = ttraining.CTCLoss()(*args)
    ref = jtraining.CTCLoss()(*args)
    np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-5)
    with pytest.raises(ValueError):
        ttraining.CTCLoss(reduction="sum")
    ours, ref = (mod.WarmupCosineScheduler(3e-4, 5, 20) for mod in (ttraining, jtraining))
    for _ in range(25):
        np.testing.assert_allclose(ours.get_lr(), ref.get_lr(), rtol=1e-6)
        ours.step()
        ref.step()


def test_model_helpers():
    model = tpkg.create_model(tpkg.VelocityASRConfig(d_model=16, ssm_layers=1,
                                                     global_ssm_layers=1), device="cpu")
    assert tpkg.count_parameters(model) == sum(p.numel() for p in model.parameters())
    assert [tpkg.get_output_length(n) for n in (1, 2, 399, 400)] == [1, 1, 200, 200]
    assert tpkg.init_params is tpkg.models.model.init_parameters
    assert tpkg.ScanMode is str and tpkg.__version__ == jpkg.__version__
