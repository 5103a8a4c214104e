"""The port's slice as a whole against the JAX package: the model forward
(models/model.py), greedy decoding (decode.py) and the offline
Transcriber (transcribe.py), on the same numpy inputs and weights.

Tolerances:
  - committed checkpoint, 200 mel frames, float32 override: logits atol
    1e-3 (fp32, other summation orders through 10 SSM blocks);
  - the same in the checkpoint's bf16: >= 99% argmax agreement, and the
    port's logits at most half as far from the JAX package's bf16 logits
    as those are from its fp32 logits. bf16 rounds at other points in
    XLA on the CPU (which drops bf16 round trips inside its fusions) than
    in torch (which rounds every Dense output, as the flax modules' dtype
    says), so an absolute bound below the bf16 noise itself (0.40 between
    the JAX package's bf16 and fp32 logits here) cannot hold;
  - small random model, fp32: logits and features atol 1e-4 (fp32, other
    summation orders through 2+2 SSM blocks);
  - one held-out utterance: the same text from both Transcribers.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velocity_asr_tpu import decode as jdecode
from velocity_asr_tpu.audio import compute_mel_spectrogram_np
from velocity_asr_tpu.models import config as jconfig
from velocity_asr_tpu.models import model as jmodel
from velocity_asr_tpu_torch import decode as tdecode
from velocity_asr_tpu_torch import synth as tsynth
from velocity_asr_tpu_torch.checkpoint import params_from_numpy
from velocity_asr_tpu_torch.models import model as tmodel
from velocity_asr_tpu_torch.models.config import VelocityASRConfig
from velocity_asr_tpu_torch.transcribe import Transcriber, load_transcriber

CKPT = "checkpoints/synth_run/final_pretrained"


def _utterance_mel(idx, frames):
    audio = tsynth.utterance(idx)[1]
    mel = compute_mel_spectrogram_np(audio)
    out = np.zeros((1, frames, mel.shape[1]), np.float32)
    n = min(frames, mel.shape[0])
    out[0, :n] = mel[:n]
    return out


def _checkpoint_logits(mel, dtype):
    jm, jp = jmodel.from_pretrained(CKPT, scan_mode="sequential", dtype=dtype)
    ref = np.asarray(jax.jit(lambda p, x: jmodel.forward(jm, p, x))(jp, jnp.asarray(mel)))
    port = tmodel.from_pretrained(CKPT, device="cpu", dtype=dtype)
    assert port.config.scan_mode == "pallas"  # the kernel path's plain version on CPU
    out = tmodel.forward(port, torch.from_numpy(mel)).numpy()
    assert out.shape == ref.shape == (1, 100, 30)
    return out, ref


def test_committed_checkpoint_logits_match_jax():
    mel = _utterance_mel(0, 200)
    out32, ref32 = _checkpoint_logits(mel, "float32")
    np.testing.assert_allclose(out32, ref32, rtol=0, atol=1e-3)
    assert (out32.argmax(-1) == ref32.argmax(-1)).all()

    out16, ref16 = _checkpoint_logits(mel, "bfloat16")
    assert (out16.argmax(-1) == ref16.argmax(-1)).mean() >= 0.99
    bf16_noise = np.abs(ref16 - ref32).max()
    assert np.abs(out16 - ref16).max() <= 0.5 * bf16_noise


def _perturbed_small_model(seed):
    cfg = jconfig.VelocityASRConfig(
        d_model=32, ssm_layers=2, ssm_state_dim=8, global_ssm_layers=2,
        global_ssm_state_dim=4, attention_heads=4, attention_dim=16, vocab_size=30,
        scan_mode="sequential", dtype="float32")
    jm = jmodel.create_model(cfg)
    params = jax.device_get(jmodel.init_params(jm, jax.random.PRNGKey(seed), example_frames=16))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda p: (p + 0.1 * rng.standard_normal(p.shape)).astype(np.float32), params)
    port = tmodel.create_model(VelocityASRConfig.from_dict(dict(cfg.to_dict(), scan_mode="pallas")),
                               device="cpu")
    port.load_state_dict(params_from_numpy(params), strict=True)
    return jm, params, port


@pytest.mark.parametrize("frames", [30, 151, 400])
def test_small_model_fp32_logits_and_features_match_jax(frames):
    jm, params, port = _perturbed_small_model(frames)
    mel = np.random.default_rng(1).standard_normal((2, frames, 80)).astype(np.float32)
    ref_logits, ref_feats = jmodel.forward(jm, params, jnp.asarray(mel), return_features=True)
    logits, feats = tmodel.forward(port, torch.from_numpy(mel), return_features=True)
    assert logits.shape == (2, port.get_output_length(frames), 30)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=0, atol=1e-4)
    assert set(feats) == set(ref_feats)
    for name in feats:
        np.testing.assert_allclose(feats[name].numpy(), np.asarray(ref_feats[name]),
                                   rtol=0, atol=1e-4, err_msg=name)


def test_greedy_decode_matches_jax():
    rng = np.random.default_rng(0)
    # few classes so blanks and repeats are frequent
    logits = rng.standard_normal((3, 50, 4)).astype(np.float32)
    ref_tokens, ref_lengths = jdecode.ctc_greedy_decode_jax(jnp.asarray(logits))
    tokens, lengths = tdecode.ctc_greedy_decode_torch(torch.from_numpy(logits))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref_lengths))
    assert tdecode.ctc_greedy_decode(torch.from_numpy(logits)) == jdecode.ctc_greedy_decode(logits)
    vocab = tdecode.create_default_vocabulary(100)
    assert vocab == jdecode.create_default_vocabulary(100)
    assert (tdecode.CTCDecoder(vocab).decode_greedy(torch.from_numpy(logits))
            == jdecode.CTCDecoder(vocab).decode_greedy(logits))


def test_transcriber_matches_jax_transcriber(tmp_path):
    from scripts.transcribe import Transcriber as JaxTranscriber

    manifest = tsynth.write_corpus(str(tmp_path), 1, split="test", seed=1234)
    wav = str(tmp_path / "test_00000.wav")
    jm, jp = jmodel.from_pretrained(CKPT, scan_mode="sequential")
    port = load_transcriber(CKPT, device="cpu")
    assert isinstance(port, Transcriber)
    ref = JaxTranscriber(jm, jp, jdecode.CTCDecoder(port.decoder.vocabulary)).transcribe_file(wav)
    out = port.transcribe_file(wav)
    assert out["text"] == ref["text"]
    assert out["duration"] == ref["duration"]
    with open(manifest) as f:
        assert out["text"] == json.loads(f.readline())["text"]
