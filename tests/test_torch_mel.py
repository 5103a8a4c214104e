"""Parity of the port's log-mel front-end with the JAX package's.

The plain version of the CUDA log-mel kernel (fp32 DFT-by-matmul) and
``compute_mel_spectrogram`` are held against the JAX package's
``compute_mel_spectrogram`` on its XLA (rfft) path and its Pallas path in
interpret mode. Tolerance atol 1e-4 on log-mel: the rfft and the DFT
matmul sum the same terms in another order, in fp32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velocity_asr_tpu import audio as jaudio
from velocity_asr_tpu.ops import mel_pallas as jmel
from velocity_asr_tpu_torch import audio as taudio
from velocity_asr_tpu_torch import synth as tsynth
from velocity_asr_tpu_torch.ops import mel as tmel

ATOL = 1e-4


def _noise(seed, n):
    return (np.random.default_rng(seed).standard_normal(n) * 0.2).astype(np.float32)


def _speech(idx):
    return tsynth.utterance(idx)[1]


SIGNALS = {
    "noise_1s": lambda: _noise(6, 16000),
    "noise_odd": lambda: _noise(7, 15923),
    "speech_0": lambda: _speech(0),
}


def test_dft_mel_matrices_are_the_pallas_kernels_unpadded():
    real, imag, fb_t = tmel.dft_mel_matrices()
    real_p, imag_p, fbt_p = jmel._dft_mel_matrices(400, 80, 16000)
    np.testing.assert_array_equal(real, real_p[:400, :201])
    np.testing.assert_array_equal(imag, imag_p[:400, :201])
    np.testing.assert_array_equal(fb_t, fbt_p[:201, :80])


@pytest.mark.parametrize("signal", sorted(SIGNALS))
@pytest.mark.parametrize("normalize", [False, True])
def test_compute_mel_matches_jax_xla(signal, normalize):
    wav = SIGNALS[signal]()
    ref = np.asarray(jaudio.compute_mel_spectrogram(wav, normalize=normalize, backend="xla"))
    out = tmel.compute_mel_spectrogram(torch.from_numpy(wav), normalize=normalize)
    assert out.shape == ref.shape == (taudio.frame_count(len(wav)), 80)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


def test_compute_mel_batched_matches_jax_pallas_interpret():
    wav = _noise(8, 8000)
    batch = np.stack([wav, wav * 0.5])
    ref = np.asarray(jmel.mel_spectrogram_pallas(batch, normalize=False, interpret=True))
    out = tmel.compute_mel_spectrogram(torch.from_numpy(batch), normalize=False)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


def test_log_mel_plain_matches_rfft_on_frames():
    wav = _speech(1)
    audio = torch.from_numpy(wav)[None]
    frames = taudio.frame_signal(taudio.reflect_pad(audio, 200), 400, 160)[0].contiguous()
    mats = [torch.from_numpy(m.copy()) for m in tmel.dft_mel_matrices()]
    out = tmel.log_mel(frames, *mats)  # CPU tensor: the plain version
    torch.testing.assert_close(out, tmel.log_mel_plain(frames, *mats), rtol=0, atol=0)
    ref = np.asarray(jaudio.compute_mel_spectrogram(wav, normalize=False, backend="xla"))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n_valid", [1, 57, 120])
def test_masked_normalize_mel_scalar(n_valid):
    mel = np.random.default_rng(n_valid).standard_normal((120, 80)).astype(np.float32)
    ref = np.asarray(jaudio.masked_normalize_mel(jnp.asarray(mel), n_valid))
    out = taudio.masked_normalize_mel(torch.from_numpy(mel), n_valid)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert np.abs(out.numpy()[n_valid:]).max(initial=0.0) == 0.0


def test_masked_normalize_mel_per_item():
    mel = np.random.default_rng(3).standard_normal((3, 90, 80)).astype(np.float32)
    n = np.array([90, 41, 2], np.int32)
    ref = np.asarray(jaudio.masked_normalize_mel(jnp.asarray(mel), jnp.asarray(n)))
    out = taudio.masked_normalize_mel(torch.from_numpy(mel), torch.from_numpy(n))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_bucketed_masked_mel_matches_unpadded_host_mel():
    """The Transcriber's scheme (reflect pad to the bucket, normalise over
    the valid frames) reproduces the host mel of the unpadded utterance."""
    wav = _speech(2)
    exact = taudio.compute_mel_spectrogram_np(wav, normalize=True)
    n = exact.shape[0]
    bucket = -(-(1 + -(-len(wav) // 160)) // 200) * 200
    padded = np.pad(wav, (0, (bucket - 1) * 160 - len(wav)), mode="reflect")
    raw = tmel.compute_mel_spectrogram(torch.from_numpy(padded), normalize=False)
    assert raw.shape[0] == bucket
    normed = taudio.masked_normalize_mel(raw, n).numpy()
    np.testing.assert_allclose(normed[:n], exact, atol=1e-3)
    assert np.abs(normed[n:]).max() == 0.0


@pytest.mark.parametrize("normalize", [False, True])
def test_compute_mel_spectrogram_np_matches_jax(normalize):
    wav = np.stack([_noise(9, 4000), _noise(10, 4000)])
    np.testing.assert_array_equal(
        taudio.compute_mel_spectrogram_np(wav, normalize=normalize),
        jaudio.compute_mel_spectrogram_np(wav, normalize=normalize),
    )
