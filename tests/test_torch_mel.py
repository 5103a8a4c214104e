"""Parity of the port's log-mel front-end with the JAX package's.

The plain version of the CUDA log-mel kernel (fp32 DFT-by-matmul on the
reflect-padded signal) and ``compute_mel_spectrogram`` are held against
the JAX package's ``compute_mel_spectrogram`` on its XLA (rfft) path and
its Pallas path in interpret mode; the kernel's host tables (twiddles,
sparse filterbank) against their float64 and dense sources. Tolerance
atol 1e-4 on log-mel: the rfft and the DFT matmul sum the same terms in
another order, in fp32.
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
    padded = taudio.reflect_pad(audio, 200)
    out = tmel.log_mel(padded)[0]  # CPU tensor: the plain version
    torch.testing.assert_close(out, tmel.log_mel_plain(padded)[0], rtol=0, atol=0)
    ref = np.asarray(jaudio.compute_mel_spectrogram(wav, normalize=False, backend="xla"))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


def test_band_table_reconstructs_the_filterbank():
    """The kernel's sparse filterbank (first bin, run offsets, weights)
    scattered back is audio.mel_filterbank() bit for bit: 393 nonzeros,
    1-14 bins a band."""
    first, offset, weight = tmel.band_table()
    fb = taudio.mel_filterbank()
    assert first.dtype == offset.dtype == np.int32 and weight.dtype == np.float32
    assert offset[0] == 0 and offset[-1] == weight.size == np.count_nonzero(fb) == 393
    counts = np.diff(offset)
    assert counts.min() == 1 and counts.max() == 14
    dense = np.zeros_like(fb)
    for m in range(fb.shape[0]):
        dense[m, first[m]:first[m] + counts[m]] = weight[offset[m]:offset[m + 1]]
    np.testing.assert_array_equal(dense, fb)


def test_fft_tables_are_float64_rounded_once():
    window, twiddle = tmel.fft_tables()
    ang = 2.0 * np.pi * np.arange(400, dtype=np.float64) / 400
    assert twiddle.shape == (400, 2) and twiddle.dtype == np.float32
    np.testing.assert_array_equal(twiddle[:, 0], np.cos(ang).astype(np.float32))
    np.testing.assert_array_equal(twiddle[:, 1], np.sin(ang).astype(np.float32))
    np.testing.assert_array_equal(window, taudio.hann_window(400))


@pytest.mark.parametrize("batch", [1, 3])
def test_plain_on_padded_signal_matches_framed_and_pallas(batch):
    """log_mel_plain takes the padded signal, as the kernel does: the same
    values as the framed computation it replaced and as the Pallas kernel
    (interpret mode), at a length that is not a multiple of the hop."""
    wav = np.stack([_noise(20 + i, 8037) * (1 + i) for i in range(batch)])
    padded = taudio.reflect_pad(torch.from_numpy(wav), 200)
    out = tmel.log_mel_plain(padded)
    n = taudio.frame_count(wav.shape[1])
    assert out.shape == (batch, n, 80)
    frames = taudio.frame_signal(padded, 400, 160).reshape(batch * n, 400)
    real, imag, fb_t = (torch.from_numpy(m.copy()) for m in tmel.dft_mel_matrices())
    re, im = frames @ real, frames @ imag
    framed = torch.log((re * re + im * im) @ fb_t + 1e-10).reshape(batch, n, 80)
    np.testing.assert_allclose(out.numpy(), framed.numpy(), rtol=0, atol=ATOL)
    ref = np.asarray(jmel.mel_spectrogram_pallas(wav, normalize=False, interpret=True))
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



@pytest.mark.parametrize("n", [1, 2, 150, 200, 201, 400])
def test_compute_mel_short_audio_matches_jax(n):
    """A clip no longer than the 200-sample reflect pad: numpy's repeated
    reflection on both sides, as the JAX package pads, then the same
    log-mel frames within ATOL. A 1- or 2-sample clip pads to a constant
    or an alternating frame, whose spectrum is zero in exact arithmetic
    outside DC and Nyquist: there the bands hold fp32 rounding noise on
    both sides (the JAX package's rfft and Pallas paths differ by up to
    0.3 in log there), so bands below 1e-6 of their frame's largest power
    are held to that floor instead of to each other."""
    wav = _noise(30 + n, n)
    ref = np.asarray(jaudio.compute_mel_spectrogram(wav, normalize=False, backend="xla"))
    out = tmel.compute_mel_spectrogram(torch.from_numpy(wav), normalize=False).numpy()
    assert out.shape == ref.shape == (taudio.frame_count(n), 80)
    floor = 1e-6 * np.exp(ref).max(axis=-1, keepdims=True)
    live = np.exp(ref) > floor
    assert live.sum(axis=-1).min() >= 1 and (live.all() or n <= 2)
    np.testing.assert_allclose(out[live], ref[live], rtol=0, atol=ATOL)
    assert (np.exp(out) <= floor)[~live].all()
