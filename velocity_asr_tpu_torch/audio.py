"""Audio front-end helpers (mirrors velocity_asr_tpu/audio.py).

Constants: 16 kHz, n_fft=400 (25 ms), hop=160 (10 ms), 80 HTK mels,
periodic Hann window, reflect pad n_fft//2 on both sides and
center=False framing. The log-mel itself (window, DFT, power, mel, log)
is ``ops/mel.py``; normalisation over time uses the unbiased std, over
the valid frames of a padded batch (``masked_normalize_mel``) or with the
causal per-chunk statistics of a stream (``causal_normalize_mel``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
N_MELS = 80


def hann_window(n_fft: int = N_FFT, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window, matching torch.hann_window(n_fft)."""
    n = np.arange(n_fft, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))
    return w.astype(dtype)


def _hz_to_mel(hz: np.ndarray) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + hz / 700.0)


def _mel_to_hz(mel: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    n_fft: int = N_FFT,
    n_mels: int = N_MELS,
    sample_rate: int = SAMPLE_RATE,
) -> np.ndarray:
    """Triangular HTK-mel filterbank, shape (n_mels, n_fft // 2 + 1)."""
    n_freqs = n_fft // 2 + 1
    freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs, dtype=np.float64)

    mel_min = _hz_to_mel(np.float64(0.0))
    mel_max = _hz_to_mel(np.float64(sample_rate / 2.0))
    mel_points = np.linspace(mel_min, mel_max, n_mels + 2)
    hz_points = _mel_to_hz(mel_points)

    lower = hz_points[:-2, None]
    center = hz_points[1:-1, None]
    upper = hz_points[2:, None]

    lower_slope = (freqs[None, :] - lower) / (center - lower + 1e-10)
    upper_slope = (upper - freqs[None, :]) / (upper - center + 1e-10)
    fb = np.maximum(0.0, np.minimum(lower_slope, upper_slope)).astype(np.float32)
    # lru_cache hands the same array to every caller: freeze it.
    fb.setflags(write=False)
    return fb


def frame_count(num_samples: int, n_fft: int = N_FFT, hop_length: int = HOP_LENGTH) -> int:
    """STFT frames of a signal after reflect padding n_fft//2 on each side."""
    return 1 + (num_samples + 2 * (n_fft // 2) - n_fft) // hop_length


def reflect_pad(audio: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis of (batch, samples) by `pad` on each side,
    as ``np.pad(mode="reflect")`` does at any length: a pad as long as the
    signal or longer reflects again and again (period 2 * (samples - 1)),
    and a single sample repeats. The usual case (pad < samples) is one
    ``F.pad``; the short one gathers through an index map built on the
    signal's own device."""
    n = audio.shape[-1]
    if n == 0:
        raise ValueError("cannot reflect-pad an empty signal")
    if pad < n:
        return F.pad(audio[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    idx = torch.arange(-pad, n + pad, device=audio.device)
    if n == 1:
        idx = torch.zeros_like(idx)
    else:
        period = 2 * (n - 1)
        idx = idx.remainder(period)
        idx = torch.where(idx < n, idx, period - idx)
    return audio.index_select(-1, idx)


def frame_signal(audio: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """Overlapping frames (..., T, n_fft) of (..., S), center=False.

    The same frames as the JAX package's ``_frame_signal``; ``unfold``
    makes them a strided view, which the caller copies once."""
    return audio.unfold(-1, n_fft, hop_length)


def masked_normalize_mel(mel: torch.Tensor, n_valid) -> torch.Tensor:
    """Per-bin normalisation over the first n_valid frames only.

    mel is (..., T, n_mels); n_valid an int or a (batch,) tensor. The mean
    and unbiased std exclude padding, and padded frames are zeroed.
    """
    t = mel.shape[-2]
    n_valid = torch.as_tensor(n_valid, device=mel.device)
    if n_valid.ndim == 1:
        n_valid = n_valid[:, None, None]
    valid = torch.arange(t, device=mel.device)[:, None] < n_valid
    n = torch.clamp(n_valid, min=1).to(mel.dtype)
    zero = torch.zeros((), dtype=mel.dtype, device=mel.device)
    mean = torch.where(valid, mel, zero).sum(dim=-2, keepdim=True) / n
    var = torch.where(valid, (mel - mean) ** 2, zero).sum(dim=-2, keepdim=True) / (
        torch.clamp(n - 1.0, min=1.0)
    )
    out = (mel - mean) / (torch.sqrt(var) + 1e-10)
    return torch.where(valid, out, zero)


def causal_normalize_mel(mel: torch.Tensor, n_valid, chunk_frames: int) -> torch.Tensor:
    """Per-bin normalisation with causal per-chunk statistics.

    Frame t of chunk c = t // chunk_frames is normalised with the mean and
    unbiased std of frames [0, min((c + 1) * chunk_frames, n_valid)): the
    statistics a live stream's normaliser holds when chunk c is processed
    (``streaming.StreamingMel`` fed chunk-sized blocks). mel is (batch, T,
    n_mels) un-normalised log-mel, n_valid a (batch,) tensor of valid
    frame counts; T need not be a multiple of chunk_frames. The sums are
    cumulative sums of the masked frames and of their squares, the
    variance (sum2 - n mean^2) / max(n - 1, 1) clamped at 0, as in the JAX
    package; padded frames are zeroed.
    """
    b, t, m = mel.shape
    n_valid = torch.as_tensor(n_valid, device=mel.device).to(torch.int64).reshape(b, 1)
    valid = torch.arange(t, device=mel.device)[None, :, None] < n_valid[:, :, None]
    zero = torch.zeros((), dtype=torch.float32, device=mel.device)
    x = torch.where(valid, mel.to(torch.float32), zero)
    cs = torch.cumsum(x, dim=1)
    cs2 = torch.cumsum(x * x, dim=1)
    chunk = torch.arange(t, device=mel.device) // chunk_frames
    cutoff = torch.clamp(torch.minimum((chunk[None, :] + 1) * chunk_frames, n_valid), min=1)
    idx = (cutoff - 1)[:, :, None].expand(b, t, m)
    s = torch.gather(cs, 1, idx)
    s2 = torch.gather(cs2, 1, idx)
    n = cutoff[:, :, None].to(torch.float32)
    mean = s / n
    var = (s2 - n * mean * mean) / torch.clamp(n - 1.0, min=1.0)
    std = torch.sqrt(torch.clamp(var, min=0.0))
    out = (mel - mean) / (std + 1e-10)
    return torch.where(valid, out, zero)


def compute_mel_spectrogram_np(
    audio: np.ndarray,
    sample_rate: int = SAMPLE_RATE,
    n_fft: int = N_FFT,
    hop_length: int = HOP_LENGTH,
    n_mels: int = N_MELS,
    normalize: bool = True,
) -> np.ndarray:
    """Numpy log-mel (rfft) of (samples,) or (batch, samples), for the
    host side of a data pipeline."""
    squeeze_output = audio.ndim == 1
    if squeeze_output:
        audio = audio[None, :]
    audio = np.asarray(audio, np.float32)

    pad = n_fft // 2
    audio_padded = np.pad(audio, ((0, 0), (pad, pad)), mode="reflect")
    num_frames = 1 + (audio_padded.shape[-1] - n_fft) // hop_length
    idx = (
        np.arange(num_frames, dtype=np.int64)[:, None] * hop_length
        + np.arange(n_fft, dtype=np.int64)[None, :]
    )
    frames = audio_padded[:, idx] * hann_window(n_fft)
    spec = np.fft.rfft(frames, n=n_fft, axis=-1)
    power = (spec.real**2 + spec.imag**2).astype(np.float32)

    fb = mel_filterbank(n_fft, n_mels, sample_rate)
    mel = np.einsum("mf,btf->btm", fb, power)
    mel = np.log(mel + 1e-10)

    if normalize:
        mean = mel.mean(axis=-2, keepdims=True)
        std = mel.std(axis=-2, keepdims=True, ddof=1) if mel.shape[-2] > 1 else np.zeros_like(mean)
        mel = (mel - mean) / (std + 1e-10)

    if squeeze_output:
        mel = mel[0]
    return mel.astype(np.float32)


def load_audio(path: str, sample_rate: int = SAMPLE_RATE, mono: bool = True) -> np.ndarray:
    """Load a WAV file, downmix to mono and resample to `sample_rate`."""
    from .io import decode_audio_file

    waveform, sr = decode_audio_file(path)  # (channels, samples) float32

    if mono and waveform.shape[0] > 1:
        waveform = waveform.mean(axis=0, keepdims=True)

    if sr != sample_rate:
        from math import gcd

        from scipy.signal import resample_poly

        g = gcd(sr, sample_rate)
        waveform = resample_poly(waveform, sample_rate // g, sr // g, axis=-1).astype(
            np.float32
        )

    if mono:
        waveform = waveform[0]
    return np.ascontiguousarray(waveform, dtype=np.float32)


class MelSpectrogramTransform:
    """Callable carrying the mel parameters: ``ops.mel.compute_mel_spectrogram``
    of a tensor (the log-mel kernel on the card)."""

    def __init__(self, sample_rate: int = SAMPLE_RATE, n_fft: int = N_FFT,
                 hop_length: int = HOP_LENGTH, n_mels: int = N_MELS, normalize: bool = True):
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.n_mels = n_mels
        self.normalize = normalize

    def __call__(self, audio: torch.Tensor) -> torch.Tensor:
        from .ops.mel import compute_mel_spectrogram

        return compute_mel_spectrogram(audio, sample_rate=self.sample_rate, n_fft=self.n_fft,
                                       hop_length=self.hop_length, n_mels=self.n_mels,
                                       normalize=self.normalize)


def audio_to_frames(audio_length: int, hop_length: int = HOP_LENGTH, n_fft: int = N_FFT) -> int:
    """The reference's frame estimate, (length + n_fft) // hop: one more than
    the transform gives at hop-aligned lengths (``frame_count`` is exact)."""
    return (audio_length + n_fft) // hop_length


def frames_to_audio(num_frames: int, hop_length: int = HOP_LENGTH) -> int:
    """Approximate sample count of `num_frames` frames."""
    return num_frames * hop_length


def pad_or_trim(audio, target_length: int):
    """Zero-pad or cut the last axis to `target_length` samples (a numpy
    array or a tensor, returned as the same kind)."""
    current = audio.shape[-1]
    if current > target_length:
        return audio[..., :target_length]
    if current == target_length:
        return audio
    if isinstance(audio, torch.Tensor):
        return F.pad(audio, (0, target_length - current))
    return np.pad(audio, [(0, 0)] * (audio.ndim - 1) + [(0, target_length - current)])
