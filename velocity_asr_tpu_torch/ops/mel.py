"""Log-mel spectrogram (mirrors velocity_asr_tpu/ops/mel_pallas.py and
the device half of velocity_asr_tpu/audio.py).

``log_mel`` is the CUDA kernel ``csrc/log_mel.cu`` on a CUDA tensor and
``log_mel_plain`` (fp32 matmuls against the same matrices) on a CPU
tensor. Reflect pad, framing and normalisation stay in torch, as they
stay in XLA on the TPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..audio import (
    HOP_LENGTH,
    N_FFT,
    N_MELS,
    SAMPLE_RATE,
    frame_signal,
    hann_window,
    mel_filterbank,
    reflect_pad,
)
from .cuda_lib import check_tensor, library


@functools.lru_cache(maxsize=4)
def dft_mel_matrices(n_fft: int = N_FFT, n_mels: int = N_MELS,
                     sample_rate: int = SAMPLE_RATE):
    """Window-folded DFT real (n_fft, n_freq) and imaginary parts, and the
    transposed HTK filterbank (n_freq, n_mels), fp32 numpy, unpadded."""
    n_freq = n_fft // 2 + 1
    k = np.arange(n_fft)[:, None]
    f = np.arange(n_freq)[None, :]
    ang = 2.0 * np.pi * k * f / n_fft
    w = hann_window(n_fft).astype(np.float64)[:, None]
    real = (w * np.cos(ang)).astype(np.float32)
    imag = (-w * np.sin(ang)).astype(np.float32)
    fb_t = np.ascontiguousarray(mel_filterbank(n_fft, n_mels, sample_rate).T)
    for m in (real, imag, fb_t):
        m.setflags(write=False)
    return real, imag, fb_t


@functools.lru_cache(maxsize=8)
def _device_matrices(device: torch.device, n_fft: int, n_mels: int, sample_rate: int):
    return tuple(torch.tensor(m, device=device)
                 for m in dft_mel_matrices(n_fft, n_mels, sample_rate))


def log_mel_plain(frames, dft_real, dft_imag, fb_t) -> torch.Tensor:
    """Plain version of the kernel: (M, n_fft) frames -> (M, n_mels).

    fp32 matmuls; on a card the caller keeps TF32 off
    (torch.backends.cuda.matmul.allow_tf32 = False)."""
    re = frames @ dft_real
    im = frames @ dft_imag
    return torch.log((re * re + im * im) @ fb_t + 1e-10)


def log_mel(frames, dft_real, dft_imag, fb_t) -> torch.Tensor:
    """Fused log-mel of (M, n_fft) fp32 frames -> (M, n_mels).

    On CUDA tensors this launches ``log_mel_f32``; on CPU tensors it runs
    ``log_mel_plain``.
    """
    if not frames.is_cuda:
        return log_mel_plain(frames, dft_real, dft_imag, fb_t)
    n_frames, n_fft = frames.shape
    n_freq, n_mels = fb_t.shape
    for name, t, shape in (
        ("frames", frames, (n_frames, n_fft)),
        ("dft_real", dft_real, (n_fft, n_freq)),
        ("dft_imag", dft_imag, (n_fft, n_freq)),
        ("fb_t", fb_t, (n_freq, n_mels)),
    ):
        check_tensor(t, name, shape)
        if t.device != frames.device:
            raise ValueError(f"{name} is on {t.device}, frames on {frames.device}")
    out = torch.empty(n_frames, n_mels, dtype=torch.float32, device=frames.device)
    if n_frames == 0:
        return out
    with torch.cuda.device(frames.device):
        library().launch(
            "log_mel_f32", frames.data_ptr(), dft_real.data_ptr(),
            dft_imag.data_ptr(), fb_t.data_ptr(), out.data_ptr(),
            n_frames, n_fft, n_freq, n_mels,
        )
    return out


def compute_mel_spectrogram(
    audio: torch.Tensor,
    sample_rate: int = SAMPLE_RATE,
    n_fft: int = N_FFT,
    hop_length: int = HOP_LENGTH,
    n_mels: int = N_MELS,
    normalize: bool = True,
) -> torch.Tensor:
    """Log-mel of (samples,) or (batch, samples) audio on its device.

    Returns (frames, n_mels) or (batch, frames, n_mels) fp32, with
    frames = 1 + samples // hop_length. normalize applies per-bin mean /
    unbiased-std normalisation over time.
    """
    squeeze = audio.ndim == 1
    if squeeze:
        audio = audio[None]
    audio = audio.to(torch.float32)
    frames = frame_signal(reflect_pad(audio, n_fft // 2), n_fft, hop_length)
    batch, t = frames.shape[:2]
    mats = _device_matrices(audio.device, n_fft, n_mels, sample_rate)
    mel = log_mel(frames.reshape(batch * t, n_fft).contiguous(), *mats)
    mel = mel.reshape(batch, t, n_mels)
    if normalize:
        mean = mel.mean(dim=-2, keepdim=True)
        std = mel.std(dim=-2, keepdim=True) if t > 1 else torch.zeros_like(mean)
        mel = (mel - mean) / (std + 1e-10)
    return mel[0] if squeeze else mel
