"""Log-mel spectrogram (mirrors velocity_asr_tpu/ops/mel_pallas.py and
the device half of velocity_asr_tpu/audio.py).

``log_mel`` takes the reflect-padded signal (batch, samples + n_fft) and
the hop and returns (batch, frames, n_mels): the CUDA kernel
``csrc/log_mel.cu`` on a CUDA tensor (it frames, windows and transforms
each frame itself: a 400-point real FFT and a sparse filterbank, from the
tables ``fft_tables`` and ``band_table`` built on the host), and
``log_mel_plain`` (the frames times fp32 window-folded DFT matrices, as
the Pallas kernel computes it) on a CPU tensor. Given an fp64 signal the
plain version runs the same transform in double precision: the yardstick
that holds the kernel on the card. Reflect padding and
normalisation stay in torch, as they stay in XLA on the TPU.
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

KERNEL_N_FFT = 400  # the transform size csrc/log_mel.cu is written for


def _frozen(*arrays):
    for m in arrays:
        m.setflags(write=False)
    return arrays


@functools.lru_cache(maxsize=4)
def dft_mel_matrices(n_fft: int = N_FFT, n_mels: int = N_MELS,
                     sample_rate: int = SAMPLE_RATE, dtype=np.float32):
    """Window-folded DFT real (n_fft, n_freq) and imaginary parts, and the
    transposed HTK filterbank (n_freq, n_mels), numpy, unpadded: computed
    in float64 and rounded once to `dtype` (fp32 unless asked)."""
    n_freq = n_fft // 2 + 1
    k = np.arange(n_fft)[:, None]
    f = np.arange(n_freq)[None, :]
    ang = 2.0 * np.pi * k * f / n_fft
    w = hann_window(n_fft).astype(np.float64)[:, None]
    real = (w * np.cos(ang)).astype(dtype)
    imag = (-w * np.sin(ang)).astype(dtype)
    fb_t = np.ascontiguousarray(mel_filterbank(n_fft, n_mels, sample_rate).T, dtype=dtype)
    return _frozen(real, imag, fb_t)


@functools.lru_cache(maxsize=4)
def fft_tables(n_fft: int = N_FFT):
    """The kernel's window and twiddles, fp32 numpy: the periodic Hann
    window (n_fft,) and (n_fft, 2) cos and sin of 2 pi j / n_fft, computed
    in float64 and rounded once."""
    ang = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    twiddle = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    return _frozen(hann_window(n_fft), twiddle)


@functools.lru_cache(maxsize=4)
def band_table(n_fft: int = N_FFT, n_mels: int = N_MELS, sample_rate: int = SAMPLE_RATE):
    """The HTK filterbank as the kernel reads it: per band the first bin of
    its run of nonzero weights, (n_mels,) int32; the runs' offsets into
    the weights, (n_mels + 1,) int32; the weights, fp32, band after band.
    Each band's nonzeros are one contiguous run of bins (a triangle)."""
    fb = mel_filterbank(n_fft, n_mels, sample_rate)
    first, offset, weights = [], [0], []
    for m, row in enumerate(fb):
        nz = np.flatnonzero(row)
        if nz.size == 0 or nz[-1] - nz[0] + 1 != nz.size:
            raise ValueError(f"mel band {m} is not one nonzero run of bins")
        first.append(nz[0])
        weights.append(row[nz[0]:nz[-1] + 1])
        offset.append(offset[-1] + nz.size)
    return _frozen(np.asarray(first, np.int32), np.asarray(offset, np.int32),
                   np.concatenate(weights).astype(np.float32))


@functools.lru_cache(maxsize=8)
def _device_matrices(device: torch.device, n_fft: int, n_mels: int, sample_rate: int,
                     dtype: torch.dtype = torch.float32):
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return tuple(torch.tensor(m, device=device)
                 for m in dft_mel_matrices(n_fft, n_mels, sample_rate, np_dtype))


@functools.lru_cache(maxsize=8)
def _device_tables(device: torch.device, n_mels: int, sample_rate: int):
    """(window, twiddle, band_first, band_offset, band_weight) on device."""
    return tuple(torch.tensor(m, device=device)
                 for m in fft_tables(KERNEL_N_FFT)
                 + band_table(KERNEL_N_FFT, n_mels, sample_rate))


def log_mel_plain(padded: torch.Tensor, hop_length: int = HOP_LENGTH, n_fft: int = N_FFT,
                  n_mels: int = N_MELS, sample_rate: int = SAMPLE_RATE) -> torch.Tensor:
    """Plain version of the kernel: (batch, samples + n_fft) reflect-padded
    fp32 signal -> (batch, frames, n_mels) log-mel.

    Frames the signal and multiplies by the window-folded DFT matrices and
    the dense filterbank in fp32; on a card the caller keeps TF32 off
    (torch.backends.cuda.matmul.allow_tf32 = False). An fp64 signal runs
    the same in fp64 (matrices rounded once from float64) and returns fp64.
    """
    frames = frame_signal(padded, n_fft, hop_length)
    batch, t = frames.shape[:2]
    real, imag, fb_t = _device_matrices(padded.device, n_fft, n_mels, sample_rate,
                                        padded.dtype)
    flat = frames.reshape(batch * t, n_fft).contiguous()
    re = flat @ real
    im = flat @ imag
    return torch.log((re * re + im * im) @ fb_t + 1e-10).reshape(batch, t, n_mels)


def log_mel(padded: torch.Tensor, hop_length: int = HOP_LENGTH, n_fft: int = N_FFT,
            n_mels: int = N_MELS, sample_rate: int = SAMPLE_RATE) -> torch.Tensor:
    """Fused log-mel of the reflect-padded fp32 signal (batch, samples +
    n_fft) -> (batch, frames, n_mels), frames = 1 + samples // hop_length.

    On CUDA tensors this launches ``log_mel_f32`` (n_fft must be 400); on
    CPU tensors it runs ``log_mel_plain``.
    """
    if not padded.is_cuda:
        return log_mel_plain(padded, hop_length, n_fft, n_mels, sample_rate)
    if n_fft != KERNEL_N_FFT:
        raise ValueError(f"the log-mel kernel computes {KERNEL_N_FFT}-point frames, not {n_fft}")
    if padded.ndim != 2 or padded.shape[1] < n_fft:
        raise ValueError(f"padded must be (batch, >= {n_fft} samples), got {tuple(padded.shape)}")
    check_tensor(padded, "padded", padded.shape)
    batch, padded_len = padded.shape
    n_frames = 1 + (padded_len - n_fft) // hop_length
    out = torch.empty(batch, n_frames, n_mels, dtype=torch.float32, device=padded.device)
    if batch == 0:
        return out
    window, twiddle, first, offset, weight = _device_tables(padded.device, n_mels, sample_rate)
    with torch.cuda.device(padded.device):
        library().launch(
            "log_mel_f32", padded.data_ptr(), window.data_ptr(), twiddle.data_ptr(),
            first.data_ptr(), offset.data_ptr(), weight.data_ptr(), out.data_ptr(),
            batch, padded_len, n_frames, hop_length, n_mels, weight.numel(),
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
    padded = reflect_pad(audio.to(torch.float32), n_fft // 2)
    mel = log_mel(padded, hop_length, n_fft, n_mels, sample_rate)
    if normalize:
        t = mel.shape[1]
        mean = mel.mean(dim=-2, keepdim=True)
        std = mel.std(dim=-2, keepdim=True) if t > 1 else torch.zeros_like(mean)
        mel = (mel - mean) / (std + 1e-10)
    return mel[0] if squeeze else mel
