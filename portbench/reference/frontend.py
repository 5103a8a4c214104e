"""The plain reference of the front end and of the output vocabulary.

An utterance of n int16 samples is reflect-padded to its frame bucket
((bucket - 1) * 160 samples), scaled by 1 / 32768, reflect-padded by 200
samples on each side, cut into 400-sample frames every 160 samples,
windowed by a periodic Hann window, transformed by a real FFT, its power
mapped through an 80-band HTK mel filterbank, and logged (+ 1e-10). Each
bin is then normalised over the utterance's 1 + n // 160 valid frames
(mean and unbiased std, + 1e-10 after the root), and the padded frames
are zeroed. All of it in float64, returned in float32.
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import List, Optional

import numpy as np
import torch

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
N_MELS = 80


def bucket_frames(n_samples: int, frame_bucket: int) -> int:
    """The frames an utterance of n_samples pads to: the first multiple
    of frame_bucket that holds 1 + ceil(n / hop) frames."""
    need = 1 + -(-n_samples // HOP)
    return -(-need // frame_bucket) * frame_bucket


def valid_frames(n_samples: int) -> int:
    return 1 + n_samples // HOP


@lru_cache(maxsize=2)
def mel_filterbank() -> np.ndarray:
    """(80, 201) triangular HTK filterbank over 0..8 kHz, float64."""
    freqs = np.linspace(0.0, SAMPLE_RATE / 2.0, N_FFT // 2 + 1)
    mel_max = 2595.0 * np.log10(1.0 + (SAMPLE_RATE / 2.0) / 700.0)
    hz = 700.0 * (10.0 ** (np.linspace(0.0, mel_max, N_MELS + 2) / 2595.0) - 1.0)
    lower, center, upper = hz[:-2, None], hz[1:-1, None], hz[2:, None]
    rise = (freqs[None, :] - lower) / (center - lower + 1e-10)
    fall = (upper - freqs[None, :]) / (upper - center + 1e-10)
    return np.maximum(0.0, np.minimum(rise, fall))


def padded_pcm(pcm: np.ndarray, frames: int) -> np.ndarray:
    """int16 samples reflect-padded to `frames` frames' worth of samples."""
    target = (frames - 1) * HOP
    if len(pcm) >= 2:
        return np.pad(pcm, (0, target - len(pcm)), mode="reflect")
    out = np.zeros(target, np.int16)
    out[: len(pcm)] = pcm
    return out


def normalized_mel(pcms: List[np.ndarray], frames: int, device) -> torch.Tensor:
    """(B, frames, 80) float32 normalised log-mel of int16 utterances that
    all pad to `frames` frames."""
    wire = torch.tensor(np.stack([padded_pcm(p, frames) for p in pcms]), device=device)
    audio = wire.to(torch.float64) / 32768.0
    audio = torch.nn.functional.pad(audio[:, None, :], (N_FFT // 2, N_FFT // 2),
                                    mode="reflect")[:, 0]
    seg = audio.unfold(-1, N_FFT, HOP)                                  # (B, F, 400)
    n = torch.arange(N_FFT, dtype=torch.float64, device=device)
    window = 0.5 * (1.0 - torch.cos(2.0 * np.pi * n / N_FFT))
    power = torch.fft.rfft(seg * window, dim=-1).abs() ** 2
    mel = torch.log(power @ torch.tensor(mel_filterbank().T, device=device) + 1e-10)
    valid = torch.tensor([valid_frames(len(p)) for p in pcms], device=device)
    mask = (torch.arange(frames, device=device)[None, :] < valid[:, None])[..., None]
    cnt = valid.to(torch.float64)[:, None, None]
    mean = torch.where(mask, mel, 0.0).sum(1, keepdim=True) / cnt
    var = torch.where(mask, (mel - mean) ** 2, 0.0).sum(1, keepdim=True) / (cnt - 1).clamp(min=1)
    out = torch.where(mask, (mel - mean) / (var.sqrt() + 1e-10), 0.0)
    return out.to(torch.float32)


def default_vocabulary(size: int) -> List[str]:
    """The character vocabulary of a checkpoint without one: blank, unk,
    pad, space, letters, digits, punctuation, then <token_i>."""
    vocab = ["<blank>", "<unk>", "<pad>", " "]
    vocab += list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789")
    vocab += list(".,!?;:'\"()-")
    return vocab + [f"<token_{i}>" for i in range(len(vocab), size)]


_PIECE = re.compile(r"<[^<>]*>|.", re.S)


def text_to_ids(text: str, vocab: List[str]) -> Optional[List[int]]:
    """The token ids a served text spells (a text joins its tokens and
    strips the ends' spaces); None where a piece is no token."""
    index = {tok: i for i, tok in enumerate(vocab)}
    ids = [index.get(piece) for piece in _PIECE.findall(text)]
    return None if any(i is None for i in ids) else ids
