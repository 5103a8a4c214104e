"""Training augmentation (mirrors velocity_asr_tpu/augment.py): SpecAugment
masking on host-mel and device-mel batches alike, and the waveform
augmentations of device-mel batches, noise injection and speed
perturbation.

Time and frequency masks on a batched mel, set to 0 (the batch pad
value). The JAX package draws them inside its jitted step from the step's
PRNG key; here they come from a ``torch.Generator`` the caller passes, on
the mel's device. The two give different numbers from the same seed; the
rule is the same: widths uniform in [0, max_width], each time mask capped
at half its utterance's valid length, starts drawn as
``randint(0, 2**30) % (limit - width + 1)`` so a mask never spills past
the limit.

``noise_inject`` and ``speed_perturb_audio`` act on a device-mel batch's
raw audio before the log-mel. Each is a draw (``draw_noise``,
``draw_speed``: the SNRs and unit-normal noise, the warp factors) and
the arithmetic on it (``add_noise``, ``warp_speed``), so the arithmetic
can be held against the JAX package's on the JAX functions' own draws.

Under a ``parallel.data_shard`` (data-parallel training) every draw is
made for the global batch and each rank takes its rows
(``parallel.mesh.sharded_draw``), so a world-N step draws what the
one-process step draws.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .parallel.mesh import sharded_draw


@dataclass
class SpecAugmentConfig:
    """SpecAugment hyperparameters (LibriSpeech-style defaults); the field
    set is the JAX package's."""

    enabled: bool = False
    num_time_masks: int = 2
    time_mask_frames: int = 50  # max frames per mask
    num_freq_masks: int = 2
    freq_mask_bins: int = 15  # max mel bins per mask
    noise_injection: bool = False
    noise_min_snr_db: float = 10.0
    noise_max_snr_db: float = 40.0
    speed_perturb: bool = False
    speed_min: float = 0.9
    speed_max: float = 1.1


def _sample_masks(rng: torch.Generator, count: int, max_width: int, limit: torch.Tensor,
                  width_cap: torch.Tensor | None = None):
    """(batch, count) starts and widths, masks within [0, limit)."""
    batch = limit.shape[0]
    device = limit.device
    widths = sharded_draw(lambda s: torch.randint(0, max_width + 1, s, generator=rng,
                                                  device=device), (batch, count))
    if width_cap is not None:
        widths = torch.minimum(widths, width_cap[:, None])
    widths = torch.minimum(widths, limit[:, None])
    # start ~ U[0, limit - width] inclusive: the last valid frame or bin
    # is reachable and a mask never spills past limit
    max_start = torch.clamp(limit[:, None] - widths + 1, min=1)
    starts = sharded_draw(lambda s: torch.randint(0, 2**30, s, generator=rng, device=device),
                          (batch, count)) % max_start
    return starts, widths


def _mask(size: int, starts: torch.Tensor, widths: torch.Tensor) -> torch.Tensor:
    """(batch, size) True where any of a row's masks covers the position."""
    pos = torch.arange(size, device=starts.device)[None, :, None]
    return ((pos >= starts[:, None, :]) & (pos < (starts + widths)[:, None, :])).any(-1)


def spec_augment(mel: torch.Tensor, rng: torch.Generator, config: SpecAugmentConfig,
                 input_lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Time and frequency masking of a (batch, T, n_mels) mel batch.

    Time masks fall within each utterance's valid length when
    input_lengths is given, each capped at half of it (a 1-frame clip is
    never time-masked); frequency masks within the mel bins."""
    batch, t_len, n_mels = mel.shape
    out = mel
    if config.num_time_masks > 0:
        limit = (input_lengths.to(device=mel.device, dtype=torch.int64)
                 if input_lengths is not None
                 else torch.full((batch,), t_len, dtype=torch.int64, device=mel.device))
        starts, widths = _sample_masks(rng, config.num_time_masks, config.time_mask_frames,
                                       limit, width_cap=limit // 2)
        out = out.masked_fill(_mask(t_len, starts, widths)[:, :, None], 0.0)
    if config.num_freq_masks > 0:
        limit = torch.full((batch,), n_mels, dtype=torch.int64, device=mel.device)
        starts, widths = _sample_masks(rng, config.num_freq_masks, config.freq_mask_bins,
                                       limit)
        out = out.masked_fill(_mask(n_mels, starts, widths)[:, None, :], 0.0)
    return out


# ----- waveform augmentation (device-mel batches) ------------------------------


def draw_noise(rng: torch.Generator, config: SpecAugmentConfig, audio: torch.Tensor):
    """(snr_db (batch, 1), unit-normal noise shaped like audio): SNRs
    uniform in [noise_min_snr_db, noise_max_snr_db)."""
    batch = audio.shape[0]
    u = sharded_draw(lambda s: torch.rand(s, generator=rng, device=audio.device,
                                          dtype=torch.float32), (batch, 1))
    snr_db = config.noise_min_snr_db + u * (config.noise_max_snr_db - config.noise_min_snr_db)
    unit = sharded_draw(lambda s: torch.randn(s, generator=rng, device=audio.device,
                                              dtype=audio.dtype), audio.shape)
    return snr_db, unit


def add_noise(audio: torch.Tensor, snr_db: torch.Tensor, unit: torch.Tensor,
              sample_lengths: torch.Tensor) -> torch.Tensor:
    """White noise at each row's SNR over its first sample_lengths samples:
    signal power is the mean square of those samples (at least one counted),
    noise power = signal power * 10^(-snr/10), noise = unit * sqrt(noise
    power); samples past the valid length stay as they are."""
    n = audio.shape[1]
    lengths = sample_lengths.to(device=audio.device)
    valid = torch.arange(n, device=audio.device)[None, :] < lengths[:, None]
    denom = torch.clamp(lengths[:, None].to(torch.float32), min=1.0)
    sig_pow = torch.where(valid, audio * audio, 0.0).sum(1, keepdim=True) / denom
    noise_pow = sig_pow * torch.pow(10.0, -snr_db / 10.0)
    return torch.where(valid, audio + unit * torch.sqrt(noise_pow), audio)


def noise_inject(audio: torch.Tensor, rng: torch.Generator, config: SpecAugmentConfig,
                 sample_lengths: torch.Tensor) -> torch.Tensor:
    """``add_noise`` on a fresh ``draw_noise`` from `rng`."""
    snr_db, unit = draw_noise(rng, config, audio)
    return add_noise(audio, snr_db, unit, sample_lengths)


def draw_speed(rng: torch.Generator, config: SpecAugmentConfig, audio: torch.Tensor):
    """Warp factors (batch, 1), uniform in [speed_min, speed_max)."""
    u = sharded_draw(lambda s: torch.rand(s, generator=rng, device=audio.device,
                                          dtype=torch.float32), (audio.shape[0], 1))
    return config.speed_min + u * (config.speed_max - config.speed_min)


def warp_speed(audio: torch.Tensor, factors: torch.Tensor, input_lengths: torch.Tensor,
               hop_length: int):
    """Speed-warp each row in place of its fixed-width buffer:
    out[t] = audio[t * f] by linear interpolation (tempo and pitch
    together, sox ``speed``), zero past the new valid length floor(valid /
    f), where valid = (input_lengths - 1) * hop_length samples. A
    slow-down is clamped per row to f >= valid / width so the stretched
    signal fits the buffer. Returns (warped audio, new input_lengths =
    new_valid // hop_length + 1), the frame counts under the collator's
    rule."""
    b, s = audio.shape
    lengths = input_lengths.to(device=audio.device)
    valid = ((lengths[:, None] - 1) * hop_length).to(torch.float32)
    f = torch.maximum(factors.to(torch.float32), valid / s)
    pos = torch.arange(s, device=audio.device, dtype=torch.float32)[None, :] * f
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, s - 1)
    i1 = torch.clamp(i0 + 1, max=s - 1)
    w = pos - i0.to(torch.float32)
    out = torch.gather(audio, 1, i0) * (1.0 - w) + torch.gather(audio, 1, i1) * w
    new_valid = torch.floor(valid / f).to(torch.int64)
    out = torch.where(torch.arange(s, device=audio.device)[None, :] < new_valid, out, 0.0)
    new_lengths = (new_valid[:, 0] // hop_length + 1).to(input_lengths.dtype)
    return out, new_lengths


def speed_perturb_audio(audio: torch.Tensor, rng: torch.Generator, config: SpecAugmentConfig,
                        input_lengths: torch.Tensor, hop_length: int):
    """``warp_speed`` on a fresh ``draw_speed`` from `rng`."""
    return warp_speed(audio, draw_speed(rng, config, audio), input_lengths, hop_length)
