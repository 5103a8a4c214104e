"""SpecAugment for training (mirrors velocity_asr_tpu/augment.py, the
masking; on host-mel and device-mel batches alike).

Time and frequency masks on a batched mel, set to 0 (the batch pad
value). The JAX package draws them inside its jitted step from the step's
PRNG key; here they come from a ``torch.Generator`` the caller passes, on
the mel's device. The two give different numbers from the same seed; the
rule is the same: widths uniform in [0, max_width], each time mask capped
at half its utterance's valid length, starts drawn as
``randint(0, 2**30) % (limit - width + 1)`` so a mask never spills past
the limit. The waveform augmentations (``noise_injection``,
``speed_perturb``) act on device-mel batches' raw audio and are not
ported; the trainer raises on them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


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
    widths = torch.randint(0, max_width + 1, (batch, count), generator=rng, device=device)
    if width_cap is not None:
        widths = torch.minimum(widths, width_cap[:, None])
    widths = torch.minimum(widths, limit[:, None])
    # start ~ U[0, limit - width] inclusive: the last valid frame or bin
    # is reachable and a mask never spills past limit
    max_start = torch.clamp(limit[:, None] - widths + 1, min=1)
    starts = torch.randint(0, 2**30, (batch, count), generator=rng, device=device) % max_start
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
