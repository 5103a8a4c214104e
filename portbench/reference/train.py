"""The plain reference of a training step of the published recipe:
device-mel front end, SpecAugment, the forward with dropout, per-example
CTC over each row's valid frames divided by its target length (a row
with no alignment counts 0), the batch mean, its gradients by autograd,
then optax's chain: clip by the global norm, AdamW with bias-corrected
moments, weight decay and a linear-warmup cosine schedule.

The random draws are the trainer's rule, copied: step k's generator is
seeded (seed * 1,000,003 + k) mod 2^63 on the card, SpecAugment draws
first (per row: time-mask widths, then their starts, then the same for
frequency masks), then every dropout site in forward order. Same
generator, same calls, same shapes: the same masks.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from . import frontend
from . import model as reference


def step_seed(seed: int, step: int) -> int:
    return (seed * 1_000_003 + step) % (1 << 63)


def _sample_masks(rng, count, max_width, limit, width_cap=None):
    batch, device = limit.shape[0], limit.device
    widths = torch.randint(0, max_width + 1, (batch, count), generator=rng, device=device)
    if width_cap is not None:
        widths = torch.minimum(widths, width_cap[:, None])
    widths = torch.minimum(widths, limit[:, None])
    span = torch.clamp(limit[:, None] - widths + 1, min=1)
    starts = torch.randint(0, 2**30, (batch, count), generator=rng, device=device) % span
    return starts, widths


def _covered(size, starts, widths):
    pos = torch.arange(size, device=starts.device)[None, :, None]
    return ((pos >= starts[:, None, :]) & (pos < (starts + widths)[:, None, :])).any(-1)


def spec_augment(mel, rng, aug: dict, lengths):
    """Time masks within each row's valid frames, each at most half of
    them; frequency masks within the bins; masked values set to 0."""
    batch, t_len, n_mels = mel.shape
    if aug["num_time_masks"] > 0:
        starts, widths = _sample_masks(rng, aug["num_time_masks"], aug["time_mask_frames"],
                                       lengths, width_cap=lengths // 2)
        mel = mel.masked_fill(_covered(t_len, starts, widths)[:, :, None], 0.0)
    if aug["num_freq_masks"] > 0:
        limit = torch.full((batch,), n_mels, dtype=torch.int64, device=mel.device)
        starts, widths = _sample_masks(rng, aug["num_freq_masks"], aug["freq_mask_bins"], limit)
        mel = mel.masked_fill(_covered(n_mels, starts, widths)[:, None, :], 0.0)
    return mel


def ctc_mean(logits, targets, out_lengths, target_lengths):
    """The batch mean of per-row CTC (fp64) over each row's target length."""
    log_probs = F.log_softmax(logits.to(torch.float64), dim=-1).transpose(0, 1)
    per = F.ctc_loss(log_probs, targets, out_lengths, target_lengths, blank=0,
                     reduction="none", zero_infinity=True)
    valid = torch.arange(targets.shape[1], device=targets.device)[None, :] < target_lengths[:, None]
    repeats = ((targets[:, 1:] == targets[:, :-1]) & valid[:, 1:]).sum(1)
    ok = (out_lengths >= target_lengths + repeats) & torch.isfinite(per)
    per = torch.where(ok, per, torch.zeros_like(per))
    return (per / target_lengths.to(torch.float64).clamp_min(1.0)).mean()


def learning_rate(recipe: dict, count: int) -> float:
    """The rate of update `count` (from 0): linear warmup, then cosine to
    a tenth, evaluated in fp32 with the recipe's pi of 3.14159."""
    f32 = np.float32
    warm_steps, total = recipe["warmup_steps"], recipe["max_steps"]
    step = f32(count + 1)
    if step < warm_steps:
        return float(f32(recipe["learning_rate"]) * (step / f32(max(warm_steps, 1))))
    progress = min((step - f32(warm_steps)) / f32(max(total - warm_steps, 1)), f32(1.0))
    cosine = f32(0.5) * (f32(1) + np.cos(f32(progress) * f32(3.14159)))
    return float(f32(recipe["learning_rate"]) * (f32(0.1) + f32(0.9) * cosine))


def run_steps(params0: Dict[str, torch.Tensor], m: dict, recipe: dict, batches: List[dict],
              seed: int) -> dict:
    """Follow the trainer from `params0` through len(batches) steps.

    Each batch: {"pcm": [int16 rows], "frames", "targets" (B, U) int64,
    "target_lengths" (B,)}. Returns {"losses": [...], "first_grad": {leaf:
    clipped gradient of step 1}, "params": {leaf: after the last step}}."""
    names = list(params0)
    params = [params0[n].detach().clone().requires_grad_(True) for n in names]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, first = [], None
    for k, b in enumerate(batches):
        device = params[0].device
        rng = torch.Generator(device=device)
        rng.manual_seed(step_seed(seed, k))
        lengths = torch.tensor([frontend.valid_frames(len(p)) for p in b["pcm"]], device=device)
        mel = frontend.normalized_mel(b["pcm"], b["frames"], device)
        mel = spec_augment(mel, rng, recipe["augment"], lengths)
        p = dict(zip(names, params))
        logits = reference.forward(p, m, mel, rng=rng)
        loss = ctc_mean(logits, b["targets"].to(device), (lengths + 1) // 2,
                        b["target_lengths"].to(device))
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        losses.append(loss.item())
        with torch.no_grad():
            grads = [torch.zeros_like(q) if g is None else g.float() for q, g in zip(params, grads)]
            norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
            scale = 1.0 if norm < recipe["grad_clip_norm"] else recipe["grad_clip_norm"] / norm
            grads = [g * scale for g in grads]
            if first is None:
                first = {n: g.clone() for n, g in zip(names, grads)}
            c1, c2 = 1 - b1 ** (k + 1), 1 - b2 ** (k + 1)
            lr = learning_rate(recipe, k)
            for q, g, m1, m2 in zip(params, grads, mu, nu):
                m1.mul_(b1).add_(g, alpha=1 - b1)
                m2.mul_(b2).addcmul_(g, g, value=1 - b2)
                update = (m1 / c1) / ((m2 / c2).sqrt() + eps) + recipe["weight_decay"] * q
                q.sub_(lr * update)
    return {"losses": losses, "first_grad": first,
            "params": {n: q.detach() for n, q in zip(names, params)}}


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              keep: List[str] = None) -> Dict[str, float]:
    """Per leaf |got - want| over max(want, the median leaf's want): the
    gap of two norms, not the norm of a difference."""
    names = keep if keep is not None else list(want)
    median = float(np.median([want[n] for n in want]))
    return {n: abs(got[n] - want[n]) / max(want[n], median) for n in names}


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def changed(after: Dict[str, torch.Tensor], before: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float((after[n].double() - before[n].double()).norm()) for n in before}


def moving_leaves(first_grad_norms: Dict[str, float], share: float = 1e-3) -> List[str]:
    """Leaves whose reference gradient is not nought to rounding: at least
    `share` of the median leaf's norm."""
    median = float(np.median(list(first_grad_norms.values())))
    return [n for n, v in first_grad_norms.items() if v >= share * median]

