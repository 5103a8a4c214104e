"""How far served greedy CTC output lies from the reference's logits.

A served text is a collapsed path: per output frame the program chose a
token (its argmax), repeats merged and blanks dropped. Of every frame
path that spells the served tokens, the one that lies closest to the
reference is found by a min-max CTC alignment: each frame costs the gap
by which the reference's logit of the path's token lies below the
reference's best logit at that frame, and a path costs its widest gap.
A text that equals the reference's own greedy decode costs 0; a flip
between two near-tied logits costs their small difference; a wrong or
missing token costs a wide gap. The text's stripped end spaces are
allowed back: the first and last blank states also take a space.
"""

from __future__ import annotations

from typing import List

import torch

BLANK = 0


def alignment_gaps(logits: torch.Tensor, n_frames: List[int], token_rows: List[List[int]],
                   space: int, block: int = 16) -> torch.Tensor:
    """(rows, 3) float64: for each row, along the paths that spell its
    served tokens in its valid frames and lie closest to the reference:
    the widest per-frame gap (a min-max path), the summed gap and the
    summed squared gap (min-sum paths). logits (rows, T, V) fp32, the
    reference's; n_frames each row's valid output frames; token_rows the
    served token ids; +inf where no path spells the tokens. Rows go
    `block` at a time, every row's frames in one loop over time."""
    out = []
    for lo in range(0, logits.shape[0], block):
        out.append(_gaps(logits[lo:lo + block], n_frames[lo:lo + block],
                         token_rows[lo:lo + block], space))
    return torch.cat(out)


def _gaps(logits, n_frames, token_rows, space):
    device = logits.device
    rows, t_max = logits.shape[0], max(n_frames)
    lg = logits[:, :t_max].to(torch.float64)
    gap = (lg.max(dim=-1, keepdim=True).values - lg).to(torch.float32)     # (R, T, V)
    n_states = [2 * len(t) + 1 for t in token_rows]
    s_max = max(n_states)
    labels = torch.full((rows, s_max), BLANK, dtype=torch.int64)
    for r, toks in enumerate(token_rows):
        if toks:
            labels[r, 1:2 * len(toks):2] = torch.tensor(toks)
    labels = labels.to(device)
    cost = gap.gather(2, labels[:, None, :].expand(rows, t_max, s_max))    # (R, T, S)
    end_blank = torch.minimum(gap[..., BLANK], gap[..., space])            # (R, T)
    last = torch.tensor(n_states, device=device) - 1
    cost[:, :, 0] = end_blank
    cost.scatter_(2, last[:, None, None].expand(rows, t_max, 1), end_blank[..., None])
    cost = torch.stack([cost, cost, cost * cost])                          # (3, R, T, S)
    skip = torch.zeros(rows, s_max, dtype=torch.bool, device=device)
    skip[:, 3::2] = labels[:, 3::2] != labels[:, 1:-2:2]
    is_max = torch.tensor([True, False, False], device=device)[:, None, None]
    inf = torch.full((3, rows, 2), float("inf"), device=device)
    best = torch.full((3, rows, s_max), float("inf"), device=device)
    best[:, :, :2] = cost[:, :, 0, :2]
    frames = torch.tensor(n_frames, device=device)[None, :, None]
    for t in range(1, t_max):
        one = torch.cat([inf[..., :1], best[..., :-1]], dim=-1)
        two = torch.where(skip, torch.cat([inf, best[..., :-2]], dim=-1), float("inf"))
        prev = torch.minimum(best, torch.minimum(one, two))
        step = torch.where(is_max, torch.maximum(cost[:, :, t], prev), cost[:, :, t] + prev)
        best = torch.where(t < frames, step, best)
    # a path ends in the last token's state or the blank after it
    idx = last[None, :, None].expand(3, rows, 1)
    end = torch.minimum(best.gather(2, idx), best.gather(2, (idx - 1).clamp(min=0)))[..., 0]
    return end.T.to(torch.float64).cpu()


def argmax_gaps(ref_logits: torch.Tensor, other_logits: torch.Tensor,
                n_frames: List[int]) -> torch.Tensor:
    """(rows, 3) float64: per row, over its valid frames, the widest gap,
    the summed gap and the summed squared gap by which the reference's
    logit of the token `other_logits` puts first lies below the
    reference's best (the control's reading: no decode)."""
    out = []
    for r, t_len in enumerate(n_frames):
        ref = ref_logits[r, :t_len].to(torch.float64)
        pick = other_logits[r, :t_len].argmax(dim=-1, keepdim=True)
        g = ref.max(dim=-1).values - ref.gather(1, pick)[:, 0]
        out.append(torch.stack([g.max(), g.sum(), (g * g).sum()]))
    return torch.stack(out).cpu()
