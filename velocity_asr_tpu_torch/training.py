"""Error-rate metrics (the metrics of velocity_asr_tpu/training.py:940-992).

Training itself is not ported yet; these are what evaluation needs.
"""

from __future__ import annotations

from typing import List

import numpy as np


def _edit_distance(pred: List[str], ref: List[str]) -> int:
    """Levenshtein distance via numpy row DP."""
    if not ref:
        return len(pred)
    ref_arr = np.array(ref)
    prev = np.arange(len(ref) + 1)
    for i, p in enumerate(pred, start=1):
        cur = np.empty(len(ref) + 1, dtype=np.int64)
        cur[0] = i
        sub = prev[:-1] + (ref_arr != p)
        for j in range(1, len(ref) + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, sub[j - 1])
        prev = cur
    return int(prev[-1])


def _error_rate(predictions: List[str], references: List[str], split) -> float:
    assert len(predictions) == len(references), (
        f"{len(predictions)} predictions vs {len(references)} references "
        "(a silent zip-truncation would understate the error rate)"
    )
    total_errors, total_units = 0, 0
    for pred, ref in zip(predictions, references):
        p, r = split(pred.lower()), split(ref.lower())
        total_errors += _edit_distance(p, r)
        total_units += len(r)
    return total_errors / total_units if total_units > 0 else 0.0


def compute_wer(predictions: List[str], references: List[str]) -> float:
    """Word error rate over lowercased, whitespace-split text."""
    return _error_rate(predictions, references, str.split)


def compute_cer(predictions: List[str], references: List[str]) -> float:
    """Character error rate over lowercased text."""
    return _error_rate(predictions, references, list)
