"""The one traffic generator: it reads a mix's parameters from
``traffic/<mix>.json`` and turns them and a seed into the work a run
offers. Every seed gets the same set of sizes, in another order, with
other samples and other offsets into the PCM pool, so seeds change the
content of the work and not its amount.

A mix's ``lengths`` give a log-normal of utterance durations (its mean in
seconds, sigma of the log, clipped to [min_s, max_s]). A cycle of
``cycle`` batches takes the log-normal's quantiles (i + 0.5) / cycle:
- ``"per_batch": "bucket"`` (offline): each quantile picks a frame
  bucket and the batch's rows spread evenly over that bucket's
  durations, as a length-sorted batch job sends them;
- ``"per_batch": "rows"`` (training): the cycle's ``cycle * batch``
  pooled quantiles are dealt at random (from the seed) into ``cycle``
  batches, as a shuffled epoch deals its utterances, and each batch pads
  to its longest row's bucket; so a batch's padding varies as a shuffled
  epoch's does, and the seed changes which batches pad how far.
"""

from __future__ import annotations

import json
import math
import os
from statistics import NormalDist
from typing import Dict, List

import numpy as np

SAMPLE_RATE = 16000
HOP = 160
HERE = os.path.dirname(os.path.abspath(__file__))


def _rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for each stream of a seed (any int)."""
    return np.random.default_rng([seed % (1 << 64), stream])


def load_mix(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def bucket_frames(n_samples: int, frame_bucket: int) -> int:
    need = 1 + -(-n_samples // HOP)
    return -(-need // frame_bucket) * frame_bucket


def quantile_durations(lengths: dict, count: int) -> List[float]:
    """`count` durations in seconds: the clipped log-normal's quantiles."""
    sigma = lengths["sigma_log"]
    mu = math.log(lengths["mean_s"]) - sigma * sigma / 2.0
    dist = NormalDist()
    return [min(max(math.exp(mu + sigma * dist.inv_cdf((i + 0.5) / count)),
                    lengths["min_s"]), lengths["max_s"]) for i in range(count)]


def bucket_range(frames: int, frame_bucket: int, lengths: dict):
    """The sample counts [lo, hi] that pad to `frames`, within the clip."""
    lo = (frames - frame_bucket - 1) * HOP + 1
    hi = (frames - 1) * HOP
    return (max(lo, int(lengths["min_s"] * SAMPLE_RATE)),
            min(hi, int(lengths["max_s"] * SAMPLE_RATE)))


def make_batches(mix: dict, seed: int) -> List[Dict]:
    """One cycle of batches: [{"lengths": [samples...], "frames": padded
    frames}], in the seed's order."""
    rng = _rng(seed, 0)
    rows, fb, lengths = mix["batch"], mix["frame_bucket"], mix["lengths"]
    grid = quantile_durations(lengths, mix["cycle"])
    batches = []
    if mix["per_batch"] == "bucket":
        for dur in grid:
            frames = bucket_frames(int(round(dur * SAMPLE_RATE)), fb)
            lo, hi = bucket_range(frames, fb, lengths)
            ns = [int(lo + (j + 0.5) / rows * (hi - lo)) for j in range(rows)]
            batches.append({"lengths": [ns[j] for j in rng.permutation(rows)],
                            "frames": frames})
    elif mix["per_batch"] == "rows":
        pooled = [int(round(d * SAMPLE_RATE))
                  for d in quantile_durations(lengths, mix["cycle"] * rows)]
        dealt = rng.permutation(len(pooled)).reshape(mix["cycle"], rows)
        for idx in dealt:
            ns = [pooled[j] for j in idx]
            batches.append({"lengths": ns, "frames": bucket_frames(max(ns), fb)})
    else:
        raise ValueError(f"unknown per_batch {mix['per_batch']!r}")
    order = rng.permutation(len(batches))
    return [batches[i] for i in order]


def pcm_pool(mix: dict, seed: int) -> np.ndarray:
    """The seed's PCM: ``pool_s`` seconds of int16 noise whose loudness
    steps every 0.1 s over 30 dB, so the mel's statistics vary as speech's
    do."""
    rng = _rng(seed, 1)
    n = int(mix["pool_s"] * SAMPLE_RATE)
    blocks = -(-n // 1600)
    amp = 9000.0 * np.power(10.0, -1.5 * rng.random(blocks, dtype=np.float32))
    x = rng.standard_normal(n, dtype=np.float32) * np.repeat(amp, 1600)[:n]
    return np.clip(np.rint(x), -32768, 32767).astype(np.int16)


def place(batches: List[Dict], pool_len: int, seed: int) -> List[Dict]:
    """Give every row an offset into the pool: [{"rows": [(offset, n)],
    "frames"}]."""
    rng = _rng(seed, 2)
    out = []
    for b in batches:
        rows = [(int(rng.integers(0, pool_len - n)), n) for n in b["lengths"]]
        out.append({"rows": rows, "frames": b["frames"]})
    return out


def targets(mix: dict, batches: List[Dict], seed: int) -> List[List[np.ndarray]]:
    """Token ids for every row of every batch: ``targets_per_s`` a second
    of audio (at least 1), uniform over ``target_ids`` [lo, hi]."""
    rng = _rng(seed, 4)
    lo, hi = mix["target_ids"]
    return [[rng.integers(lo, hi + 1, size=max(1, round(mix["targets_per_s"] * n / SAMPLE_RATE)))
             .astype(np.int32) for n in b["lengths"]] for b in batches]
