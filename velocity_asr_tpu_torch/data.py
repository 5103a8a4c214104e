"""Data pipeline (mirrors velocity_asr_tpu/data.py, host-mel path).

``ASRDataset`` reads a JSONL manifest and computes each item's log-mel on
the host (numpy, normalised over the utterance); ``ASRCollator`` pads a
batch to a multiple of ``frame_bucket`` frames with ``mel_pad_value``, so
batch shapes repeat; ``calibration_batches`` draws the mel batches that
calibrate static int8 scales. The global context pools over the padded
length, so the padding is part of every result. ``DataLoader`` batches a
dataset for training on ``torch.utils.data.DataLoader`` worker processes
(shuffled from an explicit generator, a new order each epoch) and
``cycle`` repeats it. Raw-audio (device-mel) items and language labels
are not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.utils.data

from .audio import SAMPLE_RATE, compute_mel_spectrogram_np, load_audio

PAD_TOKEN_ID = 2  # <pad>


class ASRDataset:
    """Manifest-backed dataset.

    Manifest format (JSON lines): {"audio_path": ..., "text": ...,
    "duration": ...}. Filters by duration (an absent duration is kept),
    skips missing files, and builds a character vocabulary from the
    corpus (<blank>=0, <unk>=1, <pad>=2, then the sorted characters).
    """

    def __init__(self, manifest_path: str, max_duration: Optional[float] = 30.0,
                 min_duration: float = 0.5, sample_rate: int = SAMPLE_RATE,
                 normalize_audio: bool = True):
        self.manifest_path = manifest_path
        self.max_duration = max_duration
        self.min_duration = min_duration
        self.sample_rate = sample_rate
        self.normalize_audio = normalize_audio
        self.samples = self._load_manifest()
        self.vocab = self._build_vocab()

    def _load_manifest(self) -> List[Dict[str, Any]]:
        samples = []
        with open(self.manifest_path, "r", encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                entry = json.loads(line)
                duration = entry.get("duration")
                if duration is not None:
                    if duration < self.min_duration:
                        continue
                    if self.max_duration and duration > self.max_duration:
                        continue
                if not os.path.exists(entry["audio_path"]):
                    continue
                samples.append(entry)
        return samples

    def _build_vocab(self) -> Dict[str, int]:
        chars = set()
        for sample in self.samples:
            chars.update(sample.get("text", ""))
        vocab = {"<blank>": 0, "<unk>": 1, "<pad>": 2}
        for i, char in enumerate(sorted(chars)):
            vocab[char] = i + 3
        return vocab

    def text_to_tokens(self, text: str) -> List[int]:
        unk = self.vocab["<unk>"]
        return [self.vocab.get(c, unk) for c in text]

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        sample = self.samples[idx]
        audio = load_audio(sample["audio_path"], sample_rate=self.sample_rate)
        text = sample.get("text", "")
        tokens = self.text_to_tokens(text)
        mel = compute_mel_spectrogram_np(audio, normalize=self.normalize_audio)
        return {
            "targets": np.asarray(tokens, np.int32),
            "target_lengths": np.int32(len(tokens)),
            "text": text,
            "mel_spectrogram": mel,
            "input_lengths": np.int32(mel.shape[0]),
        }


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


class ASRCollator:
    """Pad a batch: mel frames to a multiple of `frame_bucket`, targets to
    a multiple of `target_bucket` (1 and 1 pad to the batch maximum)."""

    def __init__(self, pad_token_id: int = PAD_TOKEN_ID, mel_pad_value: float = 0.0,
                 frame_bucket: int = 100, target_bucket: int = 32):
        self.pad_token_id = pad_token_id
        self.mel_pad_value = mel_pad_value
        self.frame_bucket = max(frame_bucket, 1)
        self.target_bucket = max(target_bucket, 1)

    def __call__(self, batch: List[Dict[str, Any]]) -> Dict[str, Any]:
        max_mel = _round_up(
            max(item["mel_spectrogram"].shape[0] for item in batch), self.frame_bucket
        )
        max_tgt = _round_up(
            max(1, max(item["targets"].shape[0] for item in batch)), self.target_bucket
        )
        n = len(batch)
        mel_bins = batch[0]["mel_spectrogram"].shape[1]
        mels = np.full((n, max_mel, mel_bins), self.mel_pad_value, np.float32)
        targets = np.full((n, max_tgt), self.pad_token_id, np.int32)
        input_lengths = np.empty((n,), np.int32)
        target_lengths = np.empty((n,), np.int32)
        texts = []
        for i, item in enumerate(batch):
            m, t = item["mel_spectrogram"], item["targets"]
            mels[i, : m.shape[0]] = m
            targets[i, : t.shape[0]] = t
            input_lengths[i] = item["input_lengths"]
            target_lengths[i] = item["target_lengths"]
            texts.append(item.get("text", ""))
        return {
            "mel_spectrogram": mels,
            "targets": targets,
            "input_lengths": input_lengths,
            "target_lengths": target_lengths,
            "texts": texts,
        }


class DataLoader:
    """Collated batches of a dataset, in worker processes.

    Each epoch shuffles (when `shuffle`) with a ``torch.Generator`` seeded
    by ``seed + epoch``, so a run's order is fixed by its seed; items are
    loaded by `num_workers` processes (0: in this process) and collated by
    `collate_fn` (default ``ASRCollator()``), `prefetch` batches ahead per
    worker. `drop_last` drops a final short batch.
    """

    def __init__(self, dataset, batch_size: int = 8, shuffle: bool = True,
                 num_workers: int = 4, collate_fn: Optional[Callable] = None,
                 drop_last: bool = False, seed: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(num_workers, 0)
        self.collate_fn = collate_fn or ASRCollator()
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        generator = torch.Generator().manual_seed(self.seed + self._epoch)
        self._epoch += 1
        if len(self) == 0:
            return
        workers = min(self.num_workers, len(self))
        loader = torch.utils.data.DataLoader(
            self.dataset, batch_size=self.batch_size, shuffle=self.shuffle,
            generator=generator, num_workers=workers, collate_fn=self.collate_fn,
            drop_last=self.drop_last,
            prefetch_factor=self.prefetch if workers else None,
        )
        yield from loader


def cycle(loader: DataLoader) -> Iterator[Dict[str, Any]]:
    """Repeat a loader forever; raise if one pass yields nothing (nothing
    to train on)."""
    while True:
        n = 0
        for batch in loader:
            n += 1
            yield batch
        if n == 0:
            raise RuntimeError(
                "DataLoader yielded no batches (empty dataset after filtering, or "
                "fewer samples than one batch with drop_last): nothing to train on")


def calibration_batches(ds: Any, collator: ASRCollator, batch_size: int, num_batches: int,
                        max_items: Optional[int] = None) -> Iterator[np.ndarray]:
    """Yield the mel batches that calibrate static int8 scales: the first
    min(len(ds), num_batches * batch_size, max_items) utterances, in
    order, collated `batch_size` at a time."""
    n = min(len(ds), num_batches * batch_size)
    if max_items is not None:
        n = min(n, max_items)
    for start in range(0, n, batch_size):
        items = [ds[i] for i in range(start, min(start + batch_size, n))]
        yield collator(items)["mel_spectrogram"]
