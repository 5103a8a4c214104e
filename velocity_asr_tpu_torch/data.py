"""Data pipeline (mirrors velocity_asr_tpu/data.py).

``ASRDataset`` reads a JSONL manifest and computes each item's log-mel on
the host (numpy, normalised over the utterance), or with ``device_mel``
keeps the raw audio for the trainer to turn into a mel on the device;
``ASRCollator`` pads a batch to a multiple of ``frame_bucket`` frames
with ``mel_pad_value`` (raw audio: reflect-padded to that many frames'
samples, shipped as int16 PCM), so batch shapes repeat;
``calibration_batches`` draws the mel batches that calibrate static int8
scales. The global context pools over the padded length, so the padding
is part of every result. ``DataLoader`` batches a dataset for training on
``torch.utils.data.DataLoader`` worker processes (shuffled from an
explicit generator, a new order each epoch; the collated numpy arrays,
the int16 PCM too, cross from the workers as they are) and ``cycle``
repeats it. ``LibriSpeechDataset`` reads LibriSpeech's on-disk layout
(FLAC through ``io.decode_audio_file``); ``create_dataloader`` and
``create_librispeech_dataloaders`` build the training and validation
loaders of a manifest or of LibriSpeech splits. A manifest row's optional
integer ``language`` rides along to the batch (the language-ID head that
reads it is not ported).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.data

from .audio import HOP_LENGTH, SAMPLE_RATE, compute_mel_spectrogram_np, load_audio

PAD_TOKEN_ID = 2  # <pad>


class ASRDataset:
    """Manifest-backed dataset.

    Manifest format (JSON lines): {"audio_path": ..., "text": ...,
    "duration": ...}. Filters by duration (an absent duration is kept),
    skips missing files, and builds a character vocabulary from the
    corpus (<blank>=0, <unk>=1, <pad>=2, then the sorted characters), or
    encodes with `tokenizer` (an object with ``encode(text)``) and builds
    none. With `device_mel` an item carries its raw audio and its frame
    count 1 + samples // hop instead of a mel. A row's integer
    ``language`` becomes the item's.
    """

    def __init__(self, manifest_path: str, tokenizer: Optional[Any] = None,
                 max_duration: Optional[float] = 30.0, min_duration: float = 0.5,
                 sample_rate: int = SAMPLE_RATE, normalize_audio: bool = True,
                 device_mel: bool = False):
        self.manifest_path = manifest_path
        self.tokenizer = tokenizer
        self.max_duration = max_duration
        self.min_duration = min_duration
        self.sample_rate = sample_rate
        self.normalize_audio = normalize_audio
        self.device_mel = device_mel
        if device_mel and not normalize_audio:
            # the device-mel trainer always normalises on the device
            raise ValueError(
                "normalize_audio=False is not supported with device_mel "
                "(the train step normalizes on device); use host mel"
            )
        self.samples = self._load_manifest()
        self.vocab = self._build_vocab() if tokenizer is None else None

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
        if self.tokenizer is not None:
            return self.tokenizer.encode(text)
        unk = self.vocab["<unk>"]
        return [self.vocab.get(c, unk) for c in text]

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        sample = self.samples[idx]
        audio = load_audio(sample["audio_path"], sample_rate=self.sample_rate)
        text = sample.get("text", "")
        item = speech_item(audio, text, self.text_to_tokens(text), self.device_mel,
                           self.normalize_audio)
        if "language" in sample:
            item["language"] = np.int32(sample["language"])
        return item


def speech_item(audio: np.ndarray, text: str, tokens: List[int], device_mel: bool,
                normalize: bool = True) -> Dict[str, Any]:
    """A dataset item: targets and the host mel with its frame count, or
    with `device_mel` the raw audio and its frame count 1 + samples // hop
    (the mel is computed on the device by the trainer)."""
    item = {
        "targets": np.asarray(tokens, np.int32),
        "target_lengths": np.int32(len(tokens)),
        "text": text,
    }
    if device_mel:
        item["audio"] = np.asarray(audio, np.float32)
        item["input_lengths"] = np.int32(1 + len(audio) // HOP_LENGTH)
    else:
        mel = compute_mel_spectrogram_np(audio, normalize=normalize)
        item["mel_spectrogram"] = mel
        item["input_lengths"] = np.int32(mel.shape[0])
    return item


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


class ASRCollator:
    """Pad a batch: mel frames to a multiple of `frame_bucket`, targets to
    a multiple of `target_bucket` (1 and 1 pad to the batch maximum). A
    batch of raw-audio items pads the audio instead (``_pad_audio``)."""

    def __init__(self, pad_token_id: int = PAD_TOKEN_ID, mel_pad_value: float = 0.0,
                 frame_bucket: int = 100, target_bucket: int = 32):
        self.pad_token_id = pad_token_id
        self.mel_pad_value = mel_pad_value
        self.frame_bucket = max(frame_bucket, 1)
        self.target_bucket = max(target_bucket, 1)

    def __call__(self, batch: List[Dict[str, Any]]) -> Dict[str, Any]:
        if "audio" in batch[0]:
            return {"audio": self._pad_audio(batch), **self._targets(batch)}
        max_mel = _round_up(
            max(item["mel_spectrogram"].shape[0] for item in batch), self.frame_bucket
        )
        mel_bins = batch[0]["mel_spectrogram"].shape[1]
        mels = np.full((len(batch), max_mel, mel_bins), self.mel_pad_value, np.float32)
        for i, item in enumerate(batch):
            mels[i, : item["mel_spectrogram"].shape[0]] = item["mel_spectrogram"]
        return {"mel_spectrogram": mels, **self._targets(batch)}

    def _targets(self, batch: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Targets padded with `pad_token_id` to a multiple of
        `target_bucket`, the input and target lengths, the texts."""
        max_tgt = _round_up(
            max(1, max(item["targets"].shape[0] for item in batch)), self.target_bucket
        )
        targets = np.full((len(batch), max_tgt), self.pad_token_id, np.int32)
        for i, item in enumerate(batch):
            targets[i, : item["targets"].shape[0]] = item["targets"]
        out = {
            "targets": targets,
            "input_lengths": np.asarray([item["input_lengths"] for item in batch], np.int32),
            "target_lengths": np.asarray([item["target_lengths"] for item in batch], np.int32),
            "texts": [item.get("text", "") for item in batch],
        }
        self._collate_language(batch, out)
        return out

    @staticmethod
    def _collate_language(batch: List[Dict[str, Any]], out: Dict[str, Any]) -> None:
        """The items' language labels as out["language"] (int32), when every
        item has one; none, no key; a mix raises."""
        n_labeled = sum(1 for item in batch if "language" in item)
        if n_labeled == 0:
            return
        if n_labeled != len(batch):
            raise ValueError(
                f"batch mixes labeled and unlabeled utterances: {n_labeled}"
                f"/{len(batch)} rows carry a 'language' field; label every "
                "manifest row (or none)"
            )
        out["language"] = np.asarray([item["language"] for item in batch], np.int32)

    def _pad_audio(self, batch: List[Dict[str, Any]]) -> np.ndarray:
        """Device-mel collation: the frame count 1 + ceil(samples / hop) of
        the longest item, rounded up to the bucket, fixes the sample length
        (frames - 1) * hop, which covers every item; each item is
        reflect-padded to it (the offline pipeline's right reflect pad, so
        the mel of the valid frames is exact) and crosses as int16 PCM,
        clip(audio * 32768, -32768, 32767)."""
        max_mel = _round_up(max(1 + -(-len(item["audio"]) // HOP_LENGTH) for item in batch),
                            self.frame_bucket)
        target_samples = (max_mel - 1) * HOP_LENGTH
        audio = np.zeros((len(batch), target_samples), np.int16)
        for i, item in enumerate(batch):
            a = np.asarray(item["audio"], np.float32)
            if len(a) >= 2:
                padded = np.pad(a, (0, target_samples - len(a)), mode="reflect")
            else:
                padded = np.zeros(target_samples, np.float32)
                padded[: len(a)] = a
            audio[i] = np.clip(padded * 32768.0, -32768, 32767).astype(np.int16)
        return audio


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


def create_dataloader(manifest_path: str, batch_size: int = 8, shuffle: bool = True,
                      num_workers: int = 4, max_duration: Optional[float] = 30.0,
                      min_duration: float = 0.5,
                      device_mel: bool = False) -> Tuple[DataLoader, ASRDataset]:
    """(loader, dataset) of a manifest, collated by ``ASRCollator()``; a
    shuffled loader drops its last short batch."""
    dataset = ASRDataset(manifest_path, max_duration=max_duration,
                         min_duration=min_duration, device_mel=device_mel)
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                        num_workers=num_workers, collate_fn=ASRCollator(), drop_last=shuffle)
    return loader, dataset


LIBRISPEECH_CHARS = " abcdefghijklmnopqrstuvwxyz'"


class LibriSpeechDataset:
    """LibriSpeech read from its on-disk layout:
    root/LibriSpeech/<split>/<speaker>/<chapter>/{<id>.flac,
    <speaker>-<chapter>.trans.txt}, speakers and chapters in sorted order,
    utterances in transcript order (a listed utterance without its FLAC is
    skipped). Fixed vocabulary: <blank>, <unk>, <pad>, then
    ``LIBRISPEECH_CHARS`` (31 tokens); transcripts are lowercased; audio past max_duration seconds is cut.
    Items as ``ASRDataset``'s (host mel, or with `device_mel` the raw
    audio)."""

    def __init__(self, root: str = "./data", split: str = "train-clean-100",
                 max_duration: Optional[float] = 30.0, device_mel: bool = False):
        self.root = root
        self.split = split
        self.max_duration = max_duration
        self.device_mel = device_mel
        split_dir = os.path.join(root, "LibriSpeech", split)
        if not os.path.isdir(split_dir):
            raise FileNotFoundError(f"LibriSpeech split not found: {split_dir}")
        self.entries: List[Tuple[str, str]] = []  # (flac path, transcript)
        for speaker in sorted(os.listdir(split_dir)):
            spk_dir = os.path.join(split_dir, speaker)
            if not os.path.isdir(spk_dir):
                continue
            for chapter in sorted(os.listdir(spk_dir)):
                chap_dir = os.path.join(spk_dir, chapter)
                trans = os.path.join(chap_dir, f"{speaker}-{chapter}.trans.txt")
                if not os.path.exists(trans):
                    continue
                with open(trans, "r", encoding="utf-8") as f:
                    for line in f:
                        utt_id, _, text = line.strip().partition(" ")
                        flac = os.path.join(chap_dir, f"{utt_id}.flac")
                        if os.path.exists(flac):
                            self.entries.append((flac, text))
        self.vocab = self._build_vocab()

    @staticmethod
    def _build_vocab() -> Dict[str, int]:
        vocab = {"<blank>": 0, "<unk>": 1, "<pad>": 2}
        for i, char in enumerate(LIBRISPEECH_CHARS):
            vocab[char] = i + 3
        return vocab

    def text_to_tokens(self, text: str) -> List[int]:
        unk = self.vocab["<unk>"]
        return [self.vocab.get(c, unk) for c in text.lower()]

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        path, transcript = self.entries[idx]
        waveform = load_audio(path, sample_rate=SAMPLE_RATE)
        if self.max_duration:
            waveform = waveform[: int(self.max_duration * SAMPLE_RATE)]
        return speech_item(waveform, transcript.lower(), self.text_to_tokens(transcript),
                           self.device_mel)


def create_librispeech_dataloaders(root: str = "./data",
                                   train_splits: Tuple[str, ...] = ("train-clean-100",),
                                   val_splits: Tuple[str, ...] = ("dev-clean",),
                                   batch_size: int = 8, num_workers: int = 4,
                                   max_duration: float = 30.0, device_mel: bool = False
                                   ) -> Tuple[DataLoader, DataLoader, Dict[str, int]]:
    """(train loader, validation loader, vocabulary) of LibriSpeech splits:
    several splits concatenate in order, the validation sets encode with
    the first train split's vocabulary, the train loader shuffles and
    drops its last short batch."""
    def split_sets(splits):
        return [LibriSpeechDataset(root=root, split=s, max_duration=max_duration,
                                   device_mel=device_mel) for s in splits]

    train_sets = split_sets(train_splits)
    vocab = train_sets[0].vocab
    val_sets = split_sets(val_splits)
    for ds in val_sets:
        ds.vocab = vocab
    def joined(sets):
        return torch.utils.data.ConcatDataset(sets) if len(sets) > 1 else sets[0]

    train_ds, val_ds = joined(train_sets), joined(val_sets)
    collator = ASRCollator()
    train_loader = DataLoader(train_ds, batch_size=batch_size, shuffle=True,
                              num_workers=num_workers, collate_fn=collator, drop_last=True)
    val_loader = DataLoader(val_ds, batch_size=batch_size, shuffle=False,
                            num_workers=num_workers, collate_fn=collator, drop_last=False)
    return train_loader, val_loader, vocab
