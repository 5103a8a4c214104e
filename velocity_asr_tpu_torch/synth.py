"""Synthetic speech corpus (a numpy copy of the parts of
velocity_asr_tpu/synth.py that ``write_corpus`` and training need).

Each character is a "phoneme" with its own spectrum; utterances add
speaker, rate, level and noise jitter. Everything is deterministic in
(seed, split, index), so ``write_corpus(dir, n, split="test", seed=1234)``
regenerates the JAX package's held-out set bit for bit, and its WER
results (checkpoints/synth_run/eval_fp32_final.json) apply to it;
``SyntheticSpeechDataset`` serves the train and dev splits as the JAX
package's does (one language; host mel, or raw audio for the device mel).
``write_librispeech_tree`` writes utterances of a split in LibriSpeech's
on-disk layout (FLAC, transcripts in upper case) with a manifest over
the same files.
"""

from __future__ import annotations

import hashlib
import json
import os
import wave
from typing import Callable, Dict, List, Optional

import numpy as np

from .audio import SAMPLE_RATE
from .data import speech_item

VOWELS = "aeiouy"
CHARS = "abcdefghijklmnopqrstuvwxyz"


def _char_seed(master_seed: int, *parts) -> np.random.Generator:
    h = hashlib.sha256(("|".join(map(str, parts)) + f"|{master_seed}").encode())
    return np.random.default_rng(int.from_bytes(h.digest()[:8], "little"))


class SynthVoice:
    """Deterministic text -> waveform renderer."""

    def __init__(self, sample_rate: int = SAMPLE_RATE, seed: int = 1234):
        self.sr = sample_rate
        self.seed = seed
        # Character-specific spectra, fixed for the corpus lifetime.
        rng = _char_seed(seed, "phonemes")
        self.formants: Dict[str, np.ndarray] = {}
        self.noise_tilt: Dict[str, float] = {}
        for i, c in enumerate(CHARS):
            # three "formants", well separated across characters
            base = 280.0 + 110.0 * i  # 280 .. 3030 Hz
            self.formants[c] = np.array(
                [base, base * 2.1 + 150, base * 3.3 + 400]
            ) + rng.uniform(-30, 30, 3)
            self.noise_tilt[c] = float(rng.uniform(0.3, 3.0))

    def _phoneme(self, c: str, dur_s: float, fscale: float, rng) -> np.ndarray:
        n = max(int(dur_s * self.sr), 8)
        t = np.arange(n) / self.sr
        if c == " ":
            return np.zeros(n, np.float32)
        amps = np.array([1.0, 0.55, 0.3]) * rng.uniform(0.85, 1.15, 3)
        freqs = self.formants[c] * fscale
        sig = sum(
            a * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
            for a, f in zip(amps, freqs)
        )
        if c not in VOWELS:
            # consonant: add a char-tilted noise burst and shorten the
            # periodic part so the phone is transient-dominated
            noise = rng.standard_normal(n)
            # char-specific spectral tilt: first-difference mix colors the
            # noise from flat (alpha~0) to high-pass (alpha~0.75)
            alpha = self.noise_tilt[c] / (1 + self.noise_tilt[c])
            shaped = np.copy(noise)
            shaped[1:] = noise[1:] - alpha * noise[:-1]
            sig = 0.45 * sig + 0.8 * shaped
        env = np.minimum(1.0, np.minimum(t, t[::-1]) / 0.012)  # 12 ms ramps
        return (sig * env).astype(np.float32)

    def render(self, text: str, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Render text to a 16 kHz waveform with speaker/rate/noise jitter.

        The phoneme table covers lowercase a-z and space; other characters
        render as silence."""
        rng = rng or np.random.default_rng(0)
        text = "".join(
            c if c in self.formants or c == " " else " "
            for c in text.lower()
        )
        fscale = rng.uniform(0.85, 1.2)  # "speaker" formant scale
        rate = rng.uniform(0.8, 1.25)  # speaking rate
        level = rng.uniform(0.18, 0.4)
        xfade = int(0.010 * self.sr)

        pieces: List[np.ndarray] = [np.zeros(int(rng.uniform(0.04, 0.15) * self.sr), np.float32)]
        for c in text:
            if c == " ":
                dur = rng.uniform(0.05, 0.12)
            else:
                dur = rng.uniform(0.07, 0.13) * rate
            pieces.append(self._phoneme(c, dur, fscale, rng))
        pieces.append(np.zeros(int(rng.uniform(0.04, 0.15) * self.sr), np.float32))

        # overlap-add with short crossfades
        total = sum(len(p) for p in pieces) - xfade * (len(pieces) - 1)
        out = np.zeros(max(total, 1), np.float32)
        pos = 0
        for p in pieces:
            out[pos : pos + len(p)] += p
            pos += len(p) - xfade
        peak = np.max(np.abs(out)) + 1e-9
        out = out / peak * level
        snr_db = rng.uniform(12.0, 32.0)
        noise_rms = level / np.sqrt(2) / (10 ** (snr_db / 20))
        out = out + rng.standard_normal(len(out)).astype(np.float32) * noise_rms
        return out.astype(np.float32)


def make_lexicon(n_words: int = 1500, seed: int = 7) -> List[str]:
    """Deterministic pseudo-word lexicon (CV-patterned, 2-8 chars)."""
    rng = _char_seed(seed, "lexicon")
    consonants = [c for c in CHARS if c not in VOWELS]
    words, seen = [], set()
    while len(words) < n_words:
        n = int(rng.integers(2, 9))
        w = []
        for i in range(n):
            pool = consonants if (i % 2 == 0) != bool(rng.integers(0, 4) == 0) else VOWELS
            w.append(pool[int(rng.integers(0, len(pool)))])
        w = "".join(w)
        if w not in seen:
            seen.add(w)
            words.append(w)
    return words


def sample_sentence(lexicon: List[str], rng, min_words: int = 2, max_words: int = 8) -> str:
    n = int(rng.integers(min_words, max_words + 1))
    return " ".join(lexicon[int(rng.integers(0, len(lexicon)))] for _ in range(n))


def utterance(idx: int, split: str = "test", seed: int = 1234,
              lexicon: Optional[List[str]] = None,
              voice: Optional[SynthVoice] = None,
              min_words: int = 2, max_words: int = 8):
    """(text, 16 kHz float32 audio) of one corpus utterance."""
    lexicon = lexicon if lexicon is not None else make_lexicon(1500, seed=seed)
    voice = voice if voice is not None else SynthVoice(seed=seed)
    text = sample_sentence(lexicon, _char_seed(seed, "text", split, idx), min_words, max_words)
    audio = voice.render(text, _char_seed(seed, "audio", split, idx))
    return text, audio


class SyntheticSpeechDataset:
    """``data.ASRDataset``-compatible corpus generated on the fly: items
    deterministic in (seed, split, idx), bit-equal to the JAX package's
    ``SyntheticSpeechDataset(languages=1)``: host mel, or with
    `device_mel` the raw audio and its frame count (the mel is computed on
    the device by the trainer). The vocabulary is the manifest datasets'
    rule over a-z and space: <blank>, <unk>, <pad>, then the sorted
    characters, 30 tokens."""

    def __init__(self, n_utts: int = 10000, split: str = "train", seed: int = 1234,
                 min_words: int = 2, max_words: int = 8, device_mel: bool = False):
        self.n_utts = n_utts
        self.split = split
        self.seed = seed
        self.min_words = min_words
        self.max_words = max_words
        self.device_mel = device_mel
        self.voice = SynthVoice(seed=seed)
        self.lexicon = make_lexicon(1500, seed=seed)
        specials = ["<blank>", "<unk>", "<pad>"]
        self.vocab = {tok: i for i, tok in enumerate(specials + sorted(set(CHARS + " ")))}

    def __len__(self) -> int:
        return self.n_utts

    def text_to_tokens(self, text: str) -> List[int]:
        unk = self.vocab["<unk>"]
        return [self.vocab.get(c, unk) for c in text]

    def text_for(self, idx: int) -> str:
        """Utterance idx's transcript, without rendering its audio."""
        return sample_sentence(self.lexicon, _char_seed(self.seed, "text", self.split, idx),
                               self.min_words, self.max_words)

    def __getitem__(self, idx: int) -> Dict:
        text, audio = utterance(idx, self.split, self.seed, self.lexicon, self.voice,
                                self.min_words, self.max_words)
        return speech_item(audio, text, self.text_to_tokens(text), self.device_mel)


def write_corpus(out_dir: str, n_utts: int, split: str = "test", seed: int = 1234,
                 lexicon_words: int = 1500, min_words: int = 2,
                 max_words: int = 8) -> str:
    """Write utterances 0..n_utts-1 of a split as 16-bit WAVs plus a JSONL
    manifest (audio_path, text, duration); returns the manifest path."""
    lexicon = make_lexicon(lexicon_words, seed=seed)
    voice = SynthVoice(seed=seed)
    os.makedirs(out_dir, exist_ok=True)
    manifest = os.path.join(out_dir, f"{split}_manifest.jsonl")
    with open(manifest, "w") as mf:
        for i in range(n_utts):
            text, audio = utterance(i, split, seed, lexicon, voice, min_words, max_words)
            path = os.path.join(out_dir, f"{split}_{i:05d}.wav")
            pcm = np.clip(audio * 32767, -32768, 32767).astype("<i2")
            with wave.open(path, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(SAMPLE_RATE)
                w.writeframes(pcm.tobytes())
            row = {"audio_path": path, "text": text, "duration": len(audio) / SAMPLE_RATE}
            mf.write(json.dumps(row) + "\n")
    return manifest


def write_librispeech_tree(root: str, split: str, n_utts: int,
                           encode_flac: Callable[[np.ndarray], bytes], speakers: int = 2,
                           chapters: int = 2, synth_split: str = "train", seed: int = 1234,
                           min_words: int = 2, max_words: int = 8, map_fn=map) -> str:
    """Write utterances 0..n_utts-1 of `synth_split` as the LibriSpeech split
    `split` under root/LibriSpeech/: `speakers` x `chapters` directories
    (speaker 100 + s, chapter 1000 + c, utterances dealt to them in turn,
    ids <speaker>-<chapter>-<nnnn>), each utterance int16 PCM encoded to
    FLAC by `encode_flac` (int16 samples -> FLAC bytes), each chapter's
    ``<speaker>-<chapter>.trans.txt`` in upper case as LibriSpeech's are.
    Also writes root/<split>_manifest.jsonl (audio_path, lower-case text,
    duration) over the same files; returns its path. `map_fn` runs
    encode_flac over the utterances (``map``, or a process pool's)."""
    lexicon = make_lexicon(1500, seed=seed)
    voice = SynthVoice(seed=seed)
    groups = [(100 + s, 1000 + c) for s in range(speakers) for c in range(chapters)]
    lines: Dict[tuple, List[str]] = {g: [] for g in groups}
    manifest = os.path.join(root, f"{split}_manifest.jsonl")
    os.makedirs(root, exist_ok=True)
    utts = [utterance(i, synth_split, seed, lexicon, voice, min_words, max_words)
            for i in range(n_utts)]
    pcms = [np.clip(audio * 32767, -32768, 32767).astype(np.int16) for _, audio in utts]
    with open(manifest, "w") as mf:
        for i, ((text, _), pcm, blob) in enumerate(zip(utts, pcms, map_fn(encode_flac, pcms))):
            spk, chap = groups[i % len(groups)]
            chap_dir = os.path.join(root, "LibriSpeech", split, str(spk), str(chap))
            os.makedirs(chap_dir, exist_ok=True)
            utt_id = f"{spk}-{chap}-{i // len(groups):04d}"
            path = os.path.join(chap_dir, f"{utt_id}.flac")
            with open(path, "wb") as f:
                f.write(blob)
            lines[(spk, chap)].append(f"{utt_id} {text.upper()}")
            mf.write(json.dumps({"audio_path": path, "text": text,
                                 "duration": len(pcm) / SAMPLE_RATE}) + "\n")
    for (spk, chap), rows in lines.items():
        if rows:
            trans = os.path.join(root, "LibriSpeech", split, str(spk), str(chap),
                                 f"{spk}-{chap}.trans.txt")
            with open(trans, "w") as f:
                f.write("\n".join(rows) + "\n")
    return manifest
