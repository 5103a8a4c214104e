"""Synthetic speech corpus (a numpy copy of the parts of
velocity_asr_tpu/synth.py that ``write_corpus`` and training need).

Each character is a "phoneme" with its own spectrum; utterances add
speaker, rate, level and noise jitter. Everything is deterministic in
(seed, split, index), so ``write_corpus(dir, n, split="test", seed=1234)``
regenerates the JAX package's held-out set bit for bit, and its WER
results (checkpoints/synth_run/eval_fp32_final.json) apply to it;
``SyntheticSpeechDataset`` serves the train and dev splits as the JAX
package's does (host mel, or raw audio for the device mel). With
``languages`` K > 1 each utterance draws one of K synthetic languages
(``make_language_lexicon``: language 0 is the base lexicon, 1-3 have
phonologies of their own) from a seed stream of its own, and items and
manifest rows carry its ``language`` label; K = 1 is the monolingual
corpus byte for byte.
``write_librispeech_tree`` writes utterances of a split in LibriSpeech's
on-disk layout (FLAC, transcripts in upper case) with a manifest over
the same files.

The speaker and conversation parts serve diarization: ``SpeakerProfile``
is a persistent voice (formant scale, rate, level, spectral tilt) that
``SynthVoice.render(..., profile=...)`` renders with small per-utterance
jitter; ``SyntheticSpeakerDataset`` yields (scalar-normalised mel,
speaker id in ``targets[0]``) items for the speaker encoder, and
``SyntheticConversationDataset`` / ``write_conversations`` multi-speaker
conversations with their ground-truth turns, from voices (ids 1,000,000
+ 16 idx + k) that no speaker dataset trains on. All of it is the JAX
package's, bit for bit.
"""

from __future__ import annotations

import hashlib
import json
import os
import wave
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .audio import SAMPLE_RATE, compute_mel_spectrogram_np
from .data import speech_item

VOWELS = "aeiouy"
CHARS = "abcdefghijklmnopqrstuvwxyz"


def _char_seed(master_seed: int, *parts) -> np.random.Generator:
    h = hashlib.sha256(("|".join(map(str, parts)) + f"|{master_seed}").encode())
    return np.random.default_rng(int.from_bytes(h.digest()[:8], "little"))


@dataclass
class SpeakerProfile:
    """A persistent synthetic voice: the per-utterance draws of
    ``SynthVoice.render`` (formant scale, rate, level) become constants of
    the speaker, jittered a little per utterance, plus a spectral tilt
    (the weight of the higher formants)."""

    fscale: float  # global formant scale ("vocal tract length")
    rate: float  # speaking rate
    level: float  # loudness
    tilt: float  # relative weight of the higher formants

    @classmethod
    def sample(cls, rng: np.random.Generator) -> "SpeakerProfile":
        return cls(
            fscale=float(rng.uniform(0.85, 1.2)),
            rate=float(rng.uniform(0.8, 1.25)),
            level=float(rng.uniform(0.18, 0.4)),
            tilt=float(rng.uniform(0.7, 1.3)),
        )

    @classmethod
    def for_id(cls, speaker_id: int, seed: int = 1234) -> "SpeakerProfile":
        """The profile of a speaker index, the same in every corpus of `seed`."""
        return cls.sample(_char_seed(seed, "speaker", speaker_id))


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

    def _phoneme(self, c: str, dur_s: float, fscale: float, rng,
                 tilt: float = 1.0) -> np.ndarray:
        n = max(int(dur_s * self.sr), 8)
        t = np.arange(n) / self.sr
        if c == " ":
            return np.zeros(n, np.float32)
        amps = np.array([1.0, 0.55 * tilt, 0.3 * tilt]) * rng.uniform(0.85, 1.15, 3)
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

    def render(self, text: str, rng: Optional[np.random.Generator] = None,
               profile: Optional[SpeakerProfile] = None,
               add_noise: bool = True) -> np.ndarray:
        """Render text to a 16 kHz waveform with speaker/rate/noise jitter.

        Without a profile the "speaker" is drawn per utterance (the corpus
        default); with one, its constants jittered by a few percent.
        ``add_noise=False`` skips both noise draws, the last that consume
        `rng`, so the rest of the waveform is the same either way. The
        phoneme table covers lowercase a-z and space; other characters
        render as silence."""
        rng = rng or np.random.default_rng(0)
        text = "".join(
            c if c in self.formants or c == " " else " "
            for c in text.lower()
        )
        if profile is None:
            fscale = rng.uniform(0.85, 1.2)  # "speaker" formant scale
            rate = rng.uniform(0.8, 1.25)  # speaking rate
            level = rng.uniform(0.18, 0.4)
            tilt = 1.0
        else:
            fscale = profile.fscale * rng.uniform(0.98, 1.02)
            rate = profile.rate * rng.uniform(0.95, 1.05)
            level = profile.level * rng.uniform(0.9, 1.1)
            tilt = profile.tilt
        xfade = int(0.010 * self.sr)

        pieces: List[np.ndarray] = [np.zeros(int(rng.uniform(0.04, 0.15) * self.sr), np.float32)]
        for c in text:
            if c == " ":
                dur = rng.uniform(0.05, 0.12)
            else:
                dur = rng.uniform(0.07, 0.13) * rate
            pieces.append(self._phoneme(c, dur, fscale, rng, tilt=tilt))
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
        if add_noise:
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


# ----- synthetic languages (the multilingual / language-ID corpus) ----------

#: Per-language phonologies over the shared grapheme set: which phonemes
#: occur and in which syllable patterns. Language 0 is make_lexicon's.
_LANGUAGE_PHONOLOGIES: List[Optional[Dict]] = [
    None,  # language 0: make_lexicon's mixed-CV pseudo-words
    {  # open syllables: small consonant set, strict CV, a/i/u
        "consonants": "ptkmnsrlhw",
        "vowels": "aiu",
        "patterns": ["CV", "CVCV", "CVCVCV", "CVVCV", "CVCVCVCV"],
    },
    {  # clusters: voiced/fricative consonants, closed syllables
        "consonants": "bdgvzjfqxc",
        "vowels": "eoy",
        "patterns": ["CVC", "CCVC", "CVCC", "CVCCVC", "CCVCVC"],
    },
    {  # vowel-initial: sonorants, vowel-heavy sequences
        "consonants": "mnrlszt",
        "vowels": "aeiouy",
        "patterns": ["VCV", "VCCV", "VCVC", "VVCV", "VCVCVV"],
    },
]

#: Languages available (a model's num_languages may be at most this).
NUM_SYNTH_LANGUAGES = len(_LANGUAGE_PHONOLOGIES)


def make_language_lexicon(language: int, n_words: int = 1500, seed: int = 1234) -> List[str]:
    """Deterministic pseudo-word lexicon of one synthetic language:
    language 0 is make_lexicon(n_words, seed), languages 1-3 draw words
    from their phonology's syllable patterns."""
    if not 0 <= language < NUM_SYNTH_LANGUAGES:
        raise ValueError(f"language {language} out of range 0..{NUM_SYNTH_LANGUAGES - 1}")
    phon = _LANGUAGE_PHONOLOGIES[language]
    if phon is None:
        return make_lexicon(n_words, seed=seed)
    rng = _char_seed(seed, "lexicon_lang", language)
    cons, vows, patterns = phon["consonants"], phon["vowels"], phon["patterns"]
    words, seen = [], set()
    while len(words) < n_words:
        pat = patterns[int(rng.integers(0, len(patterns)))]
        w = "".join(
            (cons if ch == "C" else vows)[int(rng.integers(0, len(cons if ch == "C" else vows)))]
            for ch in pat
        )
        if w not in seen:
            seen.add(w)
            words.append(w)
    return words


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
    ``SyntheticSpeechDataset``: host mel, or with `device_mel` the raw
    audio and its frame count (the mel is computed on the device by the
    trainer). With `languages` K > 1 each item's sentence comes from the
    lexicon of its language (``language_for``) and the item carries
    ``language``. The vocabulary is the manifest datasets' rule over a-z
    and space: <blank>, <unk>, <pad>, then the sorted characters, 30
    tokens."""

    def __init__(self, n_utts: int = 10000, split: str = "train", seed: int = 1234,
                 lexicon_words: int = 1500, min_words: int = 2, max_words: int = 8,
                 device_mel: bool = False, languages: int = 1):
        if not 1 <= languages <= NUM_SYNTH_LANGUAGES:
            raise ValueError(f"languages must be 1..{NUM_SYNTH_LANGUAGES}, got {languages}")
        self.n_utts = n_utts
        self.split = split
        self.seed = seed
        self.min_words = min_words
        self.max_words = max_words
        self.device_mel = device_mel
        self.languages = languages
        self.voice = SynthVoice(seed=seed)
        self.lexicons = [make_language_lexicon(lang, lexicon_words, seed=seed)
                         for lang in range(languages)]
        self.lexicon = self.lexicons[0]
        specials = ["<blank>", "<unk>", "<pad>"]
        self.vocab = {tok: i for i, tok in enumerate(specials + sorted(set(CHARS + " ")))}

    def __len__(self) -> int:
        return self.n_utts

    def text_to_tokens(self, text: str) -> List[int]:
        unk = self.vocab["<unk>"]
        return [self.vocab.get(c, unk) for c in text]

    def language_for(self, idx: int) -> int:
        """Utterance idx's language, uniform over the languages, from a
        seed stream apart from the text's (so one language is the
        monolingual corpus)."""
        if self.languages == 1:
            return 0
        return int(_char_seed(self.seed, "lang", self.split, idx).integers(0, self.languages))

    def text_for(self, idx: int) -> str:
        """Utterance idx's transcript, without rendering its audio."""
        return sample_sentence(self.lexicons[self.language_for(idx)],
                               _char_seed(self.seed, "text", self.split, idx),
                               self.min_words, self.max_words)

    def audio_for(self, idx: int, text: str) -> np.ndarray:
        """Utterance idx's 16 kHz waveform of `text`."""
        return self.voice.render(text, _char_seed(self.seed, "audio", self.split, idx))

    def __getitem__(self, idx: int) -> Dict:
        text = self.text_for(idx)
        item = speech_item(self.audio_for(idx, text), text, self.text_to_tokens(text),
                           self.device_mel)
        if self.languages > 1:
            item["language"] = np.int32(self.language_for(idx))
        return item


def write_corpus(out_dir: str, n_utts: int, split: str = "test", seed: int = 1234,
                 lexicon_words: int = 1500, min_words: int = 2,
                 max_words: int = 8, languages: int = 1) -> str:
    """Write utterances 0..n_utts-1 of a split as 16-bit WAVs plus a JSONL
    manifest (audio_path, text, duration, and with languages > 1 each
    row's ``language``); returns the manifest path."""
    ds = SyntheticSpeechDataset(n_utts, split=split, seed=seed, lexicon_words=lexicon_words,
                                min_words=min_words, max_words=max_words, languages=languages)
    os.makedirs(out_dir, exist_ok=True)
    manifest = os.path.join(out_dir, f"{split}_manifest.jsonl")
    with open(manifest, "w") as mf:
        for i in range(n_utts):
            text = ds.text_for(i)
            audio = ds.audio_for(i, text)
            path = os.path.join(out_dir, f"{split}_{i:05d}.wav")
            pcm = np.clip(audio * 32767, -32768, 32767).astype("<i2")
            with wave.open(path, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(SAMPLE_RATE)
                w.writeframes(pcm.tobytes())
            row = {"audio_path": path, "text": text, "duration": len(audio) / SAMPLE_RATE}
            if languages > 1:
                row["language"] = ds.language_for(i)
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


# ----- speaker-attributed conversations (the diarization corpus) -------------


def render_conversation(voice: SynthVoice, turns: Sequence[Tuple[int, str]],
                        profiles: Sequence[SpeakerProfile], rng: np.random.Generator,
                        gap_range: Tuple[float, float] = (0.3, 1.2),
                        snr_db_range: Tuple[float, float] = (16.0, 30.0)):
    """(waveform, segments) of a multi-speaker conversation: turns
    (speaker index into `profiles`, text) rendered without noise,
    separated by silent gaps, under one background-noise bed at an SNR
    drawn over the speech. segments = [{"start", "end", "speaker",
    "text"}] in seconds, the bounds those of each rendered turn (its own
    lead and tail silence included)."""
    sr = voice.sr
    pieces: List[np.ndarray] = [np.zeros(int(rng.uniform(*gap_range) * sr), np.float32)]
    pos = len(pieces[0])
    segments: List[Dict] = []
    for speaker, text in turns:
        clip = voice.render(text, rng, profile=profiles[speaker], add_noise=False)
        segments.append({"start": pos / sr, "end": (pos + len(clip)) / sr,
                         "speaker": int(speaker), "text": text})
        pieces.append(clip)
        pos += len(clip)
        gap = np.zeros(int(rng.uniform(*gap_range) * sr), np.float32)
        pieces.append(gap)
        pos += len(gap)
    audio = np.concatenate(pieces)
    speech = np.concatenate([pieces[i] for i in range(1, len(pieces), 2)])
    speech_rms = float(np.sqrt(np.mean(speech ** 2)) + 1e-9)
    snr_db = rng.uniform(*snr_db_range)
    noise_rms = speech_rms / (10 ** (snr_db / 20))
    audio = audio + rng.standard_normal(len(audio)).astype(np.float32) * noise_rms
    return audio.astype(np.float32), segments


class SyntheticSpeakerDataset:
    """Utterances of persistent synthetic speakers for the speaker
    encoder, in the ASR batch layout: the scalar-normalised host mel
    (``diarize.scalar_normalize_mel``) and the speaker index as a
    one-token ``targets``. Item idx is speaker idx % n_speakers; the eval
    split renders other sentences of the same voices."""

    def __init__(self, n_speakers: int = 64, utts_per_speaker: int = 100, split: str = "train",
                 seed: int = 1234, lexicon_words: int = 1500, min_words: int = 2,
                 max_words: int = 6):
        self.n_speakers = n_speakers
        self.utts_per_speaker = utts_per_speaker
        self.split = split
        self.seed = seed
        self.min_words = min_words
        self.max_words = max_words
        self.voice = SynthVoice(seed=seed)
        self.lexicon = make_lexicon(lexicon_words, seed=seed)
        self.profiles = [SpeakerProfile.for_id(i, seed=seed) for i in range(n_speakers)]

    def __len__(self) -> int:
        return self.n_speakers * self.utts_per_speaker

    def __getitem__(self, idx: int) -> Dict:
        from .diarize import scalar_normalize_mel

        speaker = idx % self.n_speakers
        rng = _char_seed(self.seed, "spk_utt", self.split, idx)
        text = sample_sentence(self.lexicon, rng, self.min_words, self.max_words)
        audio = self.voice.render(text, rng, profile=self.profiles[speaker])
        mel = scalar_normalize_mel(compute_mel_spectrogram_np(audio, normalize=False))
        return {
            "mel_spectrogram": mel,
            "input_lengths": np.int32(mel.shape[0]),
            "targets": np.asarray([speaker], np.int32),
            "target_lengths": np.int32(1),
            "text": text,
        }


class SyntheticConversationDataset:
    """Conversations of 2-4 (``speakers_range``) unseen voices, 6-14
    turns of 4-10 words, consecutive turns by different speakers; item
    idx is {"audio", "segments", "n_speakers"}, deterministic in (seed,
    split, idx)."""

    def __init__(self, n_convs: int = 20, speakers_range: Tuple[int, int] = (2, 4),
                 turns_range: Tuple[int, int] = (6, 14), words_range: Tuple[int, int] = (4, 10),
                 split: str = "test", seed: int = 1234, lexicon_words: int = 1500):
        self.n_convs = n_convs
        self.speakers_range = speakers_range
        self.turns_range = turns_range
        self.words_range = words_range
        self.split = split
        self.seed = seed
        self.voice = SynthVoice(seed=seed)
        self.lexicon = make_lexicon(lexicon_words, seed=seed)

    def __len__(self) -> int:
        return self.n_convs

    def __getitem__(self, idx: int) -> Dict:
        rng = _char_seed(self.seed, "conv", self.split, idx)
        n_spk = int(rng.integers(self.speakers_range[0], self.speakers_range[1] + 1))
        profiles = [SpeakerProfile.for_id(1_000_000 + idx * 16 + k, seed=self.seed)
                    for k in range(n_spk)]
        n_turns = int(rng.integers(self.turns_range[0], self.turns_range[1] + 1))
        turns: List[Tuple[int, str]] = []
        prev = -1
        for _ in range(n_turns):
            choices = [k for k in range(n_spk) if k != prev] or [0]
            spk = choices[int(rng.integers(0, len(choices)))]
            turns.append((spk, sample_sentence(self.lexicon, rng, self.words_range[0],
                                               self.words_range[1])))
            prev = spk
        audio, segments = render_conversation(self.voice, turns, profiles, rng)
        return {"audio": audio, "segments": segments, "n_speakers": n_spk}


def write_conversations(out_dir: str, n_convs: int = 20, split: str = "test",
                        seed: int = 1234, **kwargs) -> str:
    """Write conversations 0..n_convs-1 as 16-bit WAVs plus a JSONL
    manifest (audio_path, duration, n_speakers, the ground-truth
    segments); returns the manifest path."""
    ds = SyntheticConversationDataset(n_convs, split=split, seed=seed, **kwargs)
    os.makedirs(out_dir, exist_ok=True)
    manifest = os.path.join(out_dir, f"{split}_conversations.jsonl")
    with open(manifest, "w") as mf:
        for i in range(n_convs):
            item = ds[i]
            path = os.path.join(out_dir, f"{split}_conv_{i:04d}.wav")
            pcm = np.clip(item["audio"] * 32767, -32768, 32767).astype("<i2")
            with wave.open(path, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(SAMPLE_RATE)
                w.writeframes(pcm.tobytes())
            mf.write(json.dumps({"audio_path": path,
                                 "duration": len(item["audio"]) / SAMPLE_RATE,
                                 "n_speakers": item["n_speakers"],
                                 "segments": item["segments"]}) + "\n")
    return manifest
