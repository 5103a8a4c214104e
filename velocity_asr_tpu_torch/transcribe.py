"""Transcription (the greedy and beam paths of scripts/transcribe.py).

    python -m velocity_asr_tpu_torch.transcribe utt.flac [more.wav ...] [--input-dir DIR] \
        --checkpoint DIR [--timestamps] [--json] [--output FILE] \
        [--beam-width K [--lm LM.json.gz] [--lm-weight 0.5] [--hotwords FILE|w1,w2]
         [--hotword-weight 2.0]] \
        [--streaming [--chunk-seconds 2.0] [--lookahead N]] [--device cuda]

Per utterance: reflect-pad the audio to its frame bucket (multiples of
``frame_bucket`` frames), round it to int16 as the JAX pipeline's wire
format does, then on the device: log-mel (CUDA kernel), per-bin
normalisation over the valid frames only, the model, blank forced beyond
the valid output frames, and greedy CTC decode, or with ``--beam-width`` K > 1
the prefix beam on the device (``beam.py``), its n-best rescored by the
character n-gram LM (``--lm``, ``lm.py``) and the hot-word booster
(``--hotwords``, ``hotwords.py``). The global context pools over the
padded length, so the bucketing is part of the result.

``--streaming`` feeds the file chunk by chunk through a
``streaming.StreamingTranscriber`` instead (carried model state, host mel
with causal statistics; the beam carried across chunks, the LM and hot
words rescoring its n-best at the end); ``--lookahead N`` emits each
chunk N chunks late.

``--timestamps`` adds each file's words with their start and end
seconds and confidences (offline: greedy spans from the per-frame argmax,
or with the beam a CTC Viterbi alignment of its tokens; streaming: the
spans the session tracks). Files are decoded by ``io.decode_audio_file``
(WAV, FLAC, mp3, Ogg Vorbis, and m4a where the system codecs are);
``--input-dir`` takes every such file under a directory, and a file that
fails is reported and skipped. ``Transcriber.transcribe_batch`` is the server's batched
greedy path: one forward per frame bucket.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from .audio import HOP_LENGTH, SAMPLE_RATE, load_audio, masked_normalize_mel
from .decode import (CTCDecoder, _log_softmax_np, align_tokens_to_frames,
                     create_default_vocabulary, ctc_greedy_decode_torch, force_blank_beyond,
                     timestamps_from_predictions, token_logprobs_from_frames,
                     words_with_timestamps)
from .device import resolve_device
from .hotwords import load_hotwords_arg
from .io import supported_audio_exts
from .lm import CharNGramLM, CombinedScorer
from .models.model import VelocityASR, from_pretrained
from .ops.mel import compute_mel_spectrogram
from .streaming import StreamingTranscriber


def padded_frames(n_samples: int, frame_bucket: int = 200, hop: int = HOP_LENGTH) -> int:
    """The frames an utterance of n_samples pads to: the first multiple of
    frame_bucket that holds 1 + ceil(n_samples / hop) frames."""
    min_frames = 1 + -(-n_samples // hop)
    return -(-min_frames // frame_bucket) * frame_bucket


def combine_scorers(parts):
    """(scorer, weight) for the decoders' single scorer slot from
    [(scorer, weight)] parts: (None, 0.0) for none, the part itself for
    one, a CombinedScorer of weight 1 for more."""
    if not parts:
        return None, 0.0
    if len(parts) == 1:
        return parts[0]
    return CombinedScorer(parts), 1.0


class Transcriber:
    """Bucketed offline transcription on the model's device.

    beam_width > 1 decodes with the device beam, its n-best rescored by
    lm_scorer at lm_weight (an LM, a hot-word booster, or a
    CombinedScorer of both at weight 1).
    """

    def __init__(self, model: VelocityASR, decoder: CTCDecoder, frame_bucket: int = 200,
                 beam_width: int = 0, lm_scorer=None, lm_weight: float = 0.0):
        self.model = model.eval()
        self.decoder = decoder
        self.frame_bucket = frame_bucket
        self.beam_width = beam_width
        self.lm_scorer = lm_scorer
        self.lm_weight = lm_weight
        self.device = resolve_device(next(model.parameters()).device)
        self.hop = HOP_LENGTH
        self.sr = SAMPLE_RATE

    def frame_bucket_of(self, audio: np.ndarray) -> int:
        """The frame bucket this utterance pads to."""
        return padded_frames(len(audio), self.frame_bucket, self.hop)

    def _pad_audio(self, audio: np.ndarray):
        """Reflect-pad audio to its bucket; returns ((1, samples), valid frames)."""
        n_frames = 1 + len(audio) // self.hop
        target_samples = (self.frame_bucket_of(audio) - 1) * self.hop
        audio = np.asarray(audio, np.float32)
        if len(audio) >= 2:
            padded = np.pad(audio, (0, target_samples - len(audio)), mode="reflect")
        else:
            padded = np.zeros(target_samples, np.float32)
            padded[: len(audio)] = audio
        return padded[None], n_frames

    @staticmethod
    def _to_wire(audio_f32: np.ndarray) -> np.ndarray:
        """int16 PCM, the rounding the JAX pipeline applies on its host link."""
        return np.clip(audio_f32 * 32768.0, -32768, 32767).astype(np.int16)

    @torch.inference_mode()
    def masked_logits(self, audio_i16: torch.Tensor, n_valid_frames) -> torch.Tensor:
        """Logits of (batch, samples) int16 audio; each row's mel is
        normalised over its n_valid_frames (an int, or a (batch,) tensor)
        and blank is forced beyond its valid output frames."""
        audio = audio_i16.to(torch.float32) * (1.0 / 32768.0)
        mel = compute_mel_spectrogram(audio, normalize=False)
        mel = masked_normalize_mel(mel, n_valid_frames)
        logits = self.model(mel)
        return force_blank_beyond(logits, (n_valid_frames + 1) // 2)

    def transcribe_array(self, audio: np.ndarray, timestamps: bool = False,
                         beam_width: Optional[int] = None, lm_scorer=None,
                         lm_weight: Optional[float] = None) -> dict:
        """Transcribe one utterance: {"text", "duration"[, "words"]}.

        beam_width, lm_scorer and lm_weight override the transcriber's own
        for this call only (the server passes each request's values and
        never writes them into the shared transcriber). timestamps adds
        "words", each with its start, end and confidence: greedy from the
        device's per-frame argmax and its log posterior, with the beam
        from a CTC Viterbi alignment of the chosen tokens to the logits.
        """
        beam_width = self.beam_width if beam_width is None else beam_width
        lm_scorer = self.lm_scorer if lm_scorer is None else lm_scorer
        lm_weight = self.lm_weight if lm_weight is None else lm_weight
        padded, n_frames = self._pad_audio(audio)
        out_len = (n_frames + 1) // 2
        audio_dev = torch.from_numpy(self._to_wire(padded)).to(self.device)
        logits = self.masked_logits(audio_dev, n_frames)
        result = {"duration": len(audio) / self.sr}
        if timestamps and beam_width > 1:
            self._beam_timestamp_result(result, logits[:, :out_len], beam_width, lm_scorer,
                                        lm_weight)
        elif timestamps:
            lsm = torch.log_softmax(logits[0, :out_len].to(torch.float32), dim=-1)
            preds, frame_lp = lsm.argmax(dim=-1).cpu().numpy(), lsm.amax(dim=-1).cpu().numpy()
            tokens, stamps = timestamps_from_predictions(preds[None])[0]
            result["text"] = self.decoder.tokens_to_text(tokens)
            result["words"] = words_with_timestamps(
                tokens, stamps, self.decoder.vocabulary, self.hop, self.sr,
                token_logprobs=token_logprobs_from_frames(frame_lp, stamps))
        elif beam_width > 1:
            result["text"] = self.decoder.decode_beam_search(
                logits, beam_width=beam_width, backend="device", lm_scorer=lm_scorer,
                lm_weight=lm_weight)[0]
        else:
            toks, lens = ctc_greedy_decode_torch(logits)
            toks, lens = toks.cpu(), lens.cpu()
            result["text"] = self.decoder.tokens_to_text(toks[0, : lens[0]].tolist())
        return result

    def _beam_timestamp_result(self, result: dict, logits: torch.Tensor, beam_width: int,
                               lm_scorer, lm_weight: float) -> None:
        """Timestamps with the beam: the beam (with any rescoring) picks
        the tokens, then a CTC Viterbi alignment against the same logits
        gives each token its frame span and mean log posterior
        (decode.align_tokens_to_frames)."""
        beams = self.decoder.decode_beam_search(
            logits, beam_width=beam_width, backend="device", lm_scorer=lm_scorer,
            lm_weight=lm_weight, return_all_beams=True)[0]
        tokens = beams[0].tokens if beams else []
        result["text"] = self.decoder.tokens_to_text(tokens)
        lsm = _log_softmax_np(logits[0].to(torch.float32).cpu().numpy())
        stamps, token_lp = align_tokens_to_frames(lsm, tokens, self.decoder.blank_token)
        result["words"] = words_with_timestamps(tokens, stamps, self.decoder.vocabulary,
                                                self.hop, self.sr, token_logprobs=token_lp)

    @torch.inference_mode()
    def transcribe_batch(self, audios: List[np.ndarray]) -> List[dict]:
        """Greedy transcription of many utterances: {"text", "duration"}
        each, in input order.

        Utterances are grouped by frame bucket, one forward per bucket: the
        global context pools over the padded length, so padding a short
        clip to a longer one's bucket would change its transcript. Each
        row's valid frames go to the mel normalisation and to the forced
        blank, so a row transcribes as transcribe_array would. The JAX
        package also pads the batch to a power of two, only to bound its
        compiled shapes; an eager forward needs no such padding.
        """
        buckets: dict = {}
        for i, a in enumerate(audios):
            buckets.setdefault(self.frame_bucket_of(a), []).append(i)
        texts = [""] * len(audios)
        for idxs in buckets.values():
            padded, n_frames = zip(*(self._pad_audio(audios[i]) for i in idxs))
            wire = torch.from_numpy(self._to_wire(np.concatenate(padded))).to(self.device)
            n_valid = torch.tensor(n_frames, dtype=torch.int64, device=self.device)
            toks, lens = ctc_greedy_decode_torch(self.masked_logits(wire, n_valid))
            toks, lens = toks.cpu(), lens.cpu()
            for row, i in enumerate(idxs):
                texts[i] = self.decoder.tokens_to_text(toks[row, : lens[row]].tolist())
        return [{"text": t, "duration": len(a) / self.sr} for t, a in zip(texts, audios)]

    def transcribe_file(self, path: str, timestamps: bool = False) -> dict:
        t0 = time.perf_counter()
        result = self.transcribe_array(load_audio(path), timestamps=timestamps)
        result["file"] = path
        result["rtf"] = (time.perf_counter() - t0) / max(result["duration"], 1e-9)
        return result


def load_transcriber(checkpoint: str, device="cuda", frame_bucket: int = 200,
                     **overrides) -> Transcriber:
    """A Transcriber for a checkpoint directory (config, params, vocabulary)."""
    model = from_pretrained(checkpoint, device=device, **overrides)
    return Transcriber(model, checkpoint_decoder(checkpoint, model.config.vocab_size),
                       frame_bucket=frame_bucket)


def checkpoint_decoder(checkpoint: str, vocab_size: int) -> CTCDecoder:
    """A decoder over the checkpoint's vocabulary.json, or the default
    vocabulary of `vocab_size` tokens where it has none."""
    vocab_path = os.path.join(checkpoint, "vocabulary.json")
    if os.path.exists(vocab_path):
        with open(vocab_path) as f:
            return CTCDecoder(json.load(f))
    return CTCDecoder(create_default_vocabulary(vocab_size))


def chunk_frames_of(chunk_seconds: float) -> int:
    """Mel frames per streaming chunk: round(s * 100), made even."""
    frames = round(chunk_seconds * 100)
    return frames + frames % 2


def transcribe_streaming(st: StreamingTranscriber, path: str, timestamps: bool = False) -> dict:
    """Feed one file through a live session, one chunk of samples at a
    time; timestamps adds the session's "words"."""
    st.reset()
    t0 = time.perf_counter()
    audio = load_audio(path)
    block = st.chunk_frames * HOP_LENGTH
    text = "".join(st.feed(audio[i:i + block]) for i in range(0, len(audio), block))
    text += st.finish()
    duration = len(audio) / SAMPLE_RATE
    result = {"file": path, "text": text, "duration": duration,
              "rtf": (time.perf_counter() - t0) / max(duration, 1e-9), "streaming": True}
    if timestamps:
        result["words"] = st.words()
    return result


def collect_files(input_dir: str) -> List[str]:
    """Every file under input_dir with an extension this build decodes
    (``io.supported_audio_exts``), walked in sorted order."""
    exts = supported_audio_exts()
    out = []
    for root, dirs, files in os.walk(input_dir):
        dirs.sort()
        out += [os.path.join(root, f) for f in sorted(files) if f.lower().endswith(exts)]
    return out


def transcribe_files(files: List[str], transcribe_one: Callable[[str], dict],
                     on_result: Optional[Callable[[dict], None]] = None) -> List[dict]:
    """transcribe_one(path) for each file in order; a file that fails gives
    ``{"file": path, "error": message}`` (also on stderr) and the others go
    on. on_result sees each result as it comes."""
    results = []
    for path in files:
        try:
            result = transcribe_one(path)
        except Exception as e:  # one file's failure does not stop the others
            result = {"file": path, "error": str(e)}
            print(f"{path}: {e}", file=sys.stderr)
        results.append(result)
        if on_result is not None:
            on_result(result)
    return results


def main(argv: List[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Transcribe audio files with the PyTorch port")
    parser.add_argument("audio", nargs="*", help="audio file(s) to transcribe")
    parser.add_argument("--input-dir", help="transcribe every audio file under a directory")
    parser.add_argument("--checkpoint", required=True, help="pretrained checkpoint dir")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--output", help="write the results to this file (JSON with --json, "
                                         "else one 'file<TAB>text' line per file)")
    parser.add_argument("--json", action="store_true", help="JSON output")
    parser.add_argument("--timestamps", action="store_true",
                        help="word-level timestamps and confidences")
    parser.add_argument("--streaming", action="store_true",
                        help="chunked streaming decode with carried model state")
    parser.add_argument("--chunk-seconds", type=float, default=2.0,
                        help="streaming chunk size in seconds")
    parser.add_argument("--lookahead", type=int, default=0,
                        help="streaming: emit each chunk N chunks late, re-decoded with "
                             "the later chunks' global context and statistics")
    parser.add_argument("--beam-width", type=int, default=0, help=">1 enables beam search")
    parser.add_argument("--hotwords", default=None,
                        help="hot-word boosting for the beam search: a file (one word per "
                             "line) or an inline comma-separated list; requires "
                             "--beam-width > 1")
    parser.add_argument("--hotword-weight", type=float, default=2.0,
                        help="shallow-fusion weight for --hotwords")
    parser.add_argument("--lm", default=None,
                        help="character n-gram LM for beam shallow fusion (a train_lm "
                             "artifact); requires --beam-width > 1")
    parser.add_argument("--lm-weight", type=float, default=0.5)
    args = parser.parse_args(argv)
    if not args.audio and not args.input_dir:
        parser.error("provide audio file(s) or --input-dir")
    if args.lookahead and not args.streaming:
        parser.error("--lookahead requires --streaming")
    if args.hotwords and args.beam_width <= 1:
        parser.error("--hotwords biases the beam search; add --beam-width "
                     "(e.g. --beam-width 8)")
    if args.lm and args.beam_width <= 1:
        parser.error("--lm fuses into the beam search; add --beam-width "
                     "(e.g. --beam-width 8)")

    pipeline = load_transcriber(args.checkpoint, device=args.device)
    pipeline.beam_width = args.beam_width
    parts = []
    if args.hotwords:
        parts.append((load_hotwords_arg(args.hotwords, pipeline.decoder.token_to_idx),
                      args.hotword_weight))
    if args.lm:
        parts.append((CharNGramLM.load(args.lm), args.lm_weight))
    pipeline.lm_scorer, pipeline.lm_weight = combine_scorers(parts)
    streamer = None
    if args.streaming:  # one live session; each file resets it
        streamer = StreamingTranscriber(
            pipeline.model, pipeline.decoder, chunk_frames=chunk_frames_of(args.chunk_seconds),
            lookahead_chunks=args.lookahead, beam_width=args.beam_width,
            beam_scorers=[(pipeline.lm_scorer, pipeline.lm_weight)] if pipeline.lm_scorer
            else None)
    files = list(args.audio) + (collect_files(args.input_dir) if args.input_dir else [])

    def transcribe_one(path):
        if streamer is not None:
            return transcribe_streaming(streamer, path, timestamps=args.timestamps)
        return pipeline.transcribe_file(path, timestamps=args.timestamps)

    def show(result):
        if not args.output:
            print(json.dumps(result) if args.json
                  else f"{result['file']}\t{result.get('text', result.get('error', ''))}")

    results = transcribe_files(files, transcribe_one, show)
    if args.output:
        with open(args.output, "w") as f:
            if args.json:
                json.dump(results, f, indent=2)
            else:
                f.writelines(f"{r['file']}\t{r.get('text', r.get('error', ''))}\n"
                             for r in results)
    return 1 if any("error" in r for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
