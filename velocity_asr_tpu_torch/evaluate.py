"""Evaluation (scripts/evaluate.py): WER/CER over a labelled test set, or
transcripts of a directory.

    python -m velocity_asr_tpu_torch.evaluate --checkpoint DIR \
        (--test-set MANIFEST | --test-set SPLIT [--librispeech-root ./data] | --audio-dir DIR) \
        [--int8 | --int8-static] [--batch-size 16] [--frame-bucket 200] \
        [--beam-width K [--lm LM.json.gz] [--lm-weight 0.5]
         [--hotwords FILE|w1,w2 | --hotwords-oracle] [--hotword-weight 2.0]] \
        [--max-utts N] [--calib-batches 8] [--output results.json] [--device cuda] \
        [--streaming [--chunk-seconds 2.0] [--lookahead N] [--stream-tokens K]
         [--stream-memory M]] [--identify-language]

``--test-set`` is a JSONL manifest, or else a LibriSpeech split under
``--librispeech-root`` (``data.LibriSpeechDataset``, its FLAC read
through ``io.decode_audio_file``). ``--audio-dir`` transcribes every
audio file under a directory (every format ``io.supported_audio_exts``
names) through ``transcribe.Transcriber`` at batch 1, with the beam and
fusion as configured, and writes the results' list with ``--output``
(a file that fails is listed with its error, as the transcribe CLI
lists it).
Utterances of a test set are read, their log-mels computed on the
host and padded batch by batch to a multiple of ``--frame-bucket`` frames
(``data.ASRCollator``); the model runs on the device, blank is forced on
each utterance's padded frames and the batch is decoded on the device:
greedily, or with ``--beam-width`` K > 1 by the prefix beam (``beam.py``),
its n-best rescored on the host by the LM (``--lm``) and hot words
(``--hotwords``, or ``--hotwords-oracle``: each batch boosted with the
words of its own reference transcripts, the contextual-biasing
benchmark). ``--int8`` runs the ten global-context projections and the CTC
head as int8 Dense layers with per-row dynamic scales; ``--int8-static``
first calibrates one activation scale per layer on the first
min(n, calib_batches * batch_size) utterances. ``--streaming`` decodes
each utterance through the chunked streaming path instead, batched
across utterances (``streaming.BatchedStreamingTranscriber``; a beam
carried across chunks, the LM and hot words rescoring each utterance's
n-best at its end), and measures the streaming-vs-offline accuracy gap.
``--identify-language`` (a model with a language-ID head, a test set
whose rows carry ``language``) also runs the head on every batch, outside
the timed region, and reports its accuracy and per-language recall and
WER (``lid``), each result with ``language_pred`` and ``language``.
The output JSON has the keys of the JAX package's ``eval_*.json`` files.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import List

import numpy as np
import torch

from .audio import SAMPLE_RATE, load_audio
from .beam import ctc_beam_search_torch
from .data import ASRCollator, ASRDataset, LibriSpeechDataset, calibration_batches
from .decode import CTCDecoder, ctc_greedy_decode_torch, force_blank_beyond
from .hotwords import HotwordBooster, load_hotwords_arg
from .lm import CharNGramLM
from .models.model import VelocityASR, from_pretrained
from .quantize import calibrate_int8_model
from .streaming import BatchedStreamingTranscriber
from .training import compute_cer, compute_wer
from .transcribe import (Transcriber, checkpoint_decoder, chunk_frames_of, collect_files,
                         combine_scorers, lid_probabilities, transcribe_files)

logger = logging.getLogger("velocity_asr_tpu_torch.evaluate")

HOP_SECONDS = 0.01  # one mel frame


def load_test_set(test_set: str, max_utts: int = 0, librispeech_root: str = "./data"):
    """(dataset, utterance count) of a manifest file, or else of the
    LibriSpeech split of that name under librispeech_root, nothing
    filtered or cut; max_utts <= 0 means all."""
    if os.path.isfile(test_set):
        ds = ASRDataset(test_set, max_duration=None, min_duration=0.0)
    else:
        ds = LibriSpeechDataset(root=librispeech_root, split=test_set, max_duration=None)
    n = len(ds) if max_utts <= 0 else min(len(ds), max_utts)
    return ds, n


def utterance(ds, i: int):
    """(audio path, reference text) of a test set's utterance i."""
    if isinstance(ds, LibriSpeechDataset):
        path, text = ds.entries[i]
        return path, text.lower()
    item = ds.samples[i]
    return item["audio_path"], item.get("text", "")


@torch.inference_mode()
def masked_logits(model: VelocityASR, mel: torch.Tensor,
                  input_lengths: torch.Tensor) -> torch.Tensor:
    """Logits with blank forced on every utterance's padded output frames."""
    return force_blank_beyond(model(mel), (input_lengths + 1) // 2)


def calibrate(model: VelocityASR, ds, n: int, collator: ASRCollator, batch_size: int,
              calib_batches: int) -> int:
    """Calibrate a static-int8 model on the first min(n, calib_batches *
    batch_size) utterances; returns that count."""
    n_calib = min(n, calib_batches * batch_size)
    calibrate_int8_model(model, calibration_batches(ds, collator, batch_size, calib_batches,
                                                    max_items=n))
    return n_calib


def fusion_scorer_for(decoder: CTCDecoder, lm=None, lm_weight: float = 0.5, booster=None,
                      hotword_weight: float = 2.0, oracle: bool = False):
    """The `scorer_for` of evaluate(): None without a scorer, else a
    function of a batch's reference texts giving the (scorer, weight)
    that rescores its n-best: the hot-word booster (fixed, or with oracle
    the contextual-biasing benchmark's: the union of the batch's reference
    words, each utterance's own words its domain vocabulary and the
    others' distractors) and the LM, combined."""
    if not (oracle or booster is not None or lm is not None):
        return None

    def scorer_for(texts):
        parts = []
        bst = booster
        if oracle:
            words = sorted({w for t in texts for w in t.lower().split()})
            bst = HotwordBooster(words, decoder.token_to_idx)
        if bst is not None:
            parts.append((bst, hotword_weight))
        if lm is not None:
            parts.append((lm, lm_weight))
        return combine_scorers(parts)

    return scorer_for


def beam_texts(decoder: CTCDecoder, logits: torch.Tensor, beam_width: int,
               scorer=None, weight: float = 0.0) -> List[str]:
    """Beam-decode a batch's masked logits on their device: each item's
    best beam, or with a scorer the live beam of the highest acoustic +
    weight * scorer.total_score (the first on ties), picked on the host."""
    toks, lens, scores = ctc_beam_search_torch(logits, beam_width=beam_width,
                                               blank_token=decoder.blank_token)
    if scorer is None:
        toks, lens = toks[:, 0].cpu(), lens[:, 0].cpu()
        return [decoder.tokens_to_text(toks[b, : lens[b]].tolist())
                for b in range(toks.shape[0])]
    toks, lens, scores = toks.cpu().numpy(), lens.cpu().numpy(), scores.cpu().numpy()
    texts = []
    for b in range(toks.shape[0]):
        best_text, best_s = "", -np.inf
        for k in range(toks.shape[1]):
            if scores[b, k] <= -1e29:  # a slot no hypothesis filled
                continue
            tl = toks[b, k, : lens[b, k]].tolist()
            s = float(scores[b, k]) + weight * scorer.total_score(tl)
            if s > best_s:
                best_s, best_text = s, decoder.tokens_to_text(tl)
        texts.append(best_text)
    return texts


def lid_summary(predictions: List[str], references: List[str], lid_predictions: List[int],
                lid_labels: List[int]) -> dict:
    """The JAX CLI's ``lid`` record: accuracy, and per language (by label)
    its utterances, recall and WER."""
    correct = sum(p == l for p, l in zip(lid_predictions, lid_labels))
    lid = {"accuracy": correct / max(len(lid_labels), 1), "per_language": {}}
    for lang in sorted(set(lid_labels)):
        sel = [i for i, l in enumerate(lid_labels) if l == lang]
        lid["per_language"][str(lang)] = {
            "utterances": len(sel),
            "lid_recall": sum(lid_predictions[i] == lang for i in sel) / max(len(sel), 1),
            "wer": compute_wer([predictions[i] for i in sel], [references[i] for i in sel]),
        }
    return lid


def evaluate(model: VelocityASR, decoder: CTCDecoder, ds, n: int, collator: ASRCollator,
             batch_size: int, beam_width: int = 0, scorer_for=None,
             identify_language: bool = False) -> dict:
    """Decode the first n utterances batch by batch: greedily, or with
    beam_width > 1 by the device beam. scorer_for, if given, maps a
    batch's reference texts to the (scorer, weight) that rescores its
    n-best (fixed LM and hot words ignore them; the oracle reads them).

    Returns wer, cer, rtf (model and decode seconds per second of audio,
    host mel excluded, as in the JAX package), utterances, results (one
    {"prediction", "reference"} per utterance) and seconds (the model and
    decode time behind rtf). identify_language adds ``lid``
    (``lid_summary``) and each result's ``language_pred`` and
    ``language``, from a forward of the head outside the timed region.
    """
    device = next(model.parameters()).device
    predictions: List[str] = []
    references: List[str] = []
    lid_predictions: List[int] = []
    lid_labels: List[int] = []
    total_audio_s = total_wall = 0.0
    for start in range(0, n, batch_size):
        batch = collator([ds[i] for i in range(start, min(start + batch_size, n))])
        t0 = time.perf_counter()
        mel = torch.from_numpy(batch["mel_spectrogram"]).to(device)
        in_lens = torch.from_numpy(batch["input_lengths"]).to(device)
        logits = masked_logits(model, mel, in_lens)
        if beam_width > 1:
            scorer, weight = scorer_for(batch["texts"]) if scorer_for else (None, 0.0)
            predictions.extend(beam_texts(decoder, logits, beam_width, scorer, weight))
        else:
            toks, lens = ctc_greedy_decode_torch(logits)
            toks, lens = toks.cpu(), lens.cpu()
            predictions.extend(decoder.tokens_to_text(toks[b, : lens[b]].tolist())
                               for b in range(toks.shape[0]))
        total_wall += time.perf_counter() - t0
        if identify_language:
            if "language" not in batch:
                raise SystemExit("--identify-language: the test set's rows "
                                 "carry no 'language' labels (regenerate "
                                 "with synth.write_corpus(languages=K) or "
                                 "add the field to the manifest)")
            probs = lid_probabilities(model, mel, (in_lens + 1) // 2)
            lid_predictions.extend(probs.argmax(dim=-1).tolist())
            lid_labels.extend(int(x) for x in batch["language"])
        references.extend(batch["texts"])
        total_audio_s += float(np.sum(batch["input_lengths"])) * HOP_SECONDS
        if (start // batch_size) % 20 == 0:
            logger.info("  %d/%d", min(start + batch_size, n), n)
    out = {
        "wer": compute_wer(predictions, references),
        "cer": compute_cer(predictions, references),
        "rtf": total_wall / max(total_audio_s, 1e-9),
        "utterances": n,
        "results": [{"prediction": p, "reference": r}
                    for p, r in zip(predictions, references)],
        "seconds": total_wall,
    }
    if identify_language:
        out["lid"] = lid_summary(predictions, references, lid_predictions, lid_labels)
        for rec, p, l in zip(out["results"], lid_predictions, lid_labels):
            rec["language_pred"] = p
            rec["language"] = l
    return out


def evaluate_streaming(model: VelocityASR, decoder: CTCDecoder, ds, n: int,
                       batch_size: int, chunk_frames: int = 200, lookahead: int = 0,
                       beam_width: int = 0, beam_scorers=None) -> dict:
    """Streaming decode of the first n utterances, batch by batch: greedy,
    or with beam_width > 1 the carried beam, each utterance's n-best
    rescored by beam_scorers [(scorer, weight)].

    The same keys as ``evaluate``; rtf and seconds count the host mel and
    the chunk steps (not the WAV read), as in the JAX package.
    """
    st = BatchedStreamingTranscriber(model, decoder, chunk_frames=chunk_frames,
                                     batch_size=batch_size, lookahead_chunks=lookahead,
                                     beam_width=beam_width, beam_scorers=beam_scorers)
    predictions: List[str] = []
    references: List[str] = []
    total_audio_s = total_wall = 0.0
    for start in range(0, n, batch_size):
        items = [utterance(ds, i) for i in range(start, min(start + batch_size, n))]
        audios = [load_audio(path) for path, _ in items]
        t0 = time.perf_counter()
        predictions.extend(st.transcribe_batch(audios))
        total_wall += time.perf_counter() - t0
        references.extend(text for _, text in items)
        total_audio_s += sum(len(a) for a in audios) / SAMPLE_RATE
        if (start // batch_size) % 10 == 0:
            logger.info("  %d/%d", start + len(audios), n)
    return {
        "wer": compute_wer(predictions, references),
        "cer": compute_cer(predictions, references),
        "rtf": total_wall / max(total_audio_s, 1e-9),
        "utterances": n,
        "results": [{"prediction": p, "reference": r}
                    for p, r in zip(predictions, references)],
        "seconds": total_wall,
    }


def main(argv: List[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description="Evaluate the PyTorch port on a test set")
    parser.add_argument("--checkpoint", required=True, help="pretrained checkpoint dir")
    parser.add_argument("--test-set", help="JSONL manifest, or a LibriSpeech split name")
    parser.add_argument("--librispeech-root", default="./data",
                        help="the directory holding LibriSpeech/ (for a split name)")
    parser.add_argument("--audio-dir", help="transcribe every audio file under a directory")
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--frame-bucket", type=int, default=200,
                        help="pad each batch's mel frames to a multiple of this")
    parser.add_argument("--max-utts", type=int, default=0, help="0 = all")
    parser.add_argument("--int8", action="store_true",
                        help="int8 projections, per-row dynamic activation scales")
    parser.add_argument("--int8-static", action="store_true",
                        help="int8 projections with calibrated static activation scales")
    parser.add_argument("--calib-batches", type=int, default=8)
    parser.add_argument("--beam-width", type=int, default=0, help=">1 enables beam search")
    parser.add_argument("--hotwords", default=None,
                        help="hot-word boosting for the beam search: a file (one word per "
                             "line) or an inline comma-separated list; requires "
                             "--beam-width > 1")
    parser.add_argument("--hotword-weight", type=float, default=2.0)
    parser.add_argument("--lm", default=None,
                        help="character n-gram LM for beam shallow fusion (a train_lm "
                             "artifact); requires --beam-width > 1")
    parser.add_argument("--lm-weight", type=float, default=0.5)
    parser.add_argument("--hotwords-oracle", action="store_true",
                        help="contextual-biasing benchmark: boost each batch with the "
                             "words of its own reference transcripts")
    parser.add_argument("--output", help="write per-utterance results (JSON)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--streaming", action="store_true",
                        help="decode each utterance with the chunked streaming pipeline "
                             "(carried model state), batched across utterances")
    parser.add_argument("--chunk-seconds", type=float, default=2.0)
    parser.add_argument("--lookahead", type=int, default=0,
                        help="streaming only: emit each chunk N chunks late, re-decoded "
                             "with the later chunks' global context and statistics")
    parser.add_argument("--stream-tokens", type=int, default=None,
                        help="override config.stream_summary_tokens")
    parser.add_argument("--stream-memory", type=int, default=None,
                        help="override config.stream_memory_chunks")
    parser.add_argument("--identify-language", action="store_true",
                        help="also measure language-ID accuracy and per-language WER "
                             "(models trained with num_languages > 0 on a manifest whose "
                             "rows carry 'language' labels, e.g. "
                             "synth.write_corpus(languages=K))")
    args = parser.parse_args(argv)
    if not args.audio_dir and not args.test_set:
        parser.error("provide --audio-dir or --test-set")
    if args.audio_dir and args.int8_static:
        parser.error("--int8-static requires --test-set (the calibration pass runs over "
                     "the test corpus)")
    if args.audio_dir and (args.streaming or args.hotwords_oracle):
        parser.error("--audio-dir transcribes offline with a fixed scorer: --streaming "
                     "and --hotwords-oracle need --test-set")
    if args.streaming and args.int8_static:
        parser.error("--int8-static is not supported with --streaming "
                     "(static quant_stats are not threaded through the "
                     "streaming step); use --int8 (dynamic scales)")
    if args.lookahead and not args.streaming:
        parser.error("--lookahead requires --streaming")
    if args.streaming and args.hotwords_oracle:
        parser.error("--hotwords-oracle is not supported with --streaming "
                     "(per-batch oracle bias lists need the offline beam); "
                     "use --hotwords with a fixed list")
    if (args.hotwords or args.hotwords_oracle) and args.beam_width <= 1:
        parser.error("hotword boosting biases the beam search; add "
                     "--beam-width (e.g. --beam-width 8)")
    if args.hotwords and args.hotwords_oracle:
        parser.error("--hotwords and --hotwords-oracle are mutually exclusive")
    if args.lm and args.beam_width <= 1:
        parser.error("--lm fuses into the beam search; add --beam-width "
                     "(e.g. --beam-width 8)")
    if args.identify_language and args.streaming:
        parser.error("--identify-language is not supported with --streaming "
                     "(the LID head pools over the full utterance)")
    if args.identify_language and args.audio_dir:
        parser.error("--identify-language accuracy needs --test-set with "
                     "'language' labels; for per-file predictions use "
                     "transcribe.py --identify-language")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(levelname)s | %(message)s")

    overrides = {}
    if args.int8 or args.int8_static:
        overrides["int8_inference"] = True
    if args.int8_static:
        overrides["int8_static"] = True
    if args.stream_tokens is not None:
        overrides["stream_summary_tokens"] = args.stream_tokens
    if args.stream_memory is not None:
        overrides["stream_memory_chunks"] = args.stream_memory
    model = from_pretrained(args.checkpoint, device=args.device, **overrides)
    if args.identify_language and model.config.num_languages <= 0:
        raise SystemExit("--identify-language requires a model with a "
                         "LID head (trained with num_languages > 0); "
                         "this checkpoint has none")
    decoder = checkpoint_decoder(args.checkpoint, model.config.vocab_size)
    scorer_for = fusion_scorer_for(
        decoder, lm=CharNGramLM.load(args.lm) if args.lm else None, lm_weight=args.lm_weight,
        booster=(load_hotwords_arg(args.hotwords, decoder.token_to_idx)
                 if args.hotwords else None),
        hotword_weight=args.hotword_weight, oracle=args.hotwords_oracle)

    if args.audio_dir:
        scorer, weight = scorer_for([]) if scorer_for else (None, 0.0)
        transcriber = Transcriber(model, decoder, beam_width=args.beam_width,
                                  lm_scorer=scorer, lm_weight=weight)
        results = transcribe_files(collect_files(args.audio_dir), transcriber.transcribe_file)
        for r in results:
            logger.info("%s -> %s", r["file"], r.get("text", r.get("error")))
        if args.output:
            with open(args.output, "w") as f:
                json.dump(results, f, indent=2)
        return {"results": results}
    ds, n = load_test_set(args.test_set, args.max_utts, args.librispeech_root)
    logger.info("Evaluating %d utterances from %s", n, args.test_set)
    if args.streaming:
        # no oracle here: a fixed scorer, whatever the texts
        scorer, weight = scorer_for([]) if scorer_for else (None, 0.0)
        result = evaluate_streaming(model, decoder, ds, n, args.batch_size,
                                    chunk_frames_of(args.chunk_seconds), args.lookahead,
                                    beam_width=args.beam_width,
                                    beam_scorers=[(scorer, weight)] if scorer else None)
        logger.info("STREAMING WER: %.2f%% | CER: %.2f%% | RTF: %.5f | utts/s: %.2f",
                    result["wer"] * 100, result["cer"] * 100, result["rtf"],
                    n / max(result["seconds"], 1e-9))
        if args.output:
            with open(args.output, "w") as f:
                json.dump({"wer": result["wer"], "cer": result["cer"], "rtf": result["rtf"],
                           "utterances": n, "streaming": True, "beam_width": args.beam_width,
                           "lm": bool(args.lm), "lookahead": args.lookahead,
                           "results": result["results"]}, f, indent=2)
        return {k: result[k] for k in ("wer", "cer", "rtf")}
    collator = ASRCollator(frame_bucket=args.frame_bucket, target_bucket=1)
    if args.int8_static:
        n_calib = calibrate(model, ds, n, collator, args.batch_size, args.calib_batches)
        logger.info("Calibrated static int8 scales on %d utterances", n_calib)

    result = evaluate(model, decoder, ds, n, collator, args.batch_size,
                      beam_width=args.beam_width, scorer_for=scorer_for,
                      identify_language=args.identify_language)
    logger.info("WER: %.2f%% | CER: %.2f%% | RTF: %.5f | utts/s: %.2f",
                result["wer"] * 100, result["cer"] * 100, result["rtf"],
                n / max(result["seconds"], 1e-9))
    lid = result.get("lid")
    if lid is not None:
        logger.info("LID accuracy: %.2f%% over %d languages (%s)",
                    lid["accuracy"] * 100, len(lid["per_language"]),
                    ", ".join(f"L{k}: {v['lid_recall'] * 100:.1f}%/WER {v['wer'] * 100:.2f}%"
                              for k, v in lid["per_language"].items()))
    if args.output:
        keys = ("wer", "cer", "rtf", "utterances", "results") + (("lid",) if lid else ())
        with open(args.output, "w") as f:
            json.dump({k: result[k] for k in keys}, f, indent=2)
    out = {k: result[k] for k in ("wer", "cer", "rtf")}
    if lid is not None:
        out["lid_accuracy"] = lid["accuracy"]
    return out


if __name__ == "__main__":
    main()
