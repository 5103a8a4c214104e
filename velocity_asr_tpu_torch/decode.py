"""CTC decoding (mirrors velocity_asr_tpu/decode.py).

Greedy: the argmax, blank removal and repeat collapse run on the logits'
device; only the packed token ids go to the host. Beam search has two
backends: "device", the batched prefix beam of ``beam.py`` on the
logits' device, with an LM or hot words applied as n-best rescoring; and
"host", a numpy prefix beam that scores an LM inside the search. Both
keep the reference's max-merge semantics and agree at lm_weight 0.
``align_tokens_to_frames`` is the CTC Viterbi alignment of a chosen
token sequence. Word timestamps: ``timestamps_from_predictions`` gives
each greedy token its frame span, ``words_with_timestamps`` assembles
words with their times (frame -> seconds: frame * 2 * hop / sr) and,
given each token's mean log posterior, their confidences.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

BLANK_TOKEN = 0


@dataclass
class DecodingResult:
    """One decoded hypothesis."""

    text: str
    tokens: List[int]
    score: float
    timestamps: Optional[List[Tuple[int, int]]] = None


def ctc_greedy_decode_torch(logits: torch.Tensor, blank_token: int = BLANK_TOKEN,
                            collapse_repeated: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Argmax per frame, drop blanks, collapse repeats (a blank between two
    equal tokens keeps both).

    Returns tokens (batch, T) int32, left-packed and padded with -1, and
    lengths (batch,) int32.
    """
    preds = torch.argmax(logits, dim=-1).to(torch.int32)  # (B, T)
    prev = torch.nn.functional.pad(preds[:, :-1], (1, 0), value=blank_token)
    keep = preds != blank_token
    if collapse_repeated:
        keep = keep & (preds != prev)
    positions = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    lengths = keep.sum(dim=1).to(torch.int32)
    batch, seq_len = preds.shape
    # One spare column takes the dropped frames' writes.
    out = torch.full((batch, seq_len + 1), -1, dtype=torch.int32, device=preds.device)
    scatter_pos = torch.where(keep, positions, torch.full_like(positions, seq_len))
    out.scatter_(1, scatter_pos.to(torch.int64), preds)
    out[:, seq_len] = -1
    return out[:, :seq_len], lengths


def force_blank_beyond(logits: torch.Tensor, out_lens) -> torch.Tensor:
    """Logits (batch, T, vocab) with every frame at or past the valid
    output length (an int, or a (batch,) tensor) set to a certain blank
    (0 for blank, -1e9 for the rest), so a padded batch decodes in one
    call: a blank emits nothing."""
    if isinstance(out_lens, torch.Tensor):
        out_lens = out_lens.to(logits.device).reshape(-1, 1)
    t = torch.arange(logits.shape[1], device=logits.device)
    pad = (t[None, :] >= out_lens)[:, :, None]
    logits = torch.where(pad, torch.full_like(logits, -1e9), logits)
    logits[:, :, BLANK_TOKEN] = torch.where(pad[..., 0], torch.zeros_like(logits[:, :, 0]),
                                            logits[:, :, BLANK_TOKEN])
    return logits


def ctc_greedy_decode(logits: torch.Tensor, blank_token: int = BLANK_TOKEN,
                      collapse_repeated: bool = True) -> List[List[int]]:
    """Greedy CTC decode returning Python token lists."""
    tokens, lengths = ctc_greedy_decode_torch(logits, blank_token, collapse_repeated)
    tokens, lengths = tokens.cpu(), lengths.cpu()
    return [tokens[b, : lengths[b]].tolist() for b in range(tokens.shape[0])]


def ctc_greedy_decode_with_timestamps(logits, blank_token: int = BLANK_TOKEN
                                      ) -> List[Tuple[List[int], List[Tuple[int, int]]]]:
    """Greedy decode with a (start_frame, end_frame) span per emitted
    token: a token's span runs from its first frame to the frame where a
    blank or another token appears (or seq_len for the last run)."""
    preds = torch.argmax(torch.as_tensor(logits), dim=-1).cpu().numpy()
    return timestamps_from_predictions(preds, blank_token)


def timestamps_from_predictions(preds: np.ndarray, blank_token: int = BLANK_TOKEN
                                ) -> List[Tuple[List[int], List[Tuple[int, int]]]]:
    """(tokens, spans) per row of per-frame argmax predictions (batch, T)."""
    batch, seq_len = preds.shape
    results = []
    for b in range(batch):
        pred = preds[b]
        # emission frames: non-blank and unlike the previous frame
        prev = np.concatenate([[blank_token], pred[:-1]])
        keep = (pred != blank_token) & (pred != prev)
        starts = np.nonzero(keep)[0]
        tokens = pred[starts].tolist()
        # a span ends at the first later frame whose prediction changes
        change = np.concatenate([np.nonzero(pred[1:] != pred[:-1])[0] + 1, [seq_len]])
        ends = [int(change[np.searchsorted(change, s, side="right")]) for s in starts]
        results.append((tokens, [(int(s), int(e)) for s, e in zip(starts, ends)]))
    return results


def frame_to_seconds(frame: int, hop_length: int, sample_rate: int) -> float:
    """Output frame -> seconds: an output frame covers 2 hops after the
    stride-2 temporal binding."""
    return frame * 2 * hop_length / sample_rate


def words_with_timestamps(tokens, stamps, vocabulary, hop_length, sample_rate,
                          token_logprobs=None) -> List[dict]:
    """Words {"word", "start", "end"[, "confidence"]} from character
    tokens and their frame spans.

    token_logprobs (optional, aligned with tokens): each token's mean
    per-frame log posterior over its span; each word then gets the exp of
    the span-length-weighted mean over its content tokens (word-boundary
    spaces excluded, like the characters themselves).
    """
    words, current, start_t = [], [], None
    lp_sum = lp_n = 0.0

    def close(end_t):
        w = {"word": "".join(current), "start": start_t, "end": end_t}
        if token_logprobs is not None:
            w["confidence"] = math.exp(lp_sum / max(lp_n, 1.0))
        words.append(w)

    for i, (tok, (s, e)) in enumerate(zip(tokens, stamps)):
        ch = vocabulary[tok] if 0 <= tok < len(vocabulary) else "<unk>"
        # "▁" marks a subword's word start: a token beginning with it
        # closes the current word, as tokens_to_text maps it to a space
        if ch == " " or ch.startswith("▁"):
            if current:
                close(frame_to_seconds(e, hop_length, sample_rate))
                current, start_t = [], None
                lp_sum = lp_n = 0.0
            if ch == " ":
                continue
            ch = ch.replace("▁", "")
            if not ch:
                continue
        elif "▁" in ch:
            ch = ch.replace("▁", "")  # mid-token marker: no word boundary
        if not current:
            start_t = frame_to_seconds(s, hop_length, sample_rate)
        current.append(ch)
        if token_logprobs is not None:
            n = max(e - s, 1)
            lp_sum += float(token_logprobs[i]) * n
            lp_n += n
        last_end = frame_to_seconds(e, hop_length, sample_rate)
    if current:
        close(last_end)
    return words


def token_logprobs_from_frames(frame_lp, stamps) -> List[float]:
    """Mean per-frame log posterior over each token span; frame_lp (T,)
    is each frame's argmax log posterior (every frame of a span predicts
    its token)."""
    return [float(np.mean(frame_lp[s:max(e, s + 1)])) for s, e in stamps]


def align_tokens_to_frames(log_probs: np.ndarray, tokens: List[int],
                           blank_token: int = BLANK_TOKEN):
    """CTC Viterbi forced alignment of a token sequence to its logits.

    The beam (any backend, any LM) picks the token sequence; the best CTC
    path emitting exactly that sequence then assigns every frame to a
    token or blank. Each token's span is the contiguous run of frames the
    path spends on it: the greedy collapse's spans wherever the Viterbi
    path matches the per-frame argmax.

    Args:
        log_probs: (T, vocab) log posteriors (host numpy).
        tokens: the collapsed token sequence to align (no blanks).

    Returns (stamps, token_lp): [(start, end)] frame spans and each
    token's mean per-frame log posterior over its span; ([], []) for no
    tokens. Raises ValueError if the sequence cannot be emitted in T
    frames (it needs T >= len + the count of adjacent duplicates).
    """
    T = log_probs.shape[0]
    L = len(tokens)
    if L == 0:
        return [], []
    # extended label sequence with optional blanks: [b, t1, b, t2, ..., b]
    ext = np.full(2 * L + 1, blank_token, np.int64)
    ext[1::2] = np.asarray(tokens, np.int64)
    S = ext.size
    need = L + sum(1 for i in range(1, L) if tokens[i] == tokens[i - 1])
    if T < need:
        raise ValueError(f"cannot align {L} tokens to {T} frames (needs >= {need})")
    NEG = -1e30
    lp = np.asarray(log_probs, np.float32)[:, ext]  # (T, S)
    # allowed predecessors: stay (s), advance (s-1), skip a blank (s-2,
    # only onto a non-blank that differs from the previous non-blank)
    skip_ok = np.zeros(S, bool)
    skip_ok[3::2] = ext[3::2] != ext[1:-2:2]
    alpha = np.full(S, NEG, np.float32)
    alpha[0] = lp[0, 0]
    if S > 1:
        alpha[1] = lp[0, 1]
    back = np.zeros((T, S), np.int8)  # 0 stay, 1 advance, 2 skip
    for t in range(1, T):
        stay = alpha
        adv = np.concatenate([[NEG], alpha[:-1]])
        skp = np.concatenate([[NEG, NEG], alpha[:-2]])
        skp = np.where(skip_ok, skp, NEG)
        choice = np.argmax(np.stack([stay, adv, skp]), axis=0)
        best = np.maximum(stay, np.maximum(adv, skp))
        back[t] = choice
        alpha = best + lp[t]
    # the path ends on the final blank or the final token
    s = S - 1 if alpha[S - 1] >= alpha[S - 2] else S - 2
    path = np.zeros(T, np.int64)
    for t in range(T - 1, -1, -1):
        path[t] = s
        s -= int(back[t, s])
    stamps, token_lp = [], []
    frame_lp = np.asarray(log_probs, np.float32)[np.arange(T), ext[path]]
    for i in range(L):
        frames = np.nonzero(path == 2 * i + 1)[0]
        stamps.append((int(frames[0]), int(frames[-1]) + 1))
        token_lp.append(float(frame_lp[frames].mean()))
    return stamps, token_lp


def _log_softmax_np(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    s = x - m
    return s - np.log(np.exp(s).sum(axis=-1, keepdims=True))


def ctc_beam_search(logits, beam_width: int = 10, blank_token: int = BLANK_TOKEN,
                    lm_weight: float = 0.0, lm_scorer: Optional[Any] = None
                    ) -> List[List[DecodingResult]]:
    """Host prefix beam search with max-merge scoring and an optional LM
    scored inside the search (``lm_scorer.score`` of every extension).

    logits: (batch, T, vocab), a tensor on any device or an array. The
    per-step vocabulary loop is vectorised with numpy.
    """
    if isinstance(logits, torch.Tensor):
        logits = logits.detach().to(torch.float32).cpu().numpy()
    log_probs = _log_softmax_np(np.asarray(logits, np.float32))
    batch_size, seq_len, vocab_size = log_probs.shape

    all_results: List[List[DecodingResult]] = []
    nonblank = np.array([t for t in range(vocab_size) if t != blank_token])

    for b in range(batch_size):
        # beams: prefix tuple -> (score, last_token)
        beams = {(): (0.0, None)}

        for t in range(seq_len):
            lp = log_probs[b, t]
            new_beams: dict = {}

            def offer(key, score, last):
                cur = new_beams.get(key)
                if cur is None or cur[0] < score:
                    new_beams[key] = (score, last)

            for prefix, (score, last_token) in beams.items():
                # extend with blank: the prefix is unchanged, the last token resets
                offer(prefix, score + float(lp[blank_token]), blank_token)

                # extend with every non-blank token (vectorised scores)
                token_scores = score + lp[nonblank]
                if lm_scorer is not None and lm_weight > 0:
                    for tok, ts in zip(nonblank, token_scores):
                        tok = int(tok)
                        key = prefix if last_token == tok else prefix + (tok,)
                        ts = float(ts) + lm_weight * lm_scorer.score(list(key))
                        offer(key, ts, tok)
                else:
                    for tok, ts in zip(nonblank.tolist(), token_scores.tolist()):
                        key = prefix if last_token == tok else prefix + (tok,)
                        offer(key, ts, tok)

            # prune to the beam width
            pruned = sorted(new_beams.items(), key=lambda kv: kv[1][0], reverse=True)
            beams = dict(pruned[:beam_width])

        all_results.append([
            DecodingResult(text="", tokens=list(prefix), score=score)
            for prefix, (score, _) in sorted(beams.items(), key=lambda kv: kv[1][0],
                                             reverse=True)
        ])
    return all_results


class CTCDecoder:
    """Vocabulary-aware decoder: greedy and beam search."""

    def __init__(self, vocabulary: List[str], blank_token: int = BLANK_TOKEN):
        self.vocabulary = vocabulary
        self.blank_token = blank_token
        self.vocab_size = len(vocabulary)
        self.token_to_idx = {token: idx for idx, token in enumerate(vocabulary)}

    def decode_greedy(self, logits: torch.Tensor, collapse_repeated: bool = True) -> List[str]:
        token_sequences = ctc_greedy_decode(logits, self.blank_token, collapse_repeated)
        return [self.tokens_to_text(tokens) for tokens in token_sequences]

    def decode_beam_search(self, logits, beam_width: int = 10, return_all_beams: bool = False,
                           backend: str = "device", lm_scorer: Optional[Any] = None,
                           lm_weight: float = 0.0):
        """Beam decode of (batch, T, vocab) logits.

        backend="device" runs ``beam.ctc_beam_search_torch`` on the
        logits' device; "host" runs the numpy prefix beam. An LM (or any
        scorer): the host backend scores every candidate extension inside
        the search; the device backend rescores the returned n-best once,
        total = acoustic + lm_weight * scorer.total_score(tokens) (or
        score(tokens) for a scorer without total_score). The backends agree
        at lm_weight 0; above it the rescoring is an approximation whose
        totals, and possibly rankings, differ from the in-search sums.

        Returns one text per item (the best hypothesis's), or with
        return_all_beams one list of DecodingResult per item, best first.
        """
        if backend not in ("device", "host"):
            raise ValueError(f"unknown beam backend {backend!r}; use 'device' or 'host'")
        if backend == "device":
            from .beam import beams_to_token_lists, ctc_beam_search_torch

            tokens, lengths, scores = ctc_beam_search_torch(
                torch.as_tensor(logits), beam_width=beam_width, blank_token=self.blank_token)
            token_lists = beams_to_token_lists(tokens.cpu().numpy(), lengths.cpu().numpy())
            scores = scores.cpu().numpy()
            beam_results = []
            for b, batch_tokens in enumerate(token_lists):
                # slots no prefix filled carry the NEG_INF sentinel; the
                # host backend returns real beams only
                results = [DecodingResult(text="", tokens=toks, score=float(scores[b, i]))
                           for i, toks in enumerate(batch_tokens) if float(scores[b, i]) > -1e29]
                if lm_scorer is not None and lm_weight > 0:
                    seq_score = getattr(lm_scorer, "total_score", lm_scorer.score)
                    for r in results:
                        r.score += lm_weight * seq_score(r.tokens)
                    results.sort(key=lambda r: r.score, reverse=True)
                beam_results.append(results)
        else:
            beam_results = ctc_beam_search(logits, beam_width=beam_width,
                                           blank_token=self.blank_token,
                                           lm_scorer=lm_scorer, lm_weight=lm_weight)
        if return_all_beams:
            for results in beam_results:
                for r in results:
                    r.text = self.tokens_to_text(r.tokens)
            return beam_results
        return [self.tokens_to_text(results[0].tokens) if results else ""
                for results in beam_results]

    def tokens_to_text(self, tokens: List[int]) -> str:
        chars = [
            self.vocabulary[t] if 0 <= t < self.vocab_size else "<unk>" for t in tokens
        ]
        # Subword marker cleanup.
        return "".join(chars).replace("▁", " ").strip()

    def text_to_tokens(self, text: str) -> List[int]:
        """Character ids of `text`; a character outside the vocabulary
        maps to <unk> where the vocabulary has one, else is dropped."""
        unk = self.token_to_idx.get("<unk>")
        return [self.token_to_idx.get(ch, unk) for ch in text
                if ch in self.token_to_idx or unk is not None]


def create_default_vocabulary(vocab_size: int = 50000) -> List[str]:
    """Default character vocabulary."""
    vocab = ["<blank>", "<unk>", "<pad>", " "]
    vocab.extend(list("abcdefghijklmnopqrstuvwxyz"))
    vocab.extend(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))
    vocab.extend(list("0123456789"))
    vocab.extend(list(".,!?;:'\"()-"))
    for i in range(len(vocab), vocab_size):
        vocab.append(f"<token_{i}>")
    return vocab
