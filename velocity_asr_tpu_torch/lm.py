"""Character n-gram language model for beam-search shallow fusion
(a framework-free copy of velocity_asr_tpu/lm.py).

An interpolated Kneser-Ney character n-gram LM trainable from any
transcript source (a JSONL manifest's `text` fields, a plain-text file,
or the synthetic corpus), implementing the same scorer contract as
hotwords.HotwordBooster:

  - ``score(tokens)``: log P(last token | preceding context), the host
    prefix beam's per-extension contract (decode.ctc_beam_search);
  - ``total_score(tokens)``: sum of per-position log probs, used by the
    device beam's n-best rescoring (decode.CTCDecoder).

Scores are natural-log probabilities; the decoder's ``lm_weight`` scales
them. Train with ``python -m velocity_asr_tpu_torch.train_lm``; load
with ``CharNGramLM.load`` (the JAX package's artifacts load as they are).

Model notes: interpolated Kneser-Ney with order-specific absolute
discounts D_k = n1/(n1+2*n2) (the standard estimate), continuation
counts for lower orders, and a uniform 1/V floor below the unigram so
unseen tokens score finitely. Sequences are BOS-padded; no EOS is
modeled (CTC hypotheses are open prefixes).
"""

from __future__ import annotations

import gzip
import json
import math
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

#: BOS sentinel (never a real token id; ids are >= 0)
BOS = -1


class CharNGramLM:
    """Interpolated Kneser-Ney character n-gram LM over token ids."""

    def __init__(
        self,
        order: int,
        vocab_size: int,
        probs: Dict[int, Dict[Tuple[int, ...], Dict[int, float]]],
        backoff: Dict[int, Dict[Tuple[int, ...], float]],
        token_to_idx: Optional[Dict[str, int]] = None,
    ):
        self.order = order
        self.vocab_size = vocab_size
        # probs[k][context][token] = discounted prob mass at order k
        # (context length k-1); backoff[k][context] = interpolation weight
        # onto order k-1. Only contexts seen in training are present.
        self._probs = probs
        self._backoff = backoff
        self.token_to_idx = token_to_idx

    # ----- training -------------------------------------------------------

    @classmethod
    def train(
        cls,
        texts: Iterable[str],
        token_to_idx: Dict[str, int],
        order: int = 5,
        unk_id: int = 1,
    ) -> "CharNGramLM":
        """Estimate the LM from transcripts.

        Characters are mapped through token_to_idx (the decoder's
        vocabulary); unmapped characters become unk_id (the <unk>
        convention of data.ASRDataset).
        """
        if order < 1:
            raise ValueError("order must be >= 1")
        vocab_size = max(token_to_idx.values()) + 1

        counts: List[Dict[Tuple[int, ...], Dict[int, int]]] = [
            {} for _ in range(order + 1)
        ]
        n_sent = 0
        for text in texts:
            ids = [token_to_idx.get(c, unk_id) for c in text]
            if not ids:
                continue
            n_sent += 1
            padded = [BOS] * (order - 1) + ids
            for i in range(order - 1, len(padded)):
                w = padded[i]
                for k in range(1, order + 1):
                    ctx = tuple(padded[i - k + 1 : i])
                    bucket = counts[k].setdefault(ctx, {})
                    bucket[w] = bucket.get(w, 0) + 1
        if n_sent == 0:
            raise ValueError("no non-empty training texts")

        # Kneser-Ney continuation counts replace raw counts at orders < N:
        # count'_k(ctx, w) = |{v : (v, ctx, w) seen at order k+1}|.
        for k in range(order - 1, 0, -1):
            cont: Dict[Tuple[int, ...], Dict[int, int]] = {}
            for ctx, bucket in counts[k + 1].items():
                sub = ctx[1:]
                dest = cont.setdefault(sub, {})
                for w in bucket:
                    dest[w] = dest.get(w, 0) + 1
            # Contexts that never appear as the suffix of a longer context
            # (sentence-initial BOS runs) receive no continuation mass;
            # keep their raw counts so early-sentence history still has
            # statistics.
            for ctx, bucket in counts[k].items():
                if ctx not in cont:
                    cont[ctx] = dict(bucket)
            counts[k] = cont

        probs: Dict[int, Dict[Tuple[int, ...], Dict[int, float]]] = {}
        backoff: Dict[int, Dict[Tuple[int, ...], float]] = {}
        for k in range(1, order + 1):
            # order-specific absolute discount D = n1 / (n1 + 2 n2)
            n1 = sum(
                1 for b in counts[k].values() for c in b.values() if c == 1
            )
            n2 = sum(
                1 for b in counts[k].values() for c in b.values() if c == 2
            )
            d = n1 / (n1 + 2.0 * n2) if (n1 + n2) > 0 else 0.5
            probs[k] = {}
            backoff[k] = {}
            for ctx, bucket in counts[k].items():
                total = sum(bucket.values())
                probs[k][ctx] = {
                    w: max(c - d, 0.0) / total for w, c in bucket.items()
                }
                backoff[k][ctx] = d * len(bucket) / total
        return cls(order, vocab_size, probs, backoff, dict(token_to_idx))

    # ----- scoring --------------------------------------------------------

    def _prob(self, ctx: Tuple[int, ...], w: int) -> float:
        k = len(ctx) + 1
        if k == 0 or k > self.order:
            raise AssertionError("context length out of range")
        if k == 1:
            base = 1.0 / self.vocab_size
            bucket = self._probs[1].get((), {})
            bo = self._backoff[1].get((), 1.0)
            return bucket.get(w, 0.0) + bo * base
        bucket = self._probs[k].get(ctx)
        lower = self._prob(ctx[1:], w)
        if bucket is None:
            return lower
        return bucket.get(w, 0.0) + self._backoff[k][ctx] * lower

    def log_prob(self, context: Sequence[int], token: int) -> float:
        """log P(token | context), using the last order-1 context tokens
        (BOS-padded on the left)."""
        ctx = [BOS] * (self.order - 1) + list(context)
        ctx = tuple(ctx[len(ctx) - (self.order - 1):]) if self.order > 1 else ()
        return math.log(max(self._prob(ctx, token), 1e-30))

    def score(self, tokens: Sequence[int]) -> float:
        """Incremental scorer contract: log P of the LAST token given the
        preceding tokens (summing over a sequence's prefixes equals
        total_score — pinned by tests)."""
        if not tokens:
            return 0.0
        return self.log_prob(tokens[:-1], tokens[-1])

    def total_score(self, tokens: Sequence[int]) -> float:
        """Whole-sequence log probability (n-best rescoring contract)."""
        return sum(
            self.log_prob(tokens[:i], tokens[i]) for i in range(len(tokens))
        )

    def perplexity(self, texts: Iterable[str], unk_id: int = 1) -> float:
        """Per-character perplexity over texts (training diagnostics)."""
        if self.token_to_idx is None:
            raise ValueError("LM has no vocabulary mapping")
        total, n = 0.0, 0
        for text in texts:
            ids = [self.token_to_idx.get(c, unk_id) for c in text]
            total += self.total_score(ids)
            n += len(ids)
        return math.exp(-total / max(n, 1))

    # ----- persistence ----------------------------------------------------

    def save(self, path: str) -> None:
        """Persist as gzipped JSON (contexts are joined id strings)."""
        payload = {
            "format": "char_ngram_kn_v1",
            "order": self.order,
            "vocab_size": self.vocab_size,
            "token_to_idx": self.token_to_idx,
            "probs": {
                str(k): {
                    ",".join(map(str, ctx)): {str(w): p for w, p in b.items()}
                    for ctx, b in per.items()
                }
                for k, per in self._probs.items()
            },
            "backoff": {
                str(k): {",".join(map(str, ctx)): v for ctx, v in per.items()}
                for k, per in self._backoff.items()
            },
        }
        with gzip.open(path, "wt") as f:
            json.dump(payload, f)

    @classmethod
    def load(cls, path: str) -> "CharNGramLM":
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            payload = json.load(f)
        if payload.get("format") != "char_ngram_kn_v1":
            raise ValueError(f"{path} is not a char n-gram LM artifact")

        def parse_ctx(s: str) -> Tuple[int, ...]:
            return tuple(int(x) for x in s.split(",")) if s else ()

        probs = {
            int(k): {
                parse_ctx(ctx): {int(w): p for w, p in b.items()}
                for ctx, b in per.items()
            }
            for k, per in payload["probs"].items()
        }
        backoff = {
            int(k): {parse_ctx(ctx): v for ctx, v in per.items()}
            for k, per in payload["backoff"].items()
        }
        return cls(
            payload["order"], payload["vocab_size"], probs, backoff,
            payload.get("token_to_idx"),
        )


class CombinedScorer:
    """Weighted sum of shallow-fusion scorers (e.g. n-gram LM + hotword
    booster) behind the single lm_scorer slot the decoders expose.

    The decoder's own lm_weight should then be 1.0 — the per-scorer
    weights live here.
    """

    def __init__(self, scorers_and_weights: Sequence[Tuple[Any, float]]):
        if not scorers_and_weights:
            raise ValueError("need at least one scorer")
        self.parts = list(scorers_and_weights)

    def score(self, tokens: Sequence[int]) -> float:
        return sum(w * s.score(tokens) for s, w in self.parts)

    def total_score(self, tokens: Sequence[int]) -> float:
        return sum(
            w * getattr(s, "total_score", s.score)(tokens)
            for s, w in self.parts
        )
