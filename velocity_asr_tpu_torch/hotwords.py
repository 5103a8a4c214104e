"""Hot-word boosting (contextual biasing) for CTC beam search (a copy of
velocity_asr_tpu/hotwords.py).

The reference lists "Hot-Word Boosting: Architecture extension for
custom vocabulary injection" as planned future work (reference
README.md "Planned Extensions") with no implementation. Implemented
here as decode-time shallow-fusion biasing — no architecture change, no
retraining, works with any checkpoint:

  - a character trie over the hotword list (token-id space);
  - during beam search each hypothesis earns `bonus_per_char` for every
    character that extends a trie path within its current word; the
    credit is retracted the moment the word stops matching (on a
    mismatched character, or on a word boundary that completes a
    non-hotword). Only words that complete as hotwords keep their
    bonus — but the partial credit keeps matching hypotheses alive
    through beam pruning, which is why in-search biasing beats pure
    n-best rescoring;
  - an extra `completion_bonus` lands on the boundary that completes a
    hotword.

Two evaluation modes matching CTCDecoder's two beam backends:
`score(tokens)` returns the INCREMENTAL bonus of the last token given
the preceding prefix — the lm_scorer contract of the host prefix beam,
which accumulates it at every extension (reference decode.py:188-190) —
while `total_score(tokens)` scores a complete hypothesis in one pass
(used to rescore the device beam's n-best). The two are consistent:
summing `score` over a sequence's prefixes equals `total_score`
(tests/test_torch_lm_hotwords.py).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)


class HotwordBooster:
    """Trie-based shallow-fusion biasing over a character vocabulary.

    Scores are in "bonus units"; the decoder's `lm_weight` scales them.
    """

    def __init__(
        self,
        hotwords: Iterable[str],
        token_to_idx: Dict[str, int],
        bonus_per_char: float = 1.0,
        completion_bonus: float = 1.0,
        boundary: str = " ",
    ):
        if boundary not in token_to_idx:
            raise ValueError(
                f"vocabulary has no boundary token {boundary!r}; hotword "
                "boosting needs word boundaries to score completions"
            )
        self.bonus_per_char = float(bonus_per_char)
        self.completion_bonus = float(completion_bonus)
        self.boundary = token_to_idx[boundary]

        self.words: set = set()
        self.prefixes: set = set()
        skipped: List[str] = []
        for word in hotwords:
            word = word.strip().lower()
            if not word:
                continue
            try:
                toks = tuple(token_to_idx[c] for c in word)
            except KeyError:
                skipped.append(word)
                continue
            if self.boundary in toks:
                # Multi-word phrases decompose into their words: each is
                # boosted independently (the trie is per-word).
                for part in word.split(" "):
                    if part:
                        self._add(tuple(token_to_idx[c] for c in part))
                continue
            self._add(toks)
        if skipped:
            logger.warning(
                "skipped %d hotword(s) with out-of-vocabulary characters: %s",
                len(skipped), ", ".join(skipped[:5]),
            )
        if not self.words:
            raise ValueError("no usable hotwords after vocabulary filtering")

    def _add(self, toks: Tuple[int, ...]) -> None:
        self.words.add(toks)
        for i in range(1, len(toks) + 1):
            self.prefixes.add(toks[:i])

    @classmethod
    def from_file(
        cls, path: str, token_to_idx: Dict[str, int], **kwargs
    ) -> "HotwordBooster":
        """One hotword (or phrase) per line; '#' comments and blanks skipped."""
        words = []
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if line:
                    words.append(line)
        return cls(words, token_to_idx, **kwargs)

    # ----- scoring -----------------------------------------------------------

    def _credit(self, partial: Tuple[int, ...]) -> float:
        return (
            self.bonus_per_char * len(partial)
            if partial in self.prefixes
            else 0.0
        )

    def _partial(self, tokens: Sequence[int]) -> Tuple[int, ...]:
        """The in-progress word: tokens after the last boundary."""
        out: List[int] = []
        for t in reversed(tokens):
            if t == self.boundary:
                break
            out.append(t)
        return tuple(reversed(out))

    def score(self, tokens: Sequence[int]) -> float:
        """Incremental bonus of tokens[-1] given tokens[:-1] (the host
        beam's per-extension lm_scorer contract)."""
        if not tokens:
            return 0.0
        last = tokens[-1]
        prev_partial = self._partial(tokens[:-1])
        if last == self.boundary:
            if prev_partial in self.words:
                return self.completion_bonus
            return -self._credit(prev_partial)
        new_partial = prev_partial + (last,)
        return self._credit(new_partial) - self._credit(prev_partial)

    def total_score(self, tokens: Sequence[int]) -> float:
        """Full-hypothesis bonus in one pass (n-best rescoring). Equals the
        sum of `score` over the sequence's prefixes: completed hotwords
        keep per-char credit + completion_bonus; completed non-hotwords
        score 0; a dangling final partial keeps its prefix credit."""
        total = 0.0
        word: Tuple[int, ...] = ()
        for t in tokens:
            if t == self.boundary:
                if word in self.words:
                    total += (
                        self.bonus_per_char * len(word) + self.completion_bonus
                    )
                word = ()
            else:
                word += (t,)
        return total + self._credit(word)


def load_hotwords_arg(
    spec: Optional[str], token_to_idx: Dict[str, int], **kwargs
) -> Optional[HotwordBooster]:
    """CLI helper: `spec` is either a path to a hotword file or an inline
    comma-separated list ("velocity,asr"). None passes through."""
    if not spec:
        return None
    if os.path.exists(spec):
        return HotwordBooster.from_file(spec, token_to_idx, **kwargs)
    return HotwordBooster(
        [w for w in spec.split(",") if w.strip()], token_to_idx, **kwargs
    )
