"""Greedy CTC decoding (mirrors the greedy half of velocity_asr_tpu/decode.py).

The argmax, blank removal and repeat collapse run on the logits' device;
only the packed token ids go to the host.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

BLANK_TOKEN = 0


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


class CTCDecoder:
    """Vocabulary-aware greedy decoder."""

    def __init__(self, vocabulary: List[str], blank_token: int = BLANK_TOKEN):
        self.vocabulary = vocabulary
        self.blank_token = blank_token
        self.vocab_size = len(vocabulary)
        self.token_to_idx = {token: idx for idx, token in enumerate(vocabulary)}

    def decode_greedy(self, logits: torch.Tensor, collapse_repeated: bool = True) -> List[str]:
        token_sequences = ctc_greedy_decode(logits, self.blank_token, collapse_repeated)
        return [self.tokens_to_text(tokens) for tokens in token_sequences]

    def tokens_to_text(self, tokens: List[int]) -> str:
        chars = [
            self.vocabulary[t] if 0 <= t < self.vocab_size else "<unk>" for t in tokens
        ]
        # Subword marker cleanup.
        return "".join(chars).replace("▁", " ").strip()


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
