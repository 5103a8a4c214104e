"""Train the character n-gram LM for beam-search shallow fusion (the LM
build of scripts/train_lm.py).

    # from the synthetic training corpus (the committed checkpoint's text)
    python -m velocity_asr_tpu_torch.train_lm --synthetic 50000 --out lm.json.gz

    # from a JSONL manifest's text fields, or a plain-text file (one
    # sentence per line): the checkpoint's vocabulary.json gives the ids
    python -m velocity_asr_tpu_torch.train_lm --manifest train.jsonl \
        --checkpoint DIR --out lm.json.gz

The LM must share the decoder's token ids: --checkpoint reads the
checkpoint's vocabulary.json (--synthetic otherwise uses the synthetic
corpus's vocabulary). Use it with ``transcribe`` or ``evaluate``
``--beam-width 8 --lm lm.json.gz --lm-weight 0.5``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import List

from .lm import CharNGramLM
from .synth import SyntheticSpeechDataset

logger = logging.getLogger("velocity_asr_tpu_torch.train_lm")


def _load_vocab(checkpoint: str, parser) -> dict:
    vocab_path = os.path.join(checkpoint, "vocabulary.json")
    if not os.path.exists(vocab_path):
        parser.error(f"{vocab_path} not found")
    with open(vocab_path) as f:
        vocab = json.load(f)
    return {tok: i for i, tok in enumerate(vocab)}


def main(argv: List[str] | None = None) -> CharNGramLM:
    parser = argparse.ArgumentParser(description="Train a character n-gram LM")
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--manifest", help="JSONL manifest with text fields")
    src.add_argument("--text", help="plain-text file, one sentence per line")
    src.add_argument("--synthetic", type=int, metavar="N",
                     help="N sentences from the synthetic training corpus")
    parser.add_argument("--checkpoint",
                        help="checkpoint dir whose vocabulary.json defines the token ids "
                             "(required for --manifest/--text)")
    parser.add_argument("--order", type=int, default=5)
    parser.add_argument("--out", default="lm.json.gz")
    parser.add_argument("--holdout", type=int, default=500,
                        help="sentences held out for the perplexity report")
    parser.add_argument("--seed", type=int, default=1234, help="synthetic corpus seed")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(levelname)s | %(message)s")

    if args.synthetic:
        ds = SyntheticSpeechDataset(args.synthetic, split="train", seed=args.seed)
        texts = [ds.text_for(i) for i in range(args.synthetic)]
        token_to_idx = (_load_vocab(args.checkpoint, parser) if args.checkpoint
                        else dict(ds.vocab))
    else:
        if not args.checkpoint:
            parser.error("--manifest/--text need --checkpoint for the vocabulary mapping")
        token_to_idx = _load_vocab(args.checkpoint, parser)
        with open(args.manifest or args.text) as f:
            lines = [line.strip() for line in f if line.strip()]
        texts = ([json.loads(line)["text"].lower() for line in lines] if args.manifest
                 else [line.lower() for line in lines])
    if not texts:
        parser.error("no training texts found")

    holdout = texts[: args.holdout] if len(texts) > 2 * args.holdout else []
    train_texts = texts[len(holdout):]
    logger.info("Training order-%d char LM on %d sentences (%d held out)",
                args.order, len(train_texts), len(holdout))
    lm = CharNGramLM.train(train_texts, token_to_idx, order=args.order)
    lm.save(args.out)
    logger.info("Saved %s (%.2f MB)", args.out, os.path.getsize(args.out) / 1e6)
    if holdout:
        logger.info("Per-char perplexity: held-out %.3f, train %.3f (uniform over %d tokens "
                    "would be %d)", lm.perplexity(holdout),
                    lm.perplexity(train_texts[: args.holdout]), lm.vocab_size, lm.vocab_size)
    return lm


if __name__ == "__main__":
    main()
