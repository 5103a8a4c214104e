"""Train VELOCITY-ASR with the port (scripts/train.py's offline and
streaming-aware objectives).

    python -m velocity_asr_tpu_torch.train --config configs/train_synth.yaml \
        --model-config configs/model_synth.yaml [--synthetic N] [--max-steps N] \
        [--lr-total-steps N] [--batch-size N] [--checkpoint-dir DIR] \
        [--resume CKPT | --init-from PRETRAINED_DIR] [--num-workers 8] [--device cuda]
    python -m velocity_asr_tpu_torch.train --config configs/train_synth_stream.yaml \
        --model-config configs/model_synth.yaml \
        --init-from checkpoints/synth_run/final_pretrained

Data (``build_data``) is the synthetic speech corpus (``data.synthetic``
or ``--synthetic N``: N train utterances and max(64, N // 100) from the
dev split for evaluation, batches padded to multiples of
``data.frame_bucket`` frames, default 200), else a JSONL manifest
(``data.manifest``, ``data.eval_manifest``), else LibriSpeech on disk
(``data.librispeech_root``, ``train_splits``, ``val_splits``; FLAC), else
random data with a warning. The mel is computed on the host, or with
``data.device_mel: true`` on the device from int16 PCM batches (which
``training.streaming_chunks`` and the waveform augmentations need). The
model's vocabulary is rebuilt from the dataset's. ``--profile-dir``
writes a ``torch.profiler`` trace of micro-steps ``[profile_start,
profile_start + profile_steps)``. ``--init-from`` starts from a
``final_pretrained`` directory's weights with a fresh optimizer and step;
``--resume`` restores a trainer checkpoint. At the end the run writes
``final_model/`` (trainer checkpoint) and ``final_pretrained/``
(``config.json``, flax ``params.msgpack``, ``vocabulary.json``) under the
checkpoint directory. It runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
from typing import List, Optional

import numpy as np

from .config import load_yaml, model_config_from_yaml, training_config_from_yaml
from .data import (ASRCollator, DataLoader, create_dataloader,
                   create_librispeech_dataloaders, cycle)
from .device import resolve_device
from .models.model import create_model, from_pretrained, save_pretrained
from .synth import SyntheticSpeechDataset
from .training import Trainer

logger = logging.getLogger("velocity_asr_tpu_torch.train")


class DummyASRDataset:
    """Random host-mel items (the JAX CLI's smoke dataset): item idx draws
    from ``np.random.default_rng(seed + idx)`` 100-499 frames of standard
    normal mel and 10-49 tokens in [3, vocab_size)."""

    def __init__(self, num_samples: int = 1000, vocab_size: int = 1000, seed: int = 0):
        self.num_samples = num_samples
        self.vocab_size = vocab_size
        self.seed = seed

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng(self.seed + idx)
        frames = int(rng.integers(100, 500))
        n_tokens = int(rng.integers(10, 50))
        return {
            "mel_spectrogram": rng.standard_normal((frames, 80)).astype(np.float32),
            "targets": rng.integers(3, self.vocab_size, size=(n_tokens,)).astype(np.int32),
            "input_lengths": np.int32(frames),
            "target_lengths": np.int32(n_tokens),
            "text": "",
        }


def build_data(data_cfg: dict, batch_size: int, num_workers: int, vocab_size: int = 1000):
    """(train loader, eval loader or None, vocabulary {token: id} or None),
    from the first source the ``data:`` section configures:

    - ``synthetic: N``: N train utterances of the synthetic corpus and
      max(64, N // 100) of its dev split;
    - ``manifest`` (an existing JSONL file), with ``eval_manifest``
      encoded in the train vocabulary;
    - ``librispeech_root`` (a directory holding ``LibriSpeech/``),
      ``train_splits`` and ``val_splits``;
    - otherwise random data (``DummyASRDataset`` of `vocab_size` tokens,
      no eval set, no vocabulary), with a warning.

    ``device_mel`` makes the audio sources' items raw audio;
    ``max_duration`` / ``min_duration`` filter the manifests and cut
    LibriSpeech."""
    device_mel = bool(data_cfg.get("device_mel", False))
    n_synth = int(data_cfg.get("synthetic", 0) or 0)
    if n_synth:
        return _synthetic_data(data_cfg, n_synth, device_mel, batch_size, num_workers)
    max_duration = data_cfg.get("max_duration", 30.0)
    manifest = data_cfg.get("manifest")
    if manifest and os.path.exists(manifest):
        logger.info("Using manifest dataset: %s", manifest)
        durations = {"max_duration": max_duration,
                     "min_duration": data_cfg.get("min_duration", 0.5)}
        train_loader, train_ds = create_dataloader(
            manifest, batch_size=batch_size, shuffle=True, num_workers=num_workers,
            device_mel=device_mel, **durations)
        eval_loader = None
        eval_manifest = data_cfg.get("eval_manifest")
        if eval_manifest and os.path.exists(eval_manifest):
            # the train pipeline's options, and the train vocabulary
            eval_loader, eval_ds = create_dataloader(
                eval_manifest, batch_size=batch_size, shuffle=False,
                num_workers=num_workers, device_mel=device_mel, **durations)
            eval_ds.vocab = train_ds.vocab
        return train_loader, eval_loader, train_ds.vocab
    root = data_cfg.get("librispeech_root")
    if root and os.path.isdir(os.path.join(root, "LibriSpeech")):
        logger.info("Using LibriSpeech at %s", root)
        return create_librispeech_dataloaders(
            root=root, train_splits=data_cfg.get("train_splits", ["train-clean-100"]),
            val_splits=data_cfg.get("val_splits", ["dev-clean"]), batch_size=batch_size,
            num_workers=num_workers, max_duration=max_duration, device_mel=device_mel)
    logger.warning("No dataset configured; using dummy random data")
    loader = DataLoader(DummyASRDataset(vocab_size=vocab_size), batch_size=batch_size,
                        shuffle=True, num_workers=num_workers, collate_fn=ASRCollator(),
                        drop_last=True)
    return loader, None, None


def _synthetic_data(data_cfg: dict, n_synth: int, device_mel: bool, batch_size: int,
                    num_workers: int):
    if int(data_cfg.get("synthetic_languages", 1)) != 1:
        raise NotImplementedError("multilingual synthetic data (language-ID training) is not "
                                  "ported yet (ROADMAP module item 8)")
    collator = ASRCollator(frame_bucket=int(data_cfg.get("frame_bucket", 200)))
    seed = int(data_cfg.get("synthetic_seed", 1234))
    split = str(data_cfg.get("synthetic_split", "train"))
    words = {"min_words": int(data_cfg.get("synthetic_min_words", 2)),
             "max_words": int(data_cfg.get("synthetic_max_words", 8)),
             "device_mel": device_mel}
    logger.info("Using synthetic speech corpus: %d train utterances", n_synth)
    train_ds = SyntheticSpeechDataset(n_synth, split=split, seed=seed, **words)
    eval_ds = SyntheticSpeechDataset(
        max(64, n_synth // 100), split=f"{split}_dev" if split != "train" else "dev",
        seed=seed, **words)
    train_loader = DataLoader(train_ds, batch_size=batch_size, shuffle=True,
                              num_workers=num_workers, collate_fn=collator, drop_last=True,
                              prefetch=4)
    eval_loader = DataLoader(eval_ds, batch_size=batch_size, shuffle=False,
                             num_workers=num_workers, collate_fn=collator)
    return train_loader, eval_loader, train_ds.vocab


def _is_pretrain_artifact(path: str) -> bool:
    """A masked-prediction backbone (the JAX package's pretrain.py output)."""
    config_file = os.path.join(path, "config.json")
    if not os.path.exists(config_file):
        return False
    with open(config_file) as f:
        return json.load(f).get("objective") == "masked_prediction"


def vocab_to_list(vocab: dict) -> list:
    """id -> token list from a {token: id} vocabulary."""
    out = [None] * (max(vocab.values()) + 1)
    for token, idx in vocab.items():
        out[idx] = token
    return [t if t is not None else "<unk>" for t in out]


def main(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description="Train VELOCITY-ASR (PyTorch port)")
    parser.add_argument("--config", default="configs/train.yaml")
    parser.add_argument("--model-config", default="configs/model.yaml")
    parser.add_argument("--resume", default=None, help="trainer checkpoint to resume from")
    parser.add_argument("--init-from", default=None,
                        help="pretrained directory (config.json + params.msgpack): start "
                             "from its weights with a fresh optimizer and step")
    parser.add_argument("--max-steps", type=int, default=None, help="override max_steps")
    parser.add_argument("--lr-total-steps", type=int, default=None,
                        help="cosine-decay horizon in optimizer updates")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--checkpoint-dir", default=None,
                        help="override checkpoint.dir (metrics.jsonl moves beside it)")
    parser.add_argument("--synthetic", type=int, default=None,
                        help="train on N synthetic-speech utterances")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace of micro-steps [profile_start, "
                             "profile_start + profile_steps) here")
    parser.add_argument("--num-workers", type=int, default=8,
                        help="data loader worker processes (0: load in this process)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(levelname)s | %(message)s")

    for flag, path, default in (("--config", args.config, "configs/train.yaml"),
                                ("--model-config", args.model_config, "configs/model.yaml")):
        if path != default and not os.path.exists(path):
            parser.error(f"{flag} {path!r} does not exist")
    if args.init_from and args.resume:
        parser.error("--init-from and --resume are mutually exclusive")
    device = resolve_device(args.device)
    train_dict = load_yaml(args.config) if os.path.exists(args.config) else {}
    model_dict = load_yaml(args.model_config) if os.path.exists(args.model_config) else {}
    model_cfg = model_config_from_yaml(model_dict)
    train_cfg = training_config_from_yaml(train_dict)
    overrides = {"max_steps": args.max_steps, "lr_total_steps": args.lr_total_steps,
                 "batch_size": args.batch_size}
    train_cfg = dataclasses.replace(train_cfg, **{k: v for k, v in overrides.items()
                                                  if v is not None})
    if args.checkpoint_dir is not None:
        moved = {"checkpoint_dir": args.checkpoint_dir}
        if train_cfg.metrics_path:
            moved["metrics_path"] = os.path.join(args.checkpoint_dir,
                                                 os.path.basename(train_cfg.metrics_path))
        train_cfg = dataclasses.replace(train_cfg, **moved)
    if args.profile_dir is not None:
        train_cfg = dataclasses.replace(train_cfg, profile_dir=args.profile_dir)
    if (train_dict.get("quantization") or {}).get("enabled"):
        raise NotImplementedError("quantization-aware training is not ported yet "
                                  "(ROADMAP module item 6)")
    if not train_cfg.use_amp and model_cfg.dtype != "float32":
        logger.info("use_amp disabled: forcing float32 compute")
        model_cfg = dataclasses.replace(model_cfg, dtype="float32")

    data_cfg = dict(train_dict.get("data") or {})
    if args.synthetic is not None:
        data_cfg["synthetic"] = args.synthetic
    train_loader, eval_loader, vocab = build_data(data_cfg, train_cfg.batch_size,
                                                  args.num_workers, model_cfg.vocab_size)
    if vocab is not None and len(vocab) != model_cfg.vocab_size:
        logger.info("Dataset vocab size %d != model vocab %d; rebuilding model config",
                    len(vocab), model_cfg.vocab_size)
        model_cfg = dataclasses.replace(model_cfg, vocab_size=len(vocab))

    model = create_model(model_cfg, device=device)
    if args.init_from:
        if _is_pretrain_artifact(args.init_from):
            raise NotImplementedError("initialising from a pretraining artifact is not "
                                      "ported yet (ROADMAP module item 8)")
        loaded = from_pretrained(args.init_from, device=device)
        if loaded.config.vocab_size != model_cfg.vocab_size:
            raise SystemExit(f"--init-from vocab_size {loaded.config.vocab_size} != "
                             f"configured/dataset vocab_size {model_cfg.vocab_size}; fine-tune "
                             "with the vocabulary the weights were trained on")
        model.load_state_dict(loaded.state_dict(), strict=True)
        logger.info("Initialized weights from %s (fresh optimizer/step)", args.init_from)
    logger.info("Model config: %s", model_cfg)
    logger.info("Parameters: %s", f"{sum(p.numel() for p in model.parameters()):,}")

    eval_batches = (lambda: iter(eval_loader)) if eval_loader is not None else None
    batches = cycle(train_loader)
    trainer = Trainer(model, train_cfg, batches, eval_batches)
    if args.resume:
        trainer.load_checkpoint(args.resume)
    try:
        history = trainer.train()
    finally:
        batches.close()  # stops the loader's worker processes

    final = os.path.join(train_cfg.checkpoint_dir, "final_model")
    trainer.save_checkpoint(final)
    pretrained = os.path.join(train_cfg.checkpoint_dir, "final_pretrained")
    save_pretrained(pretrained, model_cfg, model)
    if vocab is not None:
        # transcribe and evaluate read the id -> token layout from here
        with open(os.path.join(pretrained, "vocabulary.json"), "w") as f:
            json.dump(vocab_to_list(vocab), f)
    logger.info("Training complete. Final checkpoint: %s", final)
    return {"history": history, "trainer": trainer}


if __name__ == "__main__":
    main()
