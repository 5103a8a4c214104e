"""The first leg of the JAX package's synthetic training run, replayed by
the port, and held against that run's records.

    python -m velocity_asr_tpu_torch.parity_run --out DIR [--steps 6000] \
        [--eval-utts 1000] [--num-workers 8] [--device cuda]

The JAX run's first leg (``checkpoints/synth_run``): micro-steps 0-6,000
of ``configs/train_synth.yaml`` + ``model_synth.yaml`` at batch 8 x
accumulation 4 (the YAML now says 16 x 2), bf16, its cosine horizon the
max_steps count of updates, 6,000 (the default of the time). Here a copy
of the YAML with 8 x 4 goes through ``python -m velocity_asr_tpu_torch.train``
from scratch with ``--lr-total-steps 6000``; its ``final_pretrained`` is
then evaluated in fp32 over the first ``--eval-utts`` held-out
utterances (batch 16, frame bucket 200, greedy), as
``eval_step06000_fp32.json`` was. Prints the 50-step interval mean loss
at micro-steps 500, 1,000, 3,000 and 6,000 beside the JAX run's
(``metrics.jsonl``), the WER and CER beside the JAX file's, the trainer's
data-wait share and the card's name and power limit, and writes them to
``DIR/parity.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_DIR = os.path.join(ROOT, "checkpoints", "synth_run")
JAX_METRICS = os.path.join(RUN_DIR, "metrics.jsonl")
JAX_EVAL = os.path.join(RUN_DIR, "eval_step06000_fp32.json")
CHECK_STEPS = (500, 1000, 3000, 6000)
FIRST_LEG = {"batch_size": 8, "gradient_accumulation_steps": 4}


def first_leg_yaml(src: str, dst: str) -> None:
    """Copy the recipe YAML with the first leg's batch and accumulation."""
    with open(src) as f:
        text = f.read()
    for key, value in FIRST_LEG.items():
        text, n = re.subn(rf"^(\s*{key}:)\s*\d+\s*$", rf"\g<1> {value}", text, flags=re.M)
        if n != 1:
            raise ValueError(f"{src}: expected one {key!r} line, found {n}")
    with open(dst, "w") as f:
        f.write(text)


def interval_losses(path: str) -> Dict[int, float]:
    """{micro-step: the logged interval mean loss} of a metrics.jsonl ({}
    if the run logged none)."""
    out = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            if line.strip():
                row = json.loads(line)
                out[int(row["step"])] = float(row["loss"])
    return out


def card_line() -> str:
    """nvidia-smi's name and power limit, or "not a CUDA host"."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not a CUDA host"


def evaluate_fp32(pretrained: str, corpus: str, n: int, device: str) -> dict:
    """Greedy batched fp32 evaluation of `pretrained` over the first n
    held-out utterances written under `corpus`."""
    from .data import ASRCollator
    from .evaluate import evaluate, load_test_set
    from .models.model import from_pretrained
    from .synth import write_corpus
    from .transcribe import checkpoint_decoder

    manifest = write_corpus(corpus, n, split="test", seed=1234)
    model = from_pretrained(pretrained, device=device, dtype="float32")
    decoder = checkpoint_decoder(pretrained, model.config.vocab_size)
    ds, n = load_test_set(manifest, n)
    return evaluate(model, decoder, ds, n, ASRCollator(frame_bucket=200, target_bucket=1),
                    batch_size=16)


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", required=True, help="run directory (checkpoints, metrics)")
    parser.add_argument("--steps", type=int, default=6000, help="micro-steps")
    parser.add_argument("--eval-utts", type=int, default=1000)
    parser.add_argument("--num-workers", type=int, default=8)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    card = card_line()
    print(card, flush=True)

    config = os.path.join(args.out, "train_synth_b8x4.yaml")
    first_leg_yaml(os.path.join(ROOT, "configs", "train_synth.yaml"), config)
    cmd = [sys.executable, "-m", "velocity_asr_tpu_torch.train", "--config", config,
           "--model-config", os.path.join(ROOT, "configs", "model_synth.yaml"),
           "--checkpoint-dir", args.out, "--max-steps", str(args.steps),
           "--lr-total-steps", "6000", "--num-workers", str(args.num_workers),
           "--device", args.device]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    train_s = time.perf_counter() - t0
    with open(os.path.join(args.out, "train.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-6000:])
        raise SystemExit(f"training failed (exit {proc.returncode})")
    wait = re.search(r"data wait ([0-9.]+) s of ([0-9.]+) s", proc.stderr)

    ours = interval_losses(os.path.join(args.out, "metrics.jsonl"))
    jax = interval_losses(JAX_METRICS)
    t1 = time.perf_counter()
    result = evaluate_fp32(os.path.join(args.out, "final_pretrained"),
                           os.path.join(args.out, "corpus"), args.eval_utts, args.device)
    with open(JAX_EVAL) as f:
        jax_eval = json.load(f)
    summary = {
        "card": card,
        "micro_steps": args.steps,
        "train_seconds": train_s,
        "data_wait_seconds": float(wait.group(1)) if wait else None,
        "train_loop_seconds": float(wait.group(2)) if wait else None,
        "loss": {str(s): [ours.get(s), jax.get(s)] for s in CHECK_STEPS},
        "wer": [result["wer"], jax_eval["wer"]],
        "cer": [result["cer"], jax_eval["cer"]],
        "eval_utterances": result["utterances"],
        "eval_seconds": time.perf_counter() - t1,
    }
    for s in CHECK_STEPS:
        print(f"micro-step {s}: loss {ours.get(s)} (JAX {jax.get(s)})")
    print(f"WER {result['wer']:.4%} CER {result['cer']:.4%} over {result['utterances']} "
          f"(JAX {jax_eval['wer']:.4%} / {jax_eval['cer']:.4%})")
    if wait:
        print(f"data wait {summary['data_wait_seconds']:.1f} s of "
              f"{summary['train_loop_seconds']:.1f} s in the training loop")
    with open(os.path.join(args.out, "parity.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
