"""The first leg of the JAX package's synthetic training run, or its
pretraining recipe and the Stage-2 fine-tune, replayed by the port and
held against that run's records.

    python -m velocity_asr_tpu_torch.parity_run --out DIR [--steps 6000] \
        [--eval-utts 1000] [--num-workers 8] [--device cuda]
    python -m velocity_asr_tpu_torch.parity_run --pretrain --out DIR [--steps 6000] \
        [--eval-utts 1000] [--device cuda]

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

With ``--pretrain``: Stage 1 is ``configs/pretrain.yaml`` +
``model_synth.yaml`` through ``python -m velocity_asr_tpu_torch.pretrain``
(``checkpoints/pretrain_run``: 6,000 micro-steps at batch 32); Stage 2
``configs/finetune.yaml`` through ``train --init-from`` Stage 1's
``final_backbone`` (``checkpoints/finetune_pretrained``: the recipe's
3,000 micro-steps at 8 x 4 on 1,000 labelled utterances), then the fp32 evaluation above.
It prints Stage 1's interval mean loss at micro-steps 500, 1,000, 3,000
and 6,000 beside ``pretrain_run/metrics.jsonl``'s, and the WER and CER
beside ``finetune_pretrained/eval_fp32.json``'s, into
``DIR/pretrain_parity.json``.
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
PRETRAIN_METRICS = os.path.join(ROOT, "checkpoints", "pretrain_run", "metrics.jsonl")
FINETUNE_EVAL = os.path.join(ROOT, "checkpoints", "finetune_pretrained", "eval_fp32.json")


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


def run_cli(module: str, argv: List[str], log_path: str):
    """`python -m velocity_asr_tpu_torch.<module> argv` from the repo root,
    its output into log_path; (seconds, (data wait s, loop s) or None)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"velocity_asr_tpu_torch.{module}", *argv],
                          cwd=ROOT, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    with open(log_path, "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-6000:])
        raise SystemExit(f"{module} failed (exit {proc.returncode})")
    wait = re.search(r"data wait ([0-9.]+) s of ([0-9.]+) s", proc.stderr)
    return seconds, (float(wait.group(1)), float(wait.group(2))) if wait else None


def pretrain_leg(args, card: str) -> dict:
    """Stage 1 (the pretraining recipe) and Stage 2 (the fine-tune from its
    backbone, then the fp32 evaluation), against the JAX runs' records."""
    model_yaml = os.path.join(ROOT, "configs", "model_synth.yaml")
    common = ["--model-config", model_yaml, "--num-workers", str(args.num_workers),
              "--device", args.device]
    stage1 = os.path.join(args.out, "pretrain")
    s1, wait1 = run_cli("pretrain", ["--config", os.path.join(ROOT, "configs", "pretrain.yaml"),
                                     "--checkpoint-dir", stage1, "--max-steps", str(args.steps),
                                     *common], os.path.join(args.out, "pretrain.log"))
    stage2 = os.path.join(args.out, "finetune")
    s2, wait2 = run_cli("train", ["--config", os.path.join(ROOT, "configs", "finetune.yaml"),
                                  "--init-from", os.path.join(stage1, "final_backbone"),
                                  "--checkpoint-dir", stage2, *common],
                        os.path.join(args.out, "finetune.log"))
    ours, jax = interval_losses(os.path.join(stage1, "metrics.jsonl")), interval_losses(
        PRETRAIN_METRICS)
    ft_ours = interval_losses(os.path.join(stage2, "metrics.jsonl"))
    ft_jax = interval_losses(os.path.join(os.path.dirname(FINETUNE_EVAL), "metrics.jsonl"))
    t1 = time.perf_counter()
    result = evaluate_fp32(os.path.join(stage2, "final_pretrained"),
                           os.path.join(args.out, "corpus"), args.eval_utts, args.device)
    with open(FINETUNE_EVAL) as f:
        jax_eval = json.load(f)
    last = max(ft_ours) if ft_ours else None
    summary = {
        "card": card,
        "pretrain_steps": args.steps,
        "pretrain_seconds": s1,
        "pretrain_data_wait_seconds": wait1,
        "finetune_seconds": s2,
        "finetune_data_wait_seconds": wait2,
        "pretrain_loss": {str(s): [ours.get(s), jax.get(s)] for s in CHECK_STEPS},
        "finetune_loss_last": [last, ft_ours.get(last), ft_jax.get(last)],
        "wer": [result["wer"], jax_eval["wer"]],
        "cer": [result["cer"], jax_eval["cer"]],
        "eval_utterances": result["utterances"],
        "eval_seconds": time.perf_counter() - t1,
    }
    for s in CHECK_STEPS:
        print(f"pretraining micro-step {s}: loss {ours.get(s)} (JAX {jax.get(s)})")
    print(f"fine-tune micro-step {last}: loss {ft_ours.get(last)} (JAX {ft_jax.get(last)})")
    print(f"WER {result['wer']:.4%} CER {result['cer']:.4%} over {result['utterances']} "
          f"(JAX {jax_eval['wer']:.4%} / {jax_eval['cer']:.4%})")
    with open(os.path.join(args.out, "pretrain_parity.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", required=True, help="run directory (checkpoints, metrics)")
    parser.add_argument("--steps", type=int, default=6000, help="micro-steps")
    parser.add_argument("--pretrain", action="store_true",
                        help="the pretraining recipe and the Stage-2 fine-tune from it")
    parser.add_argument("--eval-utts", type=int, default=1000)
    parser.add_argument("--num-workers", type=int, default=8)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    card = card_line()
    print(card, flush=True)
    if args.pretrain:
        return pretrain_leg(args, card)

    config = os.path.join(args.out, "train_synth_b8x4.yaml")
    first_leg_yaml(os.path.join(ROOT, "configs", "train_synth.yaml"), config)
    train_s, wait = run_cli("train", [
        "--config", config, "--model-config", os.path.join(ROOT, "configs", "model_synth.yaml"),
        "--checkpoint-dir", args.out, "--max-steps", str(args.steps), "--lr-total-steps", "6000",
        "--num-workers", str(args.num_workers), "--device", args.device],
        os.path.join(args.out, "train.log"))

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
        "data_wait_seconds": wait[0] if wait else None,
        "train_loop_seconds": wait[1] if wait else None,
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
