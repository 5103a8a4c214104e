"""Export a VELOCITY-ASR checkpoint with the port (scripts/export_model.py).

    python -m velocity_asr_tpu_torch.export_model --checkpoint DIR \
        [--output-dir ./export] [--frames 500] [--batch 1] [--quantize] \
        [--calibrate {MANIFEST|synthetic} [--calibrate-batches 16] \
         [--calibrate-batch-size 4]] [--verify] [--device cuda]

Writes ``velocity_asr.pt2`` (``export.export_program`` at (batch, frames,
mel_bins)) and, with ``--quantize`` or ``--calibrate``, the int8 package
``int8/`` (``export.save_int8_checkpoint``). ``--calibrate`` first
calibrates static int8 activation scales over a JSONL manifest, or over
the synthetic corpus's "calib" split with ``synthetic``, batches padded
to multiples of 200 frames; the package then loads with the static int8
path on. ``--verify`` runs the exported program on a seeded random mel
and compares it with the live model: max |live - exported| within 1e-3
(fp32 checkpoint) or 0.3 (bf16) and argmax agreement at least 0.99, or
it exits non-zero. ``--tflite`` exits non-zero: there is no TFLite
converter for the port. It runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time
from typing import List, Optional

import numpy as np
import torch

from .checkpoint import params_to_numpy
from .data import ASRCollator, ASRDataset, calibration_batches
from .device import resolve_device
from .export import export_program, load_exported, save_int8_checkpoint
from .models.model import _empty_model, forward, from_pretrained
from .quantize import calibrate_int8_model, get_model_size_mb, quant_stats_to_numpy
from .synth import SyntheticSpeechDataset

logger = logging.getLogger("velocity_asr_tpu_torch.export_model")

VERIFY_MAX_ABS = {"float32": 1e-3, "bfloat16": 0.3}
VERIFY_MIN_AGREE = 0.99


def calibrated_model(model, source: str, batches: int, batch_size: int):
    """A static-int8 copy of `model`, calibrated over `batches` batches of
    `batch_size` utterances from a manifest or the synthetic corpus."""
    if source == "synthetic":
        ds = SyntheticSpeechDataset(batches * batch_size, split="calib", seed=1234)
    else:
        ds = ASRDataset(source, max_duration=None, min_duration=0.0)
    static = _empty_model(dataclasses.replace(model.config, int8_inference=True,
                                              int8_static=True),
                          next(model.parameters()).device)
    static.load_state_dict(model.state_dict(), strict=True)
    collator = ASRCollator(frame_bucket=200, target_bucket=1)
    return calibrate_int8_model(static, calibration_batches(ds, collator, batch_size, batches),
                                num_batches=batches)


def verify(model, program_path: str, shape) -> dict:
    """The exported program against the live model on one seeded random
    mel; raises SystemExit past the bounds."""
    device = next(model.parameters()).device
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(shape).astype(np.float32))
    live = forward(model, mel.to(device)).cpu()
    with torch.inference_mode():
        exported = load_exported(program_path)(mel.to(device)).cpu()
    diff = (live - exported).abs().max().item()
    agree = (live.argmax(-1) == exported.argmax(-1)).float().mean().item()
    bound = VERIFY_MAX_ABS[model.config.dtype]
    logger.info("Verification max |live - exported| = %.2e (bound %g), argmax agreement %.4f",
                diff, bound, agree)
    if diff > bound or agree < VERIFY_MIN_AGREE:
        raise SystemExit("verification failed")
    logger.info("Verification OK")
    return {"max_abs": diff, "argmax_agreement": agree}


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description="Export a VELOCITY-ASR model (PyTorch port)")
    parser.add_argument("--checkpoint", required=True, help="pretrained checkpoint dir")
    parser.add_argument("--output-dir", default="./export")
    parser.add_argument("--frames", type=int, default=500, help="export frame count")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--quantize", action="store_true", help="also write the int8 package")
    parser.add_argument("--calibrate", default=None,
                        help="calibrate static int8 activation scales over a JSONL manifest, "
                             "or 'synthetic' for the synthetic corpus (implies --quantize)")
    parser.add_argument("--calibrate-batches", type=int, default=16)
    parser.add_argument("--calibrate-batch-size", type=int, default=4)
    parser.add_argument("--verify", action="store_true", help="reload and compare outputs")
    parser.add_argument("--tflite", nargs="?", const="fp32", default=None,
                        choices=["fp32", "dynamic", "float16"],
                        help="not available: the port has no TFLite converter")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(levelname)s | %(message)s")
    if args.tflite:
        # refused, not skipped: the user asked for an artifact this cannot write
        raise SystemExit("--tflite: the PyTorch port has no TFLite converter "
                         "(ai_edge_torch is not available); export the .pt2 program or "
                         "use the JAX package's scripts/export_model.py --tflite")
    device = resolve_device(args.device)
    model = from_pretrained(args.checkpoint, device=device)
    os.makedirs(args.output_dir, exist_ok=True)
    shape = (args.batch, args.frames, model.config.mel_bins)
    out = {}

    t0 = time.perf_counter()
    program = export_program(model, os.path.join(args.output_dir, "velocity_asr.pt2"), shape)
    out["export_seconds"] = time.perf_counter() - t0
    logger.info("torch.export program: %s (%.2f MB) in %.3f s; fp32 weights %.2f MB",
                program, os.path.getsize(program) / 1e6, out["export_seconds"],
                get_model_size_mb(model))

    if args.quantize or args.calibrate:
        stats = None
        if args.calibrate:
            stats = calibrated_model(model, args.calibrate, args.calibrate_batches,
                                     args.calibrate_batch_size)
            logger.info("Calibrated static int8 activation scales over %d batches",
                        args.calibrate_batches)
        int8_dir = os.path.join(args.output_dir, "int8")
        info = save_int8_checkpoint(int8_dir, model.config, params_to_numpy(model),
                                    None if stats is None else quant_stats_to_numpy(stats))
        logger.info("INT8 package: %s (%d tensors, %.2f MB -> %.2f MB%s)", int8_dir,
                    info["quantized_tensors"], info["fp32_mb"], info["int8_mb"],
                    ", calibrated" if info.get("calibrated") else "")
        out["int8"] = info

    if args.verify:
        out["verify"] = verify(model, program, shape)
    return out


if __name__ == "__main__":
    main()
