#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (velocity_asr_tpu_torch).

    python3 chip_smoke.py [--utterances N]

Needs one CUDA card; exits non-zero without one. Phases, each printing
its seconds:

  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build the CUDA kernels (one nvcc call), with ptxas registers/spills;
  3. each kernel against its plain PyTorch version at the main path's
     shapes, from a numpy seed, with the stated tolerance;
  4. the main path: regenerate the first N held-out synthetic utterances
     (split "test", seed 1234) as WAVs in a temporary directory, load
     checkpoints/synth_run/final_pretrained, transcribe every WAV through
     the port's Transcriber, and hold the WER against the JAX package's
     WER over the same utterances (checkpoints/synth_run/eval_fp32_final.json);
     the launch counters must show 10 scan launches per forward and one
     log-mel launch per utterance; one utterance's logits on the card are
     held against the same model on the CPU in fp32;
  5. kernel timings (CUDA events) beside their bounds.

The line before the last is a JSON object listing the kernels; the last
line is {"ok": true, "device": {...}} and is printed only when every
phase passed.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "checkpoints", "synth_run", "final_pretrained")
JAX_EVAL = os.path.join(ROOT, "checkpoints", "synth_run", "eval_fp32_final.json")
BUDGET_S = 900.0  # fail, rather than run on, past this

# Tolerances (kernel against its plain version on the same inputs).
SCAN_MAX_REL = 1e-4  # max|kernel - plain| / max|plain|; fp32, other summation order
MEL_MAX_ABS = 1e-3  # on log-mel; fp32 FMAs against cuBLAS fp32 matmuls
WER_MAX_DIFF = 0.01  # port WER within 1.0 point of the JAX WER
LOGITS_FP32_MAX_ABS = 1e-2  # card against CPU, fp32 model, one utterance

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12

SCAN_SOURCE = "velocity_asr_tpu_torch/csrc/scan_fwd.cu"
MEL_SOURCE = "velocity_asr_tpu_torch/csrc/log_mel.cu"
SCAN_REPLACES = "velocity_asr_tpu/ops/scan_pallas.py:79"
MEL_REPLACES = "velocity_asr_tpu/ops/mel_pallas.py:74"


class PhaseFailed(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def run_phase(name, fn, t_start):
    t0 = time.perf_counter()
    try:
        out = fn()
    except Exception:
        traceback.print_exc()
        log(f"[phase] {name}: FAILED after {time.perf_counter() - t0:.3f} s")
        raise PhaseFailed(name)
    log(f"[phase] {name}: ok in {time.perf_counter() - t0:.3f} s")
    if time.perf_counter() - t_start > BUDGET_S:
        log(f"[phase] over the {BUDGET_S:.0f} s budget")
        raise PhaseFailed(name)
    return out


# ---------------------------------------------------------------- timing


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_cost(batch, length, d_inner, state_dim):
    """Bytes (each input read once, y written once) and operations
    (per (t, d, n): dt*A, exp, decay*h, B*u + ., C*h + . = 7)."""
    n_bytes = 4 * (3 * batch * length * d_inner + 2 * batch * length * state_dim + state_dim)
    n_ops = 7 * batch * length * d_inner * state_dim + batch * length * d_inner
    return n_bytes, n_ops


def mel_cost(n_frames, n_fft, n_freq, n_mels):
    n_bytes = 4 * (n_frames * n_fft + 2 * n_fft * n_freq + n_freq * n_mels + n_frames * n_mels)
    n_ops = n_frames * (4 * n_fft * n_freq + 3 * n_freq + 2 * n_freq * n_mels + 2 * n_mels)
    return n_bytes, n_ops


# ---------------------------------------------------------------- inputs


def scan_inputs(rng, length, state_dim, d_inner=384, batch=1):
    import torch

    x = rng.standard_normal((batch, length, d_inner)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((batch, length, d_inner)) - 1.0)).astype(np.float32)
    A = -np.arange(1, state_dim + 1, dtype=np.float32)
    B = rng.standard_normal((batch, length, state_dim)).astype(np.float32)
    C = rng.standard_normal((batch, length, state_dim)).astype(np.float32)
    return [torch.tensor(a, device="cuda") for a in (x, dt, A, B, C)]


def mel_inputs(rng, n_frames):
    """Frames of a seeded waveform framed as the main path frames it."""
    import torch

    from velocity_asr_tpu_torch.audio import HOP_LENGTH, N_FFT, frame_signal, reflect_pad

    audio = (rng.standard_normal((1, (n_frames - 1) * HOP_LENGTH)) * 0.1).astype(np.float32)
    audio_t = torch.tensor(audio, device="cuda")
    padded = reflect_pad(audio_t, N_FFT // 2)
    frames = frame_signal(padded, N_FFT, HOP_LENGTH)[0].contiguous()
    assert frames.shape[0] == n_frames
    return frames, padded


# ---------------------------------------------------------------- metrics


def _edit_distance(pred, ref) -> int:
    prev = list(range(len(ref) + 1))
    for i, p in enumerate(pred, start=1):
        cur = [i] + [0] * len(ref)
        for j, r in enumerate(ref, start=1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (p != r))
        prev = cur
    return prev[-1]


def error_rate(predictions, references, unit) -> float:
    """WER (unit="word") or CER (unit="char") over lowercased text, as the
    JAX package's training.compute_wer / compute_cer count them."""
    split = str.split if unit == "word" else list
    errors = total = 0
    for pred, ref in zip(predictions, references, strict=True):
        p, r = split(pred.lower()), split(ref.lower())
        errors += _edit_distance(p, r)
        total += len(r)
    return errors / total if total else 0.0


# ---------------------------------------------------------------- phases


def phase_card():
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    log(out[0])  # name, power limit: exactly as nvidia-smi prints them
    log(f"torch: {torch.__version__} cuda {torch.version.cuda}; "
        f"device 0: {torch.cuda.get_device_name(0)}; count {torch.cuda.device_count()}")
    return out[0]


def phase_build():
    from velocity_asr_tpu_torch.ops import cuda_lib

    lib = cuda_lib.library()
    log(f"kernel build: {lib.build_seconds:.3f} s (one nvcc call) -> {os.path.relpath(lib.path, ROOT)}")
    for line in lib.build_log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def phase_compare():
    import torch

    from velocity_asr_tpu_torch.ops.mel import _device_matrices, log_mel, log_mel_plain
    from velocity_asr_tpu_torch.ops.scan import scan_fwd, scan_fwd_plain

    rng = np.random.default_rng(20261017)
    errs = {"scan_fwd": 0.0, "log_mel": 0.0}
    # local blocks (N=64, L = bucket/2) and global blocks (N=32, L = the
    # level-1 pool size, 64 at every bucket up to 1024 frames); N=16 is
    # the third state size the kernel is built for (the "tiny" preset)
    cases = [(64, 100), (64, 300), (32, 64), (32, 100), (32, 300), (16, 100)]
    for state_dim, length in cases:
        args = scan_inputs(rng, length, state_dim)
        ker = scan_fwd(*args)
        torch.cuda.synchronize()
        ref = scan_fwd_plain(*args)
        max_abs = (ker - ref).abs().max().item()
        max_rel = max_abs / ref.abs().max().item()
        ok = math.isfinite(max_rel) and max_rel <= SCAN_MAX_REL
        log(f"scan N={state_dim} L={length} D=384: max_abs {max_abs:.3e} "
            f"max_rel {max_rel:.3e} (tol rel {SCAN_MAX_REL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("scan kernel disagrees with its plain version")
        errs["scan_fwd"] = max(errs["scan_fwd"], max_abs)
    mats = _device_matrices(torch.device("cuda"), 400, 80, 16000)
    for n_frames in (200, 600):
        frames, _ = mel_inputs(rng, n_frames)
        ker = log_mel(frames, *mats)
        torch.cuda.synchronize()
        ref = log_mel_plain(frames, *mats)
        max_abs = (ker - ref).abs().max().item()
        max_rel = ((ker - ref).abs() / ref.abs().clamp_min(1e-6)).max().item()
        ok = math.isfinite(max_abs) and max_abs <= MEL_MAX_ABS
        log(f"log_mel T={n_frames}: max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
            f"(tol abs {MEL_MAX_ABS:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("log-mel kernel disagrees with its plain version")
        errs["log_mel"] = max(errs["log_mel"], max_abs)
    torch.cuda.synchronize()
    return errs


def phase_main_path(n_utts: int):
    import torch

    from velocity_asr_tpu_torch import synth
    from velocity_asr_tpu_torch.audio import load_audio
    from velocity_asr_tpu_torch.ops.cuda_lib import launch_counts, reset_launch_counts
    from velocity_asr_tpu_torch.transcribe import load_transcriber

    tmp = tempfile.mkdtemp(prefix="velocity_asr_smoke_")
    try:
        t0 = time.perf_counter()
        manifest = synth.write_corpus(tmp, n_utts, split="test", seed=1234)
        with open(manifest) as f:
            rows = [json.loads(line) for line in f]
        log(f"corpus: {len(rows)} utterances in {time.perf_counter() - t0:.3f} s")

        t0 = time.perf_counter()
        tr = load_transcriber(CHECKPOINT, device="cuda")
        cfg = tr.model.config
        log(f"checkpoint: {os.path.relpath(CHECKPOINT, ROOT)} d_model {cfg.d_model} "
            f"layers {cfg.ssm_layers}+{cfg.global_ssm_layers} dtype {cfg.dtype} "
            f"scan_mode {cfg.scan_mode} in {time.perf_counter() - t0:.3f} s")

        # Warm up outside the counted run (allocator, cuBLAS handles).
        tr.transcribe_file(rows[0]["audio_path"])
        torch.cuda.synchronize()

        reset_launch_counts()
        t0 = time.perf_counter()
        preds = [tr.transcribe_file(r["audio_path"])["text"] for r in rows]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dict(launch_counts)
        buckets = collections.Counter(
            tr.frame_bucket_of(load_audio(r["audio_path"])) for r in rows)

        refs = [r["text"] for r in rows]
        wer, cer = error_rate(preds, refs, "word"), error_rate(preds, refs, "char")
        with open(JAX_EVAL) as f:
            jax_rows = json.load(f)["results"][:n_utts]
        if [r["reference"] for r in jax_rows] != refs:
            raise AssertionError("regenerated references differ from the JAX eval's")
        jax_preds = [r["prediction"] for r in jax_rows]
        jax_wer = error_rate(jax_preds, refs, "word")
        jax_cer = error_rate(jax_preds, refs, "char")
        same = sum(p == q for p, q in zip(preds, jax_preds))
        log(f"main path: {n_utts} utterances in {seconds:.3f} s "
            f"({seconds / n_utts * 1e3:.3f} ms/utterance); buckets {dict(sorted(buckets.items()))}")
        log(f"WER {wer * 100:.4f}% CER {cer * 100:.4f}% | JAX (eval_fp32_final.json, same "
            f"{n_utts}) WER {jax_wer * 100:.4f}% CER {jax_cer * 100:.4f}% | "
            f"identical transcripts {same}/{n_utts}")
        log(f"launches: {counts}; per forward: scan {counts.get('scan_fwd_f32', 0) / n_utts:g}, "
            f"log_mel {counts.get('log_mel_f32', 0) / n_utts:g}")
        if counts.get("scan_fwd_f32", 0) != 10 * n_utts:
            raise AssertionError("expected 10 scan launches per forward")
        if counts.get("log_mel_f32", 0) != n_utts:
            raise AssertionError("expected 1 log-mel launch per utterance")
        if abs(wer - jax_wer) > WER_MAX_DIFF:
            raise AssertionError(f"WER {wer:.4f} is more than {WER_MAX_DIFF} from JAX {jax_wer:.4f}")

        # One utterance's logits: finite, of the expected shape, and the
        # card's fp32 model against the same model on the CPU.
        audio = load_audio(rows[0]["audio_path"])
        padded, n_frames = tr._pad_audio(audio)
        wire = torch.from_numpy(tr._to_wire(padded))
        logits = tr.masked_logits(wire.cuda(), n_frames)
        want = (1, (1 + padded.shape[1] // 160 + 1) // 2, cfg.vocab_size)
        if tuple(logits.shape) != want or not torch.isfinite(logits).all():
            raise AssertionError(f"logits {tuple(logits.shape)} (want {want}) or not finite")
        out_len = (n_frames + 1) // 2
        f32 = [load_transcriber(CHECKPOINT, device=d, dtype="float32") for d in ("cuda", "cpu")]
        lg = [t.masked_logits(wire.to(t.device), n_frames)[:, :out_len].cpu() for t in f32]
        max_abs = (lg[0] - lg[1]).abs().max().item()
        agree = (lg[0].argmax(-1) == lg[1].argmax(-1)).float().mean().item()
        log(f"fp32 logits card vs CPU (utterance 0, {out_len} frames): max_abs {max_abs:.3e} "
            f"(tol {LOGITS_FP32_MAX_ABS:g}), argmax agreement {agree:.4f}")
        if not max_abs <= LOGITS_FP32_MAX_ABS:
            raise AssertionError("card logits disagree with the CPU")
        return counts, buckets.most_common(1)[0][0]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_timing(counts, bucket: int, errs):
    import torch

    from velocity_asr_tpu_torch.audio import mel_filterbank
    from velocity_asr_tpu_torch.ops.mel import _device_matrices, log_mel, log_mel_plain
    from velocity_asr_tpu_torch.ops.pooling import pool_size_level1
    from velocity_asr_tpu_torch.ops.scan import scan_fwd, scan_fwd_plain

    rng = np.random.default_rng(7)
    local_len = bucket // 2
    rows = []
    for state_dim, length in ((64, local_len), (32, pool_size_level1(local_len))):
        args = scan_inputs(rng, length, state_dim)
        ms = cuda_time_ms(lambda: scan_fwd(*args), iters=50)
        plain = cuda_time_ms(lambda: scan_fwd_plain(*args), iters=5, warmup=1)
        b_ms, b_by = bound_ms(*scan_cost(1, length, 384, state_dim))
        log(f"time scan N={state_dim} L={length} D=384: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bound {b_ms:.5f} ms ({b_by})")
        rows.append((ms, plain, b_ms, b_by))

    frames, padded = mel_inputs(rng, bucket)
    mats = _device_matrices(torch.device("cuda"), 400, 80, 16000)
    mel_ms = cuda_time_ms(lambda: log_mel(frames, *mats), iters=50)
    mel_plain = cuda_time_ms(lambda: log_mel_plain(frames, *mats), iters=50)
    window = torch.hann_window(400, device="cuda")
    fb = torch.tensor(mel_filterbank(), device="cuda")

    def library():
        spec = torch.stft(padded[0], 400, 160, window=window, center=False, return_complex=True)
        return torch.log(fb @ spec.abs().square() + 1e-10)

    lib_ms = cuda_time_ms(library, iters=50)
    lib_err = (library().T - log_mel(frames, *mats)).abs().max().item()
    mb_ms, mb_by = bound_ms(*mel_cost(bucket, 400, 201, 80))
    log(f"time log_mel T={bucket}: kernel {mel_ms:.4f} ms, plain {mel_plain:.4f} ms, "
        f"library (stft+power+fb+log) {lib_ms:.4f} ms (max_abs vs kernel {lib_err:.3e}), "
        f"bound {mb_ms:.5f} ms ({mb_by})")

    scan_ms, scan_plain, scan_b, scan_by = rows[0]
    return {"kernels": [
        {"name": "scan_fwd", "route": "cuda", "source": SCAN_SOURCE,
         "replaces": SCAN_REPLACES, "launches": counts.get("scan_fwd_f32", 0),
         "max_abs_err": errs["scan_fwd"], "ms": scan_ms, "plain_ms": scan_plain,
         "bound_ms": scan_b, "bound_by": scan_by, "library_ms": None},
        {"name": "log_mel", "route": "cuda", "source": MEL_SOURCE,
         "replaces": MEL_REPLACES, "launches": counts.get("log_mel_f32", 0),
         "max_abs_err": errs["log_mel"], "ms": mel_ms, "plain_ms": mel_plain,
         "bound_ms": mb_ms, "bound_by": mb_by, "library_ms": lib_ms},
    ]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--utterances", type=int, default=200,
                        help="held-out utterances on the main path (default 200)")
    args = parser.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from velocity_asr_tpu_torch.device import resolve_device

    resolve_device("cuda")  # also turns TF32 off for matmuls and convolutions

    try:
        run_phase("1 card", phase_card, t_start)
        run_phase("2 build", phase_build, t_start)
        errs = run_phase("3 kernels vs plain", phase_compare, t_start)
        counts, bucket = run_phase(
            "4 main path", lambda: phase_main_path(args.utterances), t_start)
        kernels = run_phase(
            "5 timing", lambda: phase_timing(counts, bucket, errs), t_start)
    except PhaseFailed as e:
        print(f"chip_smoke: phase {e} failed", file=sys.stderr)
        return 1
    log(f"total: {time.perf_counter() - t_start:.3f} s")
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
