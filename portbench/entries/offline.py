"""Offline batched transcription: a closed loop of one caller driving
``Transcriber.transcribe_batch``, the port's batched greedy path (the
server's micro-batches call the same method).

Set-up builds the program at the configuration's widths with the seed's
weights on the card, makes the seed's PCM pool and batches, and warms up
one call per frame bucket the batches use. The window then sends the
cycle's batches one after another until ``seconds`` have passed; each
call is timed from the call until its texts are back. A traced run
profiles the window's first whole cycle (the profiler is started before
the window opens; a traced run reports no end-to-end metric).

Once the window has closed and the peak memory is read, the program is
freed and the plain reference judges a sample of the calls that
finished: a seeded reservoir of ``sample_calls`` calls plus the last
call of the cycle's longest bucket, every row of each. A row's number is
the widest gap by which the reference's logit of a served token lies
below its best (``reference.judge.alignment_gaps``); the control
(``control``: the reference with fp8 weight products in the program's
place) reads the gap of its own per-frame argmax instead
(``argmax_gaps``).
"""

from __future__ import annotations

import contextlib
import math
import resource
import sys
import time

import numpy as np
import torch

from portbench import generator
from portbench import trace as tracing
from portbench.reference import frontend, judge
from portbench.reference import model as reference

KIND = "offline"
SPACE = 3  # the vocabulary's space token


def build_program(keys: dict, seed: int, device):
    """The port's model at the configuration's widths, its parameters the
    seed's (``reference.make_params``, drawn on the card), in eval mode."""
    from velocity_asr_tpu_torch.models.config import VelocityASRConfig
    from velocity_asr_tpu_torch.models.model import VelocityASR

    cfg = VelocityASRConfig.from_dict(keys)
    with torch.device("meta"):
        model = VelocityASR(cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(reference.make_params(keys, seed, device), strict=True)
    return model.eval()


def nearest_rank(values, q: float) -> float:
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def run(spec: dict, seed: int, seconds: float, trace: bool, device, t0: float,
        control=None) -> dict:
    from velocity_asr_tpu_torch.decode import CTCDecoder, create_default_vocabulary
    from velocity_asr_tpu_torch.transcribe import Transcriber

    keys, mix = spec["config"], spec["mix"]
    cuda = torch.device(device).type == "cuda"
    phases = [("start", time.perf_counter() - t0)]
    model = build_program(keys, seed, device)
    transcriber = Transcriber(model, CTCDecoder(create_default_vocabulary(keys["vocab_size"])),
                              frame_bucket=mix["frame_bucket"])
    pool = generator.pcm_pool(mix, seed)
    audio = pool.astype(np.float32) / np.float32(32768.0)   # exact: int16 / 2^15
    calls = generator.place(generator.make_batches(mix, seed), len(pool), seed)
    cycle = len(calls)
    phases.append(("program and traffic", time.perf_counter() - t0))

    def batch(i):
        return [audio[o:o + n] for o, n in calls[i]["rows"]]

    for frames in sorted({c["frames"] for c in calls}):          # warm-up
        transcriber.transcribe_batch(batch(next(i for i, c in enumerate(calls)
                                                if c["frames"] == frames)))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    phases.append(("warm-up", time.perf_counter() - t0))
    print(f"portbench: set-up phases (s from start) {phases}", file=sys.stderr)

    longest = max(range(cycle), key=lambda i: calls[i]["frames"])
    rng = np.random.default_rng([seed % (1 << 64), 3])
    kept, last_longest = [], None
    lat, attempted, failed, audio_s = [], 0, 0, 0.0
    prof, span, slice_calls, slice_at, slice_sys = None, None, [], None, None
    if trace:  # the profiler starts before the window and covers its first cycle
        prof = tracing.start()
        span = torch.profiler.record_function(tracing.SLICE)
        span.__enter__()
    usage = resource.getrusage(resource.RUSAGE_SELF)
    t_start = time.perf_counter()
    setup_s = t_start - t0
    i = 0
    while True:
        c = i % cycle
        rows = calls[c]["rows"]
        t1 = time.perf_counter()
        try:
            with (torch.profiler.record_function(tracing.CALL) if prof is not None
                  else contextlib.nullcontext()):
                texts = [r["text"] for r in transcriber.transcribe_batch(batch(c))]
        except Exception as exc:  # a failed call counts as missing
            print(f"portbench: call {i} failed: {exc!r}", file=sys.stderr)
            texts = None
        t2 = time.perf_counter()
        attempted += len(rows)
        if texts is None or len(texts) != len(rows):
            failed += len(rows)
            lat.append(math.inf)
        else:
            lat.append(t2 - t1)
            audio_s += sum(n for _, n in rows) / generator.SAMPLE_RATE
            done = len(lat) - 1
            if len(kept) < mix["sample_calls"]:
                kept.append((c, texts))
            elif (j := int(rng.integers(0, done + 1))) < mix["sample_calls"]:
                kept[j] = (c, texts)
            if c == longest:
                last_longest = (c, texts)
        if prof is not None:
            slice_calls.append({"frames": calls[c]["frames"], "rows": [n for _, n in rows]})
            if len(slice_calls) == cycle:
                span.__exit__(None, None, None)
                prof.__exit__(None, None, None)
                slice_at, prof = prof, None
                slice_sys = tracing.host_system(usage, t_start)
        i += 1
        if t2 - t_start >= seconds:
            break
    window = t2 - t_start
    done = resource.getrusage(resource.RUSAGE_SELF)
    print(f"portbench: window {window:.3f} s, {len(lat)} calls, p95 "
          f"{1000.0 * nearest_rank(lat, 0.95):.3f} ms; host user "
          f"{done.ru_utime - usage.ru_utime:.3f} s, system {done.ru_stime - usage.ru_stime:.3f} s",
          file=sys.stderr)
    if prof is not None:  # the window ended inside the slice
        span.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        slice_at = prof
        slice_sys = tracing.host_system(usage, t_start)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    samples = dict(kept)
    if last_longest is not None:
        samples[last_longest[0]] = last_longest[1]
    del transcriber, model
    if cuda:
        torch.cuda.empty_cache()

    tr = None
    if slice_at is not None:
        tr = tracing.reduce(slice_at, KIND, keys, slice_calls)
        if tr is not None:
            tr.host_system_s, tr.host_wall_s = slice_sys
    readings = judge_samples(keys, seed, device, pool, calls, samples, control)
    readings["failed_requests"] = failed
    checks, correct = held(readings, spec["limits"])
    checks = {"failed_requests": {"value": failed, "limit": 0}, **checks}
    correct = correct and failed == 0 and bool(samples)
    e2e = {"audio_s_per_s": audio_s / window, "setup_s": setup_s}
    return {"correct": correct, "attempted": attempted, "failed": failed, "e2e": e2e,
            "checks": checks, "readings": readings, "memory_peak_bytes": peak, "trace": tr,
            "calls": len(lat), "window_wall_s": window}


def held(readings: dict, limits: dict):
    """(checks, all within): every reading that has a limit, beside it;
    a missing or null limit fails (a cell is not correct until its limits
    are set)."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name, math.inf)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and value <= limit
    return checks, ok


def greedy_ids(logits: torch.Tensor, n_out) -> list:
    """Each row's greedy CTC tokens over its valid frames."""
    out = []
    for r, t_len in enumerate(n_out):
        best = logits[r, :t_len].argmax(-1)
        keep = (best != judge.BLANK) & torch.cat([best.new_ones(1, dtype=torch.bool),
                                                   best[1:] != best[:-1]])
        out.append(best[keep].tolist())
    return out


@torch.no_grad()
def judge_samples(keys, seed, device, pool, calls, samples, control) -> dict:
    """The reference over every sampled call, fp32 with TF32 off, and the
    readings over all their rows' valid frames: ``worst_gap`` (the widest
    gap of a served token below the reference's best), ``mean_gap`` and
    ``mean_sq_gap`` (the summed gap and squared gap of the closest paths,
    over the frames). With ``control`` the reference with fp8 weight
    products (``reference.model.fp8_products``) stands in the program's
    place: its per-frame argmax (``frame_*``) and its greedy tokens as if
    served (the same three) are read instead of the served texts."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = reference.make_params(keys, seed, device)
    vocab = frontend.default_vocabulary(keys["vocab_size"])
    served, framewise, frames, tokens = [], [], 0, 0
    for c, texts in sorted(samples.items()):
        rows, n_mel = calls[c]["rows"], calls[c]["frames"]
        pcms = [pool[o:o + n] for o, n in rows]
        mel = frontend.normalized_mel(pcms, n_mel, device)
        logits = reference.forward(params, keys, mel)
        n_out = [(frontend.valid_frames(n) + 1) // 2 for _, n in rows]
        frames += sum(n_out)
        if control:
            with reference.fp8_products():
                low = reference.forward(params, keys, mel)
            framewise.append(judge.argmax_gaps(logits, low, n_out))
            ids = greedy_ids(low, n_out)
        else:
            ids = [frontend.text_to_ids(t, vocab) for t in texts]
        ok = [i for i, x in enumerate(ids) if x is not None]
        g = torch.full((len(rows), 3), math.inf, dtype=torch.float64)
        if ok:
            g[ok] = judge.alignment_gaps(logits[ok], [n_out[i] for i in ok],
                                         [ids[i] for i in ok], SPACE)
        tokens += sum(len(x) for x in ids if x is not None)
        served.append(g)
    g = torch.cat(served) if served else torch.full((1, 3), math.inf, dtype=torch.float64)
    out = {"worst_gap": float(g[:, 0].max()), "mean_gap": float(g[:, 1].sum()) / max(frames, 1),
           "mean_sq_gap": float(g[:, 2].sum()) / max(frames, 1)}
    if framewise:
        f = torch.cat(framewise)
        out.update(frame_worst_gap=float(f[:, 0].max()),
                   frame_mean_gap=float(f[:, 1].sum()) / frames,
                   frame_mean_sq_gap=float(f[:, 2].sum()) / frames)
    print(f"portbench: judged {g.shape[0]} rows, {frames} frames, {tokens} served tokens; "
          f"readings {out}", file=sys.stderr)
    return out
