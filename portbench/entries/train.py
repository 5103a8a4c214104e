"""Training under a recipe: ``Trainer.train_step`` over batches collated
by the port's own PCM collation (``data.ASRCollator``: int16 PCM padded
to the batch's longest frame bucket; the log-mel runs on the card).

Set-up builds the program at the configuration's widths with the seed's
weights on the card and one ``Trainer`` under the mix's recipe, then
drives that same trainer through its first steps: the first
``checked_steps`` on the cycle's first batches (their losses, the first
gradient as the optimizer holds it and the parameters after them are
kept for the comparison), then one step on a batch of every other frame
bucket the cycle uses, so the window compiles and allocates nothing new.
The window then steps through the cycle until ``seconds`` have passed. A
traced run profiles the window's first whole cycle.

Once the window has closed, the peak memory is read and the program is
freed, the plain reference (``reference.train``) follows the same first
steps from the same weights and draws, and the run is held to it:
``loss_gap`` (the widest relative gap of a step's loss), ``grad_gap``
(the worst leaf's gap between the norms of the first clipped gradient)
and ``change_gap`` (the worst moving leaf's gap between the norms of the
parameters' change over the checked steps); a leaf whose reference
gradient is under a thousandth of the median leaf's is left out of the
change. A control run (``control``) puts the reference with fp8 weight
products in the program's place.
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
from portbench.entries.offline import held
from portbench.reference import model as reference
from portbench.reference import train as ref_train

KIND = "train"
B1 = 0.9  # Adam's first-moment decay: mu after one update is (1 - B1) g


def build_trainer(keys: dict, mix: dict, seed: int, device):
    """The port's model with the seed's weights, under a Trainer of the
    mix's recipe (one rank), and its collator."""
    from velocity_asr_tpu_torch.augment import SpecAugmentConfig
    from velocity_asr_tpu_torch.data import ASRCollator
    from velocity_asr_tpu_torch.models.config import VelocityASRConfig
    from velocity_asr_tpu_torch.models.model import VelocityASR
    from velocity_asr_tpu_torch.training import Trainer, TrainingConfig

    r = mix["recipe"]
    cfg = VelocityASRConfig.from_dict(keys)
    with torch.device("meta"):
        model = VelocityASR(cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(reference.make_params(keys, seed, device), strict=True)
    config = TrainingConfig(learning_rate=r["learning_rate"], weight_decay=r["weight_decay"],
                            warmup_steps=r["warmup_steps"], max_steps=r["max_steps"],
                            grad_clip_norm=r["grad_clip_norm"], batch_size=mix["batch"],
                            gradient_accumulation_steps=r["gradient_accumulation_steps"],
                            use_amp=r["use_amp"], augment=SpecAugmentConfig(**r["augment"]),
                            num_data_shards=1)
    trainer = Trainer(model, config, iter(()), seed=seed)
    return trainer, ASRCollator(frame_bucket=mix["frame_bucket"])


def run(spec: dict, seed: int, seconds: float, trace: bool, device, t0: float,
        control=None) -> dict:
    keys, mix = spec["config"], spec["mix"]
    cuda = torch.device(device).type == "cuda"
    phases = [("start", time.perf_counter() - t0)]
    trainer, collate = build_trainer(keys, mix, seed, device)
    pool = generator.pcm_pool(mix, seed)
    audio = pool.astype(np.float32) / np.float32(32768.0)   # exact: int16 / 2^15
    shapes = generator.make_batches(mix, seed)
    calls = generator.place(shapes, len(pool), seed)
    tokens = generator.targets(mix, shapes, seed)
    cycle = len(calls)

    def batch(i):
        items = []
        for (o, n), tgt in zip(calls[i]["rows"], tokens[i]):
            items.append({"audio": audio[o:o + n], "targets": tgt,
                          "input_lengths": np.int32(1 + n // generator.HOP),
                          "target_lengths": np.int32(len(tgt))})
        return collate(items)

    phases.append(("program and traffic", time.perf_counter() - t0))
    checked = mix["checked_steps"]
    names = [n for n, _ in trainer.model.named_parameters()]
    losses, first_grad = [], None
    for i in range(checked):
        losses.append(trainer.train_step(batch(i))["loss"])
        if i == 0:
            first_grad = {n: m.detach() / (1.0 - B1) for n, m in zip(names, trainer.optimizer.mu)}
            first_grad = {n: g.clone() for n, g in first_grad.items()}
    after = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    phases.append(("checked steps", time.perf_counter() - t0))
    seen = {calls[i]["frames"] for i in range(checked)}
    for i in range(checked, cycle):                                # warm-up
        if calls[i]["frames"] not in seen:
            trainer.train_step(batch(i))
            seen.add(calls[i]["frames"])
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    phases.append(("warm-up", time.perf_counter() - t0))
    print(f"portbench: set-up phases (s from start) {phases}", file=sys.stderr)

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
                loss = trainer.train_step(batch(c))["loss"]
            ok = math.isfinite(loss)
        except Exception as exc:  # a failed step counts as missing
            print(f"portbench: step {i} failed: {exc!r}", file=sys.stderr)
            ok = False
        t2 = time.perf_counter()
        attempted += 1
        if ok:
            lat.append(t2 - t1)
            audio_s += sum(n for _, n in rows) / generator.SAMPLE_RATE
        else:
            failed += 1
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
    print(f"portbench: window {window:.3f} s, {len(lat)} calls; host user "
          f"{done.ru_utime - usage.ru_utime:.3f} s, system {done.ru_stime - usage.ru_stime:.3f} s",
          file=sys.stderr)
    if prof is not None:  # the window ended inside the slice
        span.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        slice_at = prof
        slice_sys = tracing.host_system(usage, t_start)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del trainer
    if cuda:
        torch.cuda.empty_cache()

    tr = None
    if slice_at is not None:
        tr = tracing.reduce(slice_at, KIND, keys, slice_calls)
        if tr is not None:
            tr.host_system_s, tr.host_wall_s = slice_sys
    refs = [{"pcm": [pool[o:o + n] for o, n in calls[i]["rows"]], "frames": calls[i]["frames"],
             "targets": pad_targets(tokens[i]),
             "target_lengths": torch.tensor([len(t) for t in tokens[i]])}
            for i in range(checked)]
    readings = compare(keys, mix["recipe"], seed, device, refs, losses, first_grad, after,
                       fp8=bool(control))
    readings["failed_steps"] = failed
    checks, correct = held(readings, spec["limits"])
    checks = {"failed_steps": {"value": failed, "limit": 0}, **checks}
    e2e = {"train_audio_s_per_s": audio_s / window, "setup_s": setup_s}
    return {"correct": correct and failed == 0, "attempted": attempted, "failed": failed,
            "e2e": e2e, "checks": checks, "readings": readings, "memory_peak_bytes": peak,
            "trace": tr, "calls": len(lat), "window_wall_s": window}


def pad_targets(rows) -> torch.Tensor:
    out = torch.zeros(len(rows), max(len(r) for r in rows), dtype=torch.int64)
    for i, r in enumerate(rows):
        out[i, :len(r)] = torch.from_numpy(r.astype(np.int64))
    return out


def compare(keys, recipe, seed, device, batches, losses, first_grad, after,
            fp8: bool = False) -> dict:
    """The reference through the checked steps, fp32 with TF32 off, and
    the readings of the program's steps against it; with `fp8` the
    reference with fp8 weight products stands in the program's place."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params0 = reference.make_params(keys, seed, device)
    ref = ref_train.run_steps(params0, keys, recipe, batches, seed)
    if fp8:
        with reference.fp8_products():
            low = ref_train.run_steps(params0, keys, recipe, batches, seed)
        losses, first_grad, after = low["losses"], low["first_grad"], low["params"]
    grad_ref = ref_train.norms(ref["first_grad"])
    moving = ref_train.moving_leaves(grad_ref)
    grad = ref_train.leaf_gaps(ref_train.norms(first_grad), grad_ref)
    change = ref_train.leaf_gaps(ref_train.changed(after, params0),
                                 ref_train.changed(ref["params"], params0), moving)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    worst_grad = max(grad, key=grad.get)
    worst_change = max(change, key=change.get)
    left = sorted(set(grad) - set(moving))
    print(f"portbench: losses {losses} reference {ref['losses']}; worst gradient leaf "
          f"{worst_grad} {grad[worst_grad]!r}, median {float(np.median(list(grad.values())))!r}; "
          f"worst change leaf {worst_change} {change[worst_change]!r}, median "
          f"{float(np.median(list(change.values())))!r}; left out of the change: {left}",
          file=sys.stderr)
    return {"loss_gap": loss_gap, "grad_gap": grad[worst_grad],
            "change_gap": change[worst_change],
            "median_grad_gap": float(np.median(list(grad.values()))),
            "median_change_gap": float(np.median(list(change.values())))}
