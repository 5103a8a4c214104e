"""Every parallel axis once, each against the same computation on one
rank (the port's counterpart of the JAX package's multi-device dry run).

    python -m velocity_asr_tpu_torch.parallel.dryrun
    torchrun --standalone --nproc_per_node 4 -m velocity_asr_tpu_torch.parallel.dryrun --full

Without ``--full`` it spawns a gloo world of 4 CPU processes
(the ranks meet over a ``FileStore`` in a temporary directory) and runs
every leg at a tiny width. With ``--full`` it runs under ``torchrun`` on
one card a rank (NCCL) at full width:

- ``dp``: one fp32 micro-step (dropout and SpecAugment on) over a data
  axis of every rank, the global batch padded (30 rows at full width);
  the loss within 1e-5 and every gradient within 1e-3 of its max|grad|
  of the one-rank step's (the synth_run checkpoint at full width);
- ``tp``: a 2 x 2 (data, model) mesh on ``from_preset("large-vocab")``
  (each rank holds half of the 50,000 head rows): 3 micro-steps beside
  one rank's, the first loss within 1e-5, and a checkpoint saved from
  the sharded run reloaded bit-equal on one rank;
- ``pp``: the local stack pipelined over every rank (8 blocks, 2 a stage
  at full width), microbatches 4 and 8, dropout 0: logits and gradients
  against one rank's at dp's limits; with dropout 0.1, 3 finite steps;
- ``ep``: the experts over every rank of ``from_preset("moe")`` at full
  width, seeded (8 experts, 2 a rank at 4; its 1,000-token head 250 rows
  a rank: the moe_run checkpoint's 30-token head does not split over 4
  model ranks, which the JAX package refuses too): fp32 logits within
  1e-4 and one micro-step at dp's limits;
- ``sp``: the scan sharded over every rank against one launch (1e-5 of
  the whole scan's scale), and at full width the 40 long-form utterances
  transcribed at batch 1 with ``scan_mode="sp"``: every text equal to
  the one-rank offline text, the longest's fp32 logits within 1e-3;
- ``layout``: a simulated 2-node layout fed shuffled ranks: the grid
  node-major, the model pairs inside a node, and a data x model step on
  it equal to the plain data-parallel step.

Rank 0 prints one JSON line of every leg's numbers and each leg's
verdict; the exit code is 1 if any leg failed. ``spawn_world`` (the CPU
launcher) is what the tests use too.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing as mp
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CHECKPOINT = os.path.join(ROOT, "checkpoints", "synth_run", "final_pretrained")
TINY = dict(d_model=32, ssm_layers=4, ssm_state_dim=8, global_ssm_layers=1,
            global_ssm_state_dim=4, attention_heads=2, attention_dim=8, vocab_size=64,
            dropout=0.1, scan_mode="pallas", dtype="float32")
LOSS_RTOL = 1e-5  # chip_smoke phase 8a's limits
GRAD_REL = 1e-3
EP_LOGITS_ATOL = 1e-4
SP_SCAN_REL = 1e-5
SP_LOGITS_ATOL = 1e-3
# The key projection's bias has an exact gradient of 0 (softmax ignores a
# shift of every key): its computed gradient is round-off with no scale of
# its own, held below this fraction of the model's largest gradient
# instead (chip_smoke's rule).
ZERO_GRAD_PARAMS = ("global_context.cross_attention.k_proj.bias",)
ZERO_GRAD_MAX_REL = 1e-5


# ----- the CPU launcher ------------------------------------------------------------


def _child(rank: int, world: int, store_path: str, fn: Callable, args: tuple, results) -> None:
    torch.set_num_threads(1)
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(world)})
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world, timeout=timedelta(seconds=300))
        try:
            results.put((rank, "ok", fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise


def spawn_world(world: int, fn: Callable, args: tuple = (), timeout: float = 300.0,
                store_dir: str = None) -> List[Any]:
    """Run ``fn(*args)`` on every rank of a gloo world of `world` CPU
    processes (spawned, one torch thread each, ranks meeting over a
    ``FileStore`` in `store_dir` or a fresh temporary directory); returns
    the ranks' results in rank order. Raises with the child's traceback if
    a rank fails, or after `timeout` seconds; every child is gone when it
    returns. `fn` must be importable by name (a module-level function)."""
    ctx = mp.get_context("spawn")
    own_dir = store_dir is None
    store_dir = store_dir or tempfile.mkdtemp(prefix="velocity_world_")
    store_path = os.path.join(store_dir, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(r, world, store_path, fn, args, results),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    out: Dict[int, Any] = {}
    errors: Dict[int, str] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) + len(errors) < world:  # drain the queue before joining
            try:
                rank, status, value = results.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                if errors:
                    break
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                raise TimeoutError(f"world of {world}: {len(out)} results after "
                                   f"{timeout:.0f} s (exit codes {dead})") from None
            if status == "error":
                errors[rank] = value
                # the others fail soon after (or hang on a collective): wait a little
                deadline = min(deadline, time.monotonic() + 10.0)
            else:
                out[rank] = value
        if errors:
            raise RuntimeError("\n".join(f"rank {r} of {world} failed:\n{tb}"
                                         for r, tb in sorted(errors.items())))
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        if own_dir:
            shutil.rmtree(store_dir, ignore_errors=True)
    return [out[r] for r in range(world)]


# ----- helpers ---------------------------------------------------------------------


def random_batch(seed: int, rows: int, frames: int, vocab: int, tokens: int = 12) -> Dict:
    """A host-mel batch from `seed`: standard-normal mel, valid lengths
    from frames / 2 to frames, targets in [3, vocab)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(frames // 2, frames + 1, rows).astype(np.int32)
    lengths[0] = frames
    mel = rng.standard_normal((rows, frames, 80)).astype(np.float32)
    for i, n in enumerate(lengths):
        mel[i, n:] = 0.0
    t_len = rng.integers(tokens // 2, tokens + 1, rows).astype(np.int32)
    targets = np.full((rows, tokens), 2, np.int32)
    for i, n in enumerate(t_len):
        targets[i, :n] = rng.integers(3, vocab, n)
    return {"mel_spectrogram": mel, "targets": targets, "input_lengths": lengths,
            "target_lengths": t_len}


def grad_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a - b| over max|b| (0 where both are 0)."""
    scale = b.abs().max().item()
    diff = (a - b).abs().max().item()
    return diff / scale if scale > 0 else diff


def _config(**kw):
    from ..training import TrainingConfig

    base = dict(learning_rate=1e-3, warmup_steps=1, max_steps=10, log_interval=10 ** 9,
                eval_interval=10 ** 9, save_interval=10 ** 9)
    return TrainingConfig(**{**base, **kw})


def one_rank(model, cfg):
    """A Trainer of `model` on this rank alone (no groups), `cfg` without
    its parallel fields: the reference a leg compares with."""
    from ..training import Trainer
    from .mesh import local_mesh

    cfg = dataclasses.replace(cfg, num_data_shards=1, num_model_shards=1,
                              num_pipeline_stages=1, pipeline_microbatches=None)
    return Trainer(model, cfg, iter(()), mesh=local_mesh())


def _model(full: bool, device, **overrides):
    from ..models.config import VelocityASRConfig
    from ..models.model import create_model, from_pretrained

    if full:
        return from_pretrained(CHECKPOINT, device=device, dtype="float32", **overrides)
    cfg = VelocityASRConfig(**{**TINY, **overrides})
    return create_model(cfg, device=device, generator=torch.Generator().manual_seed(0))


def _full_grads(trainer, grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """A trainer's gradients in the single-rank layout (sharded slices
    gathered over the model axis)."""
    from .tp import gather_tensor

    return [g if d is None else gather_tensor(g, d, trainer.mesh)
            for g, d in zip(grads, trainer._specs)]


def compare_step(trainer, ref, batch, seed: int = 0) -> Dict[str, float]:
    """One micro-batch's loss and gradients through `trainer` (a mesh) and
    `ref` (one rank), both in training mode with the step-0 generator of
    `seed`: the loss's relative gap, the worst gradient's max|diff| /
    max|ref grad| (every rank's own gradients, sharded slices gathered),
    and the gap of the global norm each optimizer clips by."""
    from ..training import step_seed

    out = []
    for t in (trainer, ref):
        t.model.train()
        rng = torch.Generator(device=t.device)
        rng.manual_seed(step_seed(seed, 0))
        loss, grads = t.gradients(batch, rng)
        out.append((float(loss), _full_grads(t, grads), t.optimizer.global_norm(grads).item()))
    (loss, grads, norm), (ref_loss, ref_grads, ref_norm) = out
    names = [n for n, _ in ref.model.named_parameters()]
    top = max(g.abs().max().item() for g in ref_grads)
    rel = {n: grad_rel(a, b) for n, a, b in zip(names, grads, ref_grads)
           if n not in ZERO_GRAD_PARAMS}
    zero = [(a - b).abs().max().item() / top for n, a, b in zip(names, grads, ref_grads)
            if n in ZERO_GRAD_PARAMS]
    worst = max(rel, key=rel.get)
    return {"loss": loss, "loss_rel": abs(loss - ref_loss) / max(abs(ref_loss), 1e-30),
            "grad_rel": rel[worst], "worst_param": worst, "zero_grad_rel": max(zero, default=0.0),
            "norm_rel": abs(norm - ref_norm) / ref_norm}


def _passes(result: Dict[str, float]) -> bool:
    return (result["loss_rel"] <= LOSS_RTOL and result["grad_rel"] <= GRAD_REL
            and result["zero_grad_rel"] <= ZERO_GRAD_MAX_REL)


def shared_dir() -> str:
    """A temporary directory rank 0 makes and every rank is told of."""
    path = [tempfile.mkdtemp(prefix="velocity_dryrun_") if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(path, src=0)
    return path[0]


# ----- the legs --------------------------------------------------------------------


def leg_dp(device, full: bool) -> Dict[str, Any]:
    from ..augment import SpecAugmentConfig
    from ..training import Trainer

    world = dist.get_world_size()
    rows = 30 if full else 2 * world + 1  # the padding shows
    frames = 400 if full else 48
    aug = SpecAugmentConfig(enabled=True, time_mask_frames=20 if full else 6, freq_mask_bins=8)
    cfg = _config(num_data_shards=world, augment=aug)
    model = _model(full, device)
    batch = random_batch(1, rows, frames, model.config.vocab_size)
    trainer = Trainer(model, cfg, iter(()))
    ref = one_rank(_model(full, device), cfg)
    out = compare_step(trainer, ref, batch)
    out.update(rows=rows, frames=frames, ok=_passes(out))
    return out


def leg_tp(device, full: bool) -> Dict[str, Any]:
    from ..models.config import VelocityASRConfig
    from ..models.model import create_model
    from ..training import Trainer
    from .tp import full_state_dict

    if full:
        mcfg = VelocityASRConfig.from_preset("large-vocab", dtype="float32", dropout=0.0,
                                             scan_mode="pallas")
    else:
        mcfg = VelocityASRConfig(**{**TINY, "dropout": 0.0})

    def model():
        return create_model(mcfg, device=device, generator=torch.Generator().manual_seed(0))

    cfg = _config(num_data_shards=2, num_model_shards=2)
    trainer = Trainer(model(), cfg, iter(()))
    ref = one_rank(model(), cfg)
    rows, frames = (8, 400) if full else (4, 48)
    losses = []
    for step in range(3):
        batch = random_batch(10 + step, rows, frames, mcfg.vocab_size)
        losses.append((trainer.train_step(batch)["loss"], ref.train_step(batch)["loss"]))
    path = shared_dir()
    trainer.save_checkpoint(path)
    full_params = full_state_dict(trainer.model, trainer.mesh)
    reload = one_rank(model(), cfg)
    reload.load_checkpoint(path)
    state = reload.model.state_dict()
    bit_equal = all(torch.equal(state[k], v) for k, v in full_params.items())
    opt = reload.optimizer.state_dict()
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(path, ignore_errors=True)
    head_rows = trainer.model.ctc_head.proj.weight.shape[0]
    first_rel = abs(losses[0][0] - losses[0][1]) / abs(losses[0][1])
    return {"losses": losses, "loss_rel": first_rel,
            "loss_rel_max": max(abs(a - b) / abs(b) for a, b in losses),
            "head_rows": head_rows, "reload_bit_equal": bit_equal, "reload_count": opt["count"],
            "ok": bit_equal and first_rel <= LOSS_RTOL and head_rows * 2 == mcfg.vocab_size}


def leg_pp(device, full: bool) -> Dict[str, Any]:
    from ..training import Trainer
    from .pp import pipeline_parallel

    world = dist.get_world_size()
    rows, frames = (8, 400) if full else (8, 48)
    out: Dict[str, Any] = {"stages": world}
    ok = True
    for m in (4, 8):
        cfg = _config(num_pipeline_stages=world, pipeline_microbatches=m)
        model = _model(full, device, dropout=0.0)
        ref_model = _model(full, device, dropout=0.0)
        trainer = Trainer(model, cfg, iter(()))
        ref = one_rank(ref_model, cfg)
        batch = random_batch(20 + m, rows, frames, model.config.vocab_size)
        mel = torch.from_numpy(batch["mel_spectrogram"]).to(device)
        with torch.no_grad():
            with pipeline_parallel(trainer.mesh, microbatches=m):
                logits = model.eval()(mel)
            ref_logits = ref_model.eval()(mel)
        res = compare_step(trainer, ref, batch)
        res["logits_max_abs"] = (logits - ref_logits).abs().max().item()
        res["logits_rel"] = res["logits_max_abs"] / ref_logits.abs().max().item()
        ok = ok and _passes(res) and res["logits_rel"] <= GRAD_REL
        out[f"microbatches_{m}"] = res
    cfg = _config(num_pipeline_stages=world)
    trainer = Trainer(_model(full, device, dropout=0.1), cfg, iter(()))
    vocab = trainer.model.config.vocab_size
    losses = [trainer.train_step(random_batch(30 + s, rows, frames, vocab))["loss"]
              for s in range(3)]
    out["dropout_losses"] = losses
    out["ok"] = ok and all(np.isfinite(losses))
    return out


def leg_ep(device, full: bool) -> Dict[str, Any]:
    from ..models.config import VelocityASRConfig
    from ..models.model import create_model
    from ..training import Trainer

    world = dist.get_world_size()
    if full:
        mcfg = VelocityASRConfig.from_preset("moe", dtype="float32", scan_mode="pallas")
    else:
        mcfg = VelocityASRConfig(**{**TINY, "moe_experts": 2 * world})
    model, ref_model = (create_model(mcfg, device=device,
                                     generator=torch.Generator().manual_seed(0))
                        for _ in range(2))
    cfg = _config(num_data_shards=1, num_model_shards=world)
    trainer = Trainer(model, cfg, iter(()))
    ref = one_rank(ref_model, cfg)
    rows, frames = (4, 400) if full else (4, 48)
    batch = random_batch(40, rows, frames, model.config.vocab_size)
    mel = torch.from_numpy(batch["mel_spectrogram"]).to(device)
    with torch.no_grad():
        logits = model.eval()(mel)
        ref_logits = ref_model.eval()(mel)
    out = compare_step(trainer, ref, batch)
    out["experts_per_rank"] = model.local_ssm.layers[0].moe.w_in.shape[0]
    out["logits_max_abs"] = (logits - ref_logits).abs().max().item()
    out["ok"] = _passes(out) and out["logits_max_abs"] <= EP_LOGITS_ATOL
    return out


def leg_sp(device, full: bool) -> Dict[str, Any]:
    from ..ops.scan import scan_fwd
    from .mesh import create_mesh
    from .sp_scan import selective_scan_sp_padded, sequence_parallel

    world = dist.get_world_size()
    mesh = create_mesh()
    rng = np.random.default_rng(50)
    out: Dict[str, Any] = {}
    ok = True
    for length in ((3600, 3601) if full else (61, 64)):
        d_inner, n = (384, 64) if full else (16, 8)
        x, dt, B, C = (torch.tensor(a, dtype=torch.float32, device=device) for a in (
            rng.standard_normal((1, length, d_inner)),
            np.abs(rng.standard_normal((1, length, d_inner))) * 0.05,
            rng.standard_normal((1, length, n)), rng.standard_normal((1, length, n))))
        A = -torch.arange(1, n + 1, dtype=torch.float32, device=device)
        D = torch.zeros(d_inner, device=device)
        with torch.no_grad():
            y = selective_scan_sp_padded(x, dt, A, B, C, D, mesh)
            ref = scan_fwd(x, dt, A, B, C)
        rel = grad_rel(y, ref)
        out[f"scan_L{length}_rel"] = rel
        ok = ok and rel <= SP_SCAN_REL
    if full:
        out.update(_sp_longform(device, mesh))
        ok = ok and out["texts_equal"] == out["utterances"] and \
            out["longest_logits_max_abs"] <= SP_LOGITS_ATOL
    else:
        model = _model(False, device, scan_mode="sp")
        ref_model = _model(False, device)
        mel = torch.from_numpy(random_batch(51, 2, 120, 64)["mel_spectrogram"]).to(device)
        with torch.no_grad(), sequence_parallel(mesh):
            logits = model.eval()(mel)
        with torch.no_grad():
            ref_logits = ref_model.eval()(mel)
        out["model_logits_max_abs"] = (logits - ref_logits).abs().max().item()
        ok = ok and out["model_logits_max_abs"] <= 2e-4
    out["world"] = world
    out["ok"] = ok
    return out


def _sp_longform(device, mesh) -> Dict[str, Any]:
    """The 40 long-form utterances at batch 1 with scan_mode "sp" against
    the one-rank offline texts, and the longest's fp32 logits."""
    from .. import synth
    from ..audio import load_audio
    from ..transcribe import load_transcriber
    from .sp_scan import sequence_parallel

    tmp = shared_dir()
    if dist.get_rank() == 0:
        synth.write_corpus(os.path.join(tmp, "longform"), 40, split="longform", seed=1234,
                           min_words=90, max_words=110)
    dist.barrier()
    with open(os.path.join(tmp, "longform", "longform_manifest.jsonl")) as f:
        audios = [load_audio(json.loads(line)["audio_path"]) for line in f]
    sp = load_transcriber(CHECKPOINT, device=device, scan_mode="sp")
    ref = load_transcriber(CHECKPOINT, device=device)
    t0 = time.perf_counter()
    with sequence_parallel(mesh):
        texts = [sp.transcribe_array(a)["text"] for a in audios]
    sp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_texts = [ref.transcribe_array(a)["text"] for a in audios]
    ref_s = time.perf_counter() - t0
    longest = int(np.argmax([len(a) for a in audios]))
    logits = []
    for scan_mode in ("sp", "pallas"):
        tr = load_transcriber(CHECKPOINT, device=device, dtype="float32", scan_mode=scan_mode)
        padded, n_frames = tr._pad_audio(audios[longest])
        wire = torch.from_numpy(tr._to_wire(padded)).to(device)
        with sequence_parallel(mesh):
            logits.append(tr.masked_logits(wire, n_frames))
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"utterances": len(audios),
            "texts_equal": sum(a == b for a, b in zip(texts, ref_texts)),
            "longest_samples": len(audios[longest]),
            "longest_logits_max_abs": (logits[0] - logits[1]).abs().max().item(),
            "sp_seconds": sp_s, "one_rank_seconds": ref_s}


def leg_layout(device, full: bool) -> Dict[str, Any]:
    from ..training import Trainer
    from .mesh import MODEL_AXIS, create_mesh

    world = dist.get_world_size()
    per_node = world // 2
    ranks = list(range(world))
    shuffled = ranks[1::2] + ranks[0::2]
    node_of = lambda r: r // per_node  # noqa: E731
    mesh = create_mesh(world // 2, 2, devices=shuffled, slice_index_of=node_of)
    grid = mesh._ranks
    node_major = grid.flatten().tolist() == ranks
    pairs_inside = all(node_of(grid[r, 0]) == node_of(grid[r, 1]) for r in range(grid.shape[0]))
    cfg = _config(num_data_shards=world // 2, num_model_shards=2)
    model = _model(full, device, dropout=0.0)
    batch = random_batch(60, 4, 400 if full else 48, model.config.vocab_size)
    loss = Trainer(model, cfg, iter(()), mesh=mesh).train_step(batch)["loss"]
    dp_loss = Trainer(_model(full, device, dropout=0.0), _config(num_data_shards=world),
                      iter(())).train_step(batch)["loss"]
    rel = abs(loss - dp_loss) / abs(dp_loss)
    return {"grid": grid.tolist(), "node_major": node_major, "model_pairs_in_node": pairs_inside,
            "model_axis": mesh.shape[MODEL_AXIS], "loss_rel_vs_dp": rel,
            "ok": node_major and pairs_inside and rel <= LOSS_RTOL}


LEGS = {"dp": leg_dp, "tp": leg_tp, "pp": leg_pp, "ep": leg_ep, "sp": leg_sp,
        "layout": leg_layout}


def run_legs(full: bool, device_type: str = "cpu") -> Dict[str, Any]:
    """Every leg on this rank of an initialised world of 4 (``tp`` and
    ``layout`` need an even world); returns {leg: results}."""
    from ..device import resolve_device

    device = resolve_device(device_type)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    results = {}
    for name in LEGS:
        t0 = time.perf_counter()
        results[name] = LEGS[name](device, full)
        results[name]["seconds"] = time.perf_counter() - t0
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--full", action="store_true",
                        help="full width on the cards, one a rank, under torchrun (NCCL)")
    args = parser.parse_args(argv)
    if args.full:
        from .mesh import init_distributed, shutdown_distributed

        if "WORLD_SIZE" not in os.environ:
            parser.error("--full runs under torchrun (one card a rank)")
        init_distributed("cuda")
        try:
            results = run_legs(True, "cuda")
            rank = dist.get_rank()
        finally:
            shutdown_distributed()
        if rank:
            return 0 if all(r["ok"] for r in results.values()) else 1
        import subprocess

        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip().splitlines()
        results["cards"] = card
    else:
        results = spawn_world(4, run_legs, (False, "cpu"), timeout=600)[0]
    print(json.dumps(results, default=float))
    return 0 if all(r["ok"] for k, r in results.items() if k in LEGS) else 1


if __name__ == "__main__":
    sys.exit(main())
