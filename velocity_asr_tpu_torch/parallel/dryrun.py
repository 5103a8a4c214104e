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
  it equal to the plain data-parallel step;
- ``qat``: one fp32 QAT micro-step (the synth_run checkpoint as its QAT
  model at full width) over DP on every rank (30 rows), TP 2 x 2 and PP
  on every rank (8 rows), each against one rank whose arithmetic rounds
  as the ranks' does (``ranks_rounding``: a fake quantizer turns an ulp
  into a code step): the observers the same on every rank bit for bit
  and within 1e-6 of one rank's, the loss and gradients within dp's
  limits; beside them the gaps to the plain one rank (reported), and
  (DP) the float model's forward under ``ranks_rounding`` bit-equal, row
  for row, to a forward of each rank's rows alone. The controls must
  miss: each rank's own rows alone through one rank's observers
  (more than 1% off), and a mesh step with the data group's reduction
  taken out (with a data axis) or the head's model group taken out (TP)
  beyond the loss or gradient limit. Then ``train`` as a 2 x 2 QAT run
  (2 micro-steps from scratch of ``configs/train_synth.yaml`` with
  ``quantization.enabled``), its ``quant_stats.msgpack`` reloaded on one
  rank bit-equal to the run's gathered stats, and ``export_model
  --quantize --verify`` from its ``final_pretrained/``.

Rank 0 prints one JSON line of every leg's numbers and each leg's
verdict, with every rank's failed legs under ``failed_by_rank``; the
exit code is 1 if any leg failed on any rank. ``spawn_world`` (the CPU
launcher) is what the tests use too.
"""

from __future__ import annotations

import argparse
import contextlib
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
from torch.overrides import TorchFunctionMode

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
QAT_STATS_REL = 1e-6  # observers over a mesh against one rank's
QAT_CONTROL_REL = 0.01  # each rank's own rows must give stats at least this far off
TINY_MODEL_YAML = ("model:\n  d_model: 32\n  dropout: 0.0\nssm:\n  num_layers: 4\n"
                   "  state_dim: 8\nglobal_context:\n  ssm_layers: 1\n  ssm_state_dim: 4\n"
                   "  attention_heads: 2\n  attention_dim: 8\noutput:\n  vocab_size: 30\n"
                   "performance:\n  scan_mode: pallas\n  dtype: float32\n")


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


def stats_rel(stats: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> float:
    """The worst gap of two sets of observer stats (by buffer name): a
    float stat's max|diff| / max|ref| (``grad_rel``), 0 or inf for a flag
    or a range that is still +-inf (equal or not)."""
    worst = 0.0
    for key, want in ref.items():
        got = stats[key].to(want.device)
        if want.dtype == torch.bool or not torch.isfinite(want).all():
            worst = max(worst, 0.0 if torch.equal(got, want) else float("inf"))
        else:
            worst = max(worst, grad_rel(got, want))
    return worst


# arithmetic whose rounding may depend on how many rows one call holds (a
# library picks its kernel, tiling or vector width by the call's shape);
# data movement rounds nothing and runs whole
_ROW_OPS = frozenset((
    "linear", "matmul", "conv1d", "einsum", "bmm", "baddbmm", "layer_norm", "softmax",
    "log_softmax", "gelu", "silu", "sigmoid", "softplus", "tanh", "exp", "log", "sqrt", "rsqrt",
    "pow", "add", "radd", "sub", "rsub", "mul", "rmul", "div", "truediv", "rtruediv", "sum",
    "mean", "clamp", "clamp_min", "where"))


def rank_calls(rows: int, n_data: int, microbatches: int = 1) -> List[tuple]:
    """[(row indices, real rows)]: the calls a mesh's ranks make for an
    operation on the global batch's `rows` rows. Each data rank holds an
    equal block of the batch padded by row 0 (``shard_batch``), cut into
    `microbatches` equal microbatches in the pipelined stack; a call of
    padding alone is left out."""
    pad = (-rows) % n_data
    size = (rows + pad) // n_data // microbatches
    padded = list(range(rows)) + [0] * pad
    return [(padded[lo:lo + size], min(size, rows - lo)) for lo in range(0, rows, size)]


def _take(a: torch.Tensor, index: List[int]) -> torch.Tensor:
    """The rows `index` of `a` laid out as a rank's own tensor of them is:
    a view where they are a range, else a copy with `a`'s strides and
    storage offset (a chunk of a wider tensor keeps its gaps; a loop's
    split over threads and vector lanes follows the layout)."""
    if index == list(range(index[0], index[0] + len(index))):
        return a.narrow(0, index[0], len(index))
    size = (len(index),) + tuple(a.shape[1:])
    extent = 1 + sum((n - 1) * stride for n, stride in zip(size, a.stride()))
    out = a.new_empty(a.storage_offset() + extent).as_strided(size, a.stride(),
                                                              a.storage_offset())
    return out.copy_(a[index])


class _RanksRounding(TorchFunctionMode):
    """``ranks_rounding``'s mode: while ``active`` and outside an observer
    (``whole``), each ``_ROW_OPS`` call on the batch runs once per call of
    ``calls`` (``per_call``), and the sharded head's product once per
    model rank's columns."""

    def __init__(self, calls: List[tuple]):
        super().__init__()
        self.calls = calls
        self.columns = 1
        self.active = 0
        self.whole = 0

    @property
    def rows(self) -> int:
        return sum(n for _, n in self.calls)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        in_place = name.endswith("_") and not name.startswith("__")
        if not self.active or self.whole or in_place or name.strip("_") not in _ROW_OPS:
            return func(*args, **kwargs)
        if self.columns > 1 and name.strip("_") == "matmul":  # the head's x @ W^T
            x, w = args
            return torch.cat([self._rows(func, (x, part), kwargs)
                              for part in w.chunk(self.columns, dim=-1)], dim=-1)
        return self._rows(func, args, kwargs)

    def _rows(self, func, args, kwargs):
        whole = func(*args, **kwargs)
        if not isinstance(whole, torch.Tensor) or whole.dim() == 0 \
                or whole.shape[0] != self.rows:
            return whole  # no row-by-row result (a reduction over the batch)
        batched = [_leads_with_rows(func, args, i, whole) for i in range(len(args))]
        if not any(batched):
            return whole
        return self.per_call(func, args, kwargs, batched, whole)

    def per_call(self, func, args, kwargs, batched: List[bool], whole):
        """`func` once per call of ``calls`` on the `batched` arguments'
        rows; each output's real rows joined into a tensor laid out as
        `whole`'s (as a rank's is: a layout follows the inputs' strides,
        and an elementwise loop's vector lanes follow the layout)."""
        outs = whole if isinstance(whole, tuple) else (whole,)
        joined = [torch.empty_like(o) for o in outs]
        for index, n in self.calls:
            part = func(*(_take(a, index) if b else a for a, b in zip(args, batched)), **kwargs)
            for j, p in zip(joined, part if isinstance(part, tuple) else (part,)):
                j.narrow(0, index[0], n).copy_(p[:n])
        return tuple(joined) if isinstance(whole, tuple) else joined[0]


def _leads_with_rows(func, args, i: int, out: torch.Tensor) -> bool:
    """Whether the i-th argument's first dim is the batch's, the first of
    `out`: a linear or convolution's input (its weight is not), an einsum
    operand whose subscripts start with the output's first, else a tensor
    that broadcasts its first dim onto `out`'s (as many dims)."""
    a = args[i]
    if not isinstance(a, torch.Tensor) or a.dim() == 0 or a.shape[0] != out.shape[0]:
        return False
    name = getattr(func, "__name__", "").strip("_")
    if name in ("linear", "conv1d"):
        return i == 0
    if name == "einsum":
        inputs, _, output = args[0].replace(" ", "").partition("->")
        subs = inputs.split(",")
        return (bool(output) and "." not in args[0] and i >= 1
                and subs[i - 1][:1] == output[:1])
    return a.dim() == out.dim()


@contextlib.contextmanager
def ranks_rounding(trainer, model, rows: int):
    """While active, `model`'s forwards (one rank's copy of `trainer`'s
    model, in a Trainer of its own) compute their arithmetic on a
    `rows`-row batch as `trainer`'s ranks compute theirs: each call once
    per data rank's block of rows (padded by row 0 as ``shard_batch``
    pads), in the local stack's blocks once per pipeline microbatch, and
    the sharded head's product once per model rank's slice of the
    vocabulary (the training scan's kernel too, whose launch plan follows
    the batch); the observers see the joined tensor, the global one, and
    run whole. A fake quantizer turns an ulp into a code step, and an
    operation's rounding can depend on its call's shape, so this is the
    one-rank step that a QAT mesh step is held to at fp32 limits (without
    dropout: a call run twice would draw twice)."""
    from ..ops import scan as scan_ops
    from ..quantize import FakeQuantize
    from .mesh import DATA_AXIS, MODEL_AXIS
    from .pp import _resolve_microbatches

    cfg, n_data = trainer.config, trainer.mesh.shape[DATA_AXIS]
    mode = _RanksRounding(rank_calls(rows, n_data))
    hooks = []

    def scoped(module, **change):
        saved = []

        def pre(*_):
            saved.append({k: getattr(mode, k) for k in change})
            for k, v in change.items():
                setattr(mode, k, v(getattr(mode, k)) if callable(v) else v)

        def post(*_):
            for k, v in saved.pop().items():
                setattr(mode, k, v)

        hooks.extend((module.register_forward_pre_hook(pre), module.register_forward_hook(post)))

    def deeper(depth):
        return depth + 1

    scoped(model, active=deeper)
    for observer in model.modules():
        if isinstance(observer, FakeQuantize):
            scoped(observer, whole=deeper)
    if cfg.num_pipeline_stages > 1:
        per = -(-rows // n_data)
        m = _resolve_microbatches(per, cfg.num_pipeline_stages, cfg.pipeline_microbatches)
        for block in model.local_ssm.layers:
            scoped(block, calls=rank_calls(rows, n_data, m))
    if trainer.model.ctc_head.tp_group is not None:
        scoped(model.ctc_head.proj, columns=trainer.mesh.shape[MODEL_AXIS])
    # the training scan's kernel is no torch function, and its launch plan
    # (states a thread) follows batch x channels x states: it runs per call too
    launch = scan_ops.scan_fwd_bounds

    def scan_per_call(x, dt, A, B, C):
        whole = launch(x, dt, A, B, C)
        if not mode.active or mode.whole or x.shape[0] != mode.rows:
            return whole
        return mode.per_call(launch, (x, dt, A, B, C), {}, [True, True, False, True, True],
                             whole)

    scan_ops.scan_fwd_bounds = scan_per_call
    try:
        with mode:
            yield model
    finally:
        scan_ops.scan_fwd_bounds = launch
        for hook in hooks:
            hook.remove()


def compare_step(trainer, ref, batch, seed: int = 0, as_ranks: bool = False) -> Dict[str, float]:
    """One micro-batch's loss and gradients through `trainer` (a mesh) and
    `ref` (one rank; with `as_ranks` under ``ranks_rounding``), both in
    training mode with the step-0 generator of `seed`: the loss's
    relative gap, the worst gradient's max|diff| / max|ref grad| (every
    rank's own gradients, sharded slices gathered), the gap of the global
    norm each optimizer clips by, and of a QAT model the gap of the
    observers the step refreshed (``stats_rel``, this rank's gathered)."""
    from ..training import step_seed
    from .tp import full_quant_stats

    out = []
    for t in (trainer, ref):
        t.model.train()
        rng = torch.Generator(device=t.device)
        rng.manual_seed(step_seed(seed, 0))
        rounding = (ranks_rounding(trainer, ref.model, len(batch["targets"]))
                    if t is ref and as_ranks else contextlib.nullcontext())
        with rounding:
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
    out = {"loss": loss, "loss_rel": abs(loss - ref_loss) / max(abs(ref_loss), 1e-30),
           "grad_rel": rel[worst], "worst_param": worst, "zero_grad_rel": max(zero, default=0.0),
           "norm_rel": abs(norm - ref_norm) / ref_norm}
    ref_stats = full_quant_stats(ref.model, ref.mesh)
    if ref_stats:
        out["stats_rel"] = stats_rel(full_quant_stats(trainer.model, trainer.mesh), ref_stats)
    return out


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
        wire, n_frames = tr.wire_pcm(audios[longest])
        wire = wire.to(device)
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


def same_on_every_rank(stats: Dict[str, torch.Tensor]) -> bool:
    """Whether every rank of the world holds these stats bit for bit (a
    collective)."""
    from .mesh import _all_gather

    flat = torch.cat([v.detach().reshape(-1).to(torch.float64) for v in stats.values()])
    return all(torch.equal(part, flat) for part in _all_gather(flat, None))


def witness_bit_equal(trainer, model, batch) -> bool:
    """Whether `model`'s forward (training mode, dropout 0, no observers)
    under ``ranks_rounding`` gives each of `trainer`'s data ranks' rows
    bit for bit as a forward of those rows alone does (its rows padded
    as ``shard_batch`` pads): the witness rounds as the ranks do."""
    from .mesh import DATA_AXIS

    mel = torch.from_numpy(batch["mel_spectrogram"]).to(next(model.parameters()).device)
    rows = mel.shape[0]
    model.train()
    with ranks_rounding(trainer, model, rows):
        joined = model(mel).detach()
    return all(torch.equal(joined[index[0]:index[0] + n], model(mel[index])[:n].detach())
               for index, n in rank_calls(rows, trainer.mesh.shape[DATA_AXIS]))


def _misses(result: Dict[str, float]) -> bool:
    """Whether a planted fault's step misses the loss or gradient limit."""
    return result["loss_rel"] > LOSS_RTOL or result["grad_rel"] > GRAD_REL


def leg_qat(device, full: bool) -> Dict[str, Any]:
    from ..quantize import observe_over, quant_stats_buffers
    from ..training import Trainer
    from .mesh import DATA_AXIS, MODEL_AXIS, shard_batch
    from .tp import full_quant_stats

    world = dist.get_world_size()
    frames = 400 if full else 48
    gaps = ("loss_rel", "grad_rel", "stats_rel")
    limits = {"loss_rel": LOSS_RTOL, "grad_rel": GRAD_REL, "stats_rel": QAT_STATS_REL}
    out: Dict[str, Any] = {"limits": limits}
    ok = True
    layouts = (("dp", dict(num_data_shards=world), 30 if full else 2 * world + 1),
               ("tp", dict(num_data_shards=2, num_model_shards=2), 8),
               ("pp", dict(num_pipeline_stages=world, pipeline_microbatches=world), 8))
    for i, (name, layout, rows) in enumerate(layouts):
        cfg = _config(**layout)
        trainer = Trainer(_model(full, device, qat=True, dropout=0.0), cfg, iter(()))
        ref = one_rank(_model(full, device, qat=True, dropout=0.0), cfg)
        batch = random_batch(70 + i, rows, frames, trainer.model.config.vocab_size)
        res = compare_step(trainer, ref, batch, as_ranks=True)
        res["rows"] = rows
        if name == "dp":
            res["witness_bit_equal"] = witness_bit_equal(
                trainer, _model(full, device, dropout=0.0), batch)
        res["stats_same_on_every_rank"] = same_on_every_rank(
            full_quant_stats(trainer.model, trainer.mesh))
        plain = compare_step(trainer, ref, batch)
        res["plain_one_rank"] = {k: plain[k] for k in gaps}
        controls = {}
        data_group = trainer.mesh.group(DATA_AXIS)
        if data_group is not None:
            # the observers as each rank computed them before they reduced
            want = {k: v.clone() for k, v in quant_stats_buffers(ref.model).items()}
            local, _, _ = shard_batch(trainer.mesh, batch)
            with torch.no_grad():
                ref.model.train()(torch.from_numpy(local["mel_spectrogram"]).to(device))
            res["control_stats_rel"] = stats_rel(quant_stats_buffers(ref.model), want)
            controls["own_rows_stats"] = res["control_stats_rel"] > QAT_CONTROL_REL
            observe_over(trainer.model, None)
            res["planted_no_data_group"] = compare_step(trainer, ref, batch, as_ranks=True)
            observe_over(trainer.model, data_group)
            controls["no_data_group"] = _misses(res["planted_no_data_group"])
        head = trainer.model.ctc_head.proj.activation_quantizer
        if MODEL_AXIS in head.groups:
            model_group = head.groups.pop(MODEL_AXIS)
            res["planted_no_model_group"] = compare_step(trainer, ref, batch, as_ranks=True)
            head.groups[MODEL_AXIS] = model_group
            controls["no_model_group"] = _misses(res["planted_no_model_group"])
        res["controls_miss"] = controls
        res["ok"] = (all(res[k] <= v for k, v in limits.items())
                     and res["zero_grad_rel"] <= ZERO_GRAD_MAX_REL
                     and res["stats_same_on_every_rank"] and all(controls.values())
                     and res.get("witness_bit_equal", True))
        ok = ok and res["ok"]
        out[name] = res
    out["train_cli"] = _qat_train_cli(device, full)
    out["ok"] = ok and out["train_cli"]["ok"]
    return out


def _qat_train_cli(device, full: bool) -> Dict[str, Any]:
    """``train`` on this world as a 2 x 2 QAT run, its quant_stats.msgpack
    reloaded into a one-rank model against the run's gathered stats, and
    ``export_model --quantize --verify`` from its final_pretrained (rank 0;
    the verdict is broadcast)."""
    from .. import train as train_cli
    from ..checkpoint import quant_stats_from_numpy, read_params
    from ..export_model import main as export_main
    from ..models.model import create_model
    from ..quantize import load_quant_stats, prepare_model_for_qat, quant_stats_buffers
    from .tp import full_quant_stats

    tmp = shared_dir()
    if dist.get_rank() == 0:
        with open(os.path.join(ROOT, "configs", "train_synth.yaml")) as f:
            text = f.read()
        text = (text.replace("gradient_accumulation_steps: 2", "gradient_accumulation_steps: 1")
                .replace("quantization:\n  enabled: false", "quantization:\n  enabled: true"))
        with open(os.path.join(tmp, "train.yaml"), "w") as f:
            f.write(text + "\ndistributed:\n  num_data_shards: 2\n  num_model_shards: 2\n")
        with open(os.path.join(tmp, "model.yaml"), "w") as f:
            f.write(TINY_MODEL_YAML)
    dist.barrier()
    model_yaml = (os.path.join(ROOT, "configs", "model_synth.yaml") if full
                  else os.path.join(tmp, "model.yaml"))
    run = os.path.join(tmp, "run")
    t0 = time.perf_counter()
    result = train_cli.main(["--config", os.path.join(tmp, "train.yaml"), "--model-config",
                             model_yaml, "--synthetic", "16", "--max-steps", "2",
                             "--batch-size", "8", "--num-workers", "0", "--checkpoint-dir", run,
                             "--device", device.type])
    trainer = result["trainer"]
    stats = {k: v.cpu() for k, v in full_quant_stats(trainer.model, trainer.mesh).items()}
    vocab = trainer.model.config.vocab_size
    out: Dict[str, Any] = {"train_seconds": time.perf_counter() - t0, "vocab": vocab,
                           "head_rows": trainer.model.ctc_head.proj.weight.shape[0],
                           "qat": trainer.model.config.qat}
    if dist.get_rank() == 0:
        pretrained = os.path.join(run, "final_pretrained")
        model = create_model(prepare_model_for_qat(trainer.model.config), device="cpu")
        load_quant_stats(model, quant_stats_from_numpy(read_params(
            os.path.join(pretrained, "quant_stats.msgpack"))))
        reloaded = quant_stats_buffers(model)
        out["reload_bit_equal"] = (reloaded.keys() == stats.keys()
                                   and all(torch.equal(reloaded[k], v) for k, v in stats.items()))
        t0 = time.perf_counter()
        info = export_main(["--checkpoint", pretrained, "--output-dir",
                            os.path.join(tmp, "export"), "--quantize", "--verify",
                            "--device", device.type])
        out.update(export_seconds=time.perf_counter() - t0, export_verify=info["verify"],
                   int8_tensors=info["int8"]["quantized_tensors"])
    verdict = [out.get("reload_bit_equal", False) and out["qat"]
               and out["head_rows"] * 2 == vocab]
    dist.broadcast_object_list(verdict, src=0)
    out["ok"] = bool(verdict[0])
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


LEGS = {"dp": leg_dp, "tp": leg_tp, "pp": leg_pp, "ep": leg_ep, "sp": leg_sp,
        "layout": leg_layout, "qat": leg_qat}


def run_legs(full: bool, device_type: str = "cpu") -> Dict[str, Any]:
    """Every leg on this rank of an initialised world of 4 (``tp``,
    ``layout`` and ``qat`` need an even world); returns {leg: results}."""
    from ..device import resolve_device

    device = resolve_device(device_type)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    results = {}
    for name, leg in LEGS.items():
        t0 = time.perf_counter()
        results[name] = leg(device, full)
        results[name]["seconds"] = time.perf_counter() - t0
    return results


def _failed(results: Dict[str, Any]) -> Dict[str, Any]:
    """A rank's failed legs with their results."""
    return {name: r for name, r in results.items() if not r["ok"]}


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
            # every rank's failures reach rank 0 before any rank exits (torchrun
            # stops the others once one exits non-zero)
            failed = [None] * dist.get_world_size()
            dist.all_gather_object(failed, _failed(results))
            rank = dist.get_rank()
        finally:
            shutdown_distributed()
        if rank:
            return 1 if any(failed) else 0
        import subprocess

        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip().splitlines()
        results["cards"] = card
    else:
        per_rank = spawn_world(4, run_legs, (False, "cpu"), timeout=600)
        results = per_rank[0]
        failed = [_failed(r) for r in per_rank]
    results["failed_by_rank"] = {str(r): f for r, f in enumerate(failed) if f}
    print(json.dumps(results, default=float))
    return 1 if any(failed) else 0


if __name__ == "__main__":
    sys.exit(main())
