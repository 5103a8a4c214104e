"""Training (mirrors velocity_asr_tpu/training.py: the offline objective
and the streaming-aware one), and the error-rate metrics that evaluation
uses.

- ``ctc_loss_per_example`` / ``ctc_loss``: torch ``nn.CTCLoss(blank=0,
  reduction='mean', zero_infinity=True)`` semantics, with the JAX
  package's explicit feasibility mask (T >= U + adjacent repeats).
- ``warmup_cosine_schedule``: linear warmup, then cosine decay to 0.1 of
  the base rate, evaluated for update k at step k + 1, with the
  reference's ``3.14159``.
- ``Optimizer``: what ``make_optimizer`` builds with optax, written out:
  clip by global norm as optax clips (t / norm * max once norm reaches
  max), AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled decay on every
  parameter, schedule indexed by the update count) and MultiSteps
  accumulation (the running mean of k micro-batch gradients, one update
  per k micro-steps).
- ``Trainer``: ``train_step`` / ``eval_step`` / ``train`` with the JAX
  Trainer's cadence (log, eval and best model on eval loss, save with
  keep_last rotation, metrics as JSON lines) and its checkpoint payload
  (``torch.save`` of params and optimizer state beside a
  ``trainer_meta.json`` with the JAX keys). The dropout and SpecAugment
  generator of each micro-step is seeded from (seed, step), so a resumed
  run draws what an unbroken run draws.
- Batches carry a host mel (``mel_spectrogram``) or, from a
  ``device_mel`` dataset, int16 PCM (``audio``) that the step turns into
  a log-mel on the device (``ops.mel``, the log-mel kernel on the card)
  and normalises over each utterance's valid frames. In training the
  waveform augmentations act first, in the JAX order: ``speed_perturb``
  (which rescales the valid lengths), then ``noise_injection``, each
  from its own fork of the micro-step's generator; on a host-mel batch
  either raises.
- A model with ``gradient_checkpointing`` recomputes its local SSM
  blocks in the backward (``models.ssm.CheckpointedBlock``), their
  dropout masks replayed: a micro-step runs 8 no-bounds scan forwards,
  10 bounds forwards and 10 backwards on the card.
- ``profile_dir``: ``train`` records micro-steps [profile_start,
  profile_start + profile_steps) in a ``torch.profiler`` window (CPU,
  and CUDA on the card), each step in a ``micro_step_<n>`` range, and
  writes its Chrome trace there; the window is closed in a ``finally``.
- ``streaming_chunks`` > 0 (device-mel batches only) adds the
  streaming-aware term: CTC on ``streaming.streaming_forward`` logits of
  the same utterances, normalised with causal per-chunk statistics and
  masked by the same SpecAugment draws;
  loss = (1 - w) * offline + w * streaming, w = ``streaming_aux_weight``.

The model's scans train through ``ops.scan.SelectiveScanFn`` (offline)
and ``ops.scan.CarriedStateScanFn`` (the streaming term): on the card the
bounds-saving forward and backward kernels, without and with the carried
state.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import shutil
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .audio import HOP_LENGTH, causal_normalize_mel, masked_normalize_mel
from .augment import SpecAugmentConfig, noise_inject, spec_augment, speed_perturb_audio
from .ops.mel import compute_mel_spectrogram
from .streaming import streaming_forward

logger = logging.getLogger(__name__)


@dataclass
class TrainingConfig:
    """Training configuration: the JAX package's fields and defaults. The
    port trains the offline objective and, with ``streaming_chunks``, the
    streaming-aware one; a config that turns on QAT, MoE, the language-ID
    loss or parallel training makes ``Trainer`` raise (``_unsupported``)."""

    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    warmup_steps: int = 10000
    max_steps: int = 80000
    grad_clip_norm: float = 1.0
    batch_size: int = 32
    gradient_accumulation_steps: int = 1
    # cosine horizon in optimizer updates; None: max_steps // accumulation
    lr_total_steps: Optional[int] = None
    lr_parity_horizon: bool = False  # the reference's horizon of max_steps updates
    use_amp: bool = True  # False forces fp32 compute (applied by train.py)
    log_interval: int = 100
    eval_interval: int = 1000
    save_interval: int = 5000
    checkpoint_dir: str = "./checkpoints"
    resume_from: Optional[str] = None
    keep_last: int = 5
    num_data_shards: Optional[int] = None
    num_model_shards: int = 1
    num_pipeline_stages: int = 1
    pipeline_microbatches: Optional[int] = None
    profile_dir: Optional[str] = None
    profile_start: int = 10
    profile_steps: int = 5
    augment: Optional[SpecAugmentConfig] = None
    streaming_chunks: int = 0
    streaming_aux_weight: float = 0.5
    lid_loss_weight: float = 0.0
    moe_aux_weight: float = 0.01
    metrics_path: Optional[str] = None


# ----- loss ------------------------------------------------------------------


def ctc_loss_per_example(logits: torch.Tensor, targets: torch.Tensor,
                         input_lengths: torch.Tensor, target_lengths: torch.Tensor,
                         blank_token: int = 0) -> torch.Tensor:
    """Per-example CTC loss over fp32 log-softmax, each divided by its
    target length (at least 1); an example with no alignment (T < U +
    adjacent repeats) or a non-finite loss counts 0."""
    log_probs = F.log_softmax(logits.to(torch.float32), dim=-1).transpose(0, 1)
    targets = targets.to(torch.int64)
    input_lengths = input_lengths.to(torch.int64)
    target_lengths = target_lengths.to(torch.int64)
    per_example = F.ctc_loss(log_probs, targets, input_lengths, target_lengths,
                             blank=blank_token, reduction="none", zero_infinity=True)
    tok = torch.arange(targets.shape[1], device=targets.device)[None, :]
    valid = tok < target_lengths[:, None]
    repeats = ((targets[:, 1:] == targets[:, :-1]) & valid[:, 1:]).sum(1)
    feasible = input_lengths >= target_lengths + repeats
    per_example = torch.where(feasible & torch.isfinite(per_example), per_example,
                              torch.zeros_like(per_example))
    return per_example / target_lengths.to(torch.float32).clamp_min(1.0)


def ctc_loss(logits, targets, input_lengths, target_lengths, blank_token: int = 0):
    """Batch mean of ``ctc_loss_per_example``."""
    return ctc_loss_per_example(logits, targets, input_lengths, target_lengths,
                                blank_token).mean()


# ----- schedule and optimizer --------------------------------------------------


def warmup_cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                           min_lr_ratio: float = 0.1) -> Callable[[int], float]:
    """Learning rate of update `count` (0-indexed): linear warmup to
    base_lr over warmup_steps, then cosine decay to min_lr_ratio * base_lr
    at total_steps; update k uses step k + 1. Evaluated in fp32, as the
    JAX schedule is."""
    f32 = np.float32

    def schedule(count: int) -> float:
        step = f32(count + 1)
        warm = step / f32(max(warmup_steps, 1))
        progress = min((step - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1)),
                       f32(1.0))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(progress) * f32(3.14159)))  # the reference's pi
        decay = f32(min_lr_ratio) + (f32(1) - f32(min_lr_ratio)) * cosine
        return float(f32(base_lr) * (warm if step < warmup_steps else decay))

    return schedule


def lr_horizon(config: TrainingConfig) -> int:
    """The cosine horizon in updates (JAX ``make_optimizer``)."""
    if config.lr_total_steps is not None:
        return config.lr_total_steps
    if config.lr_parity_horizon:
        return config.max_steps
    return max(1, config.max_steps // config.gradient_accumulation_steps)


class Optimizer:
    """optax ``MultiSteps(chain(clip_by_global_norm(c), adamw(schedule,
    weight_decay=w)), k)`` over a list of fp32 parameters, updated in
    place.

    ``step(grads)`` takes one micro-batch's gradients. With k > 1 it keeps
    their running mean (acc + (g - acc) / (n + 1)) and updates on every
    k-th call; the update clips the mean by its global norm, runs Adam
    (bias-corrected moments), adds weight_decay * p and scales by
    -schedule(updates so far).
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: List[torch.Tensor], config: TrainingConfig):
        self.params = list(params)
        self.config = config
        self.every = max(config.gradient_accumulation_steps, 1)
        self.schedule = warmup_cosine_schedule(config.learning_rate, config.warmup_steps,
                                               lr_horizon(config))
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = [torch.zeros_like(p) for p in self.params] if self.every > 1 else None
        self.count = 0  # updates applied (optax's adam and schedule counts)
        self.mini_step = 0  # micro-batches accumulated since the last update

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> bool:
        """Take one micro-batch's gradients; True if the parameters moved.
        Runs as a few multi-tensor (``torch._foreach_*``) launches."""
        grads = [g.to(torch.float32) for g in grads]
        if self.acc is not None:
            n = self.mini_step
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, float(n + 1))
            torch._foreach_add_(self.acc, diff)
            if n + 1 < self.every:
                self.mini_step = n + 1
                return False
            grads = [acc.clone() for acc in self.acc]
            torch._foreach_zero_(self.acc)
            self.mini_step = 0
        # clip as optax does: t / norm * max once norm reaches max (no sync)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        max_norm = torch.full((), self.config.grad_clip_norm, dtype=torch.float32,
                              device=norm.device)
        keep = norm < max_norm
        one = torch.ones((), dtype=torch.float32, device=norm.device)
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one, max_norm))
        self.count += 1
        f32 = np.float32
        c1 = float(f32(1) - f32(self.b1) ** f32(self.count))
        c2 = float(f32(1) - f32(self.b2) ** f32(self.count))
        lr = self.schedule(self.count - 1)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.b2)
        denom = torch._foreach_div(self.nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(self.mu, c1)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(update, self.params, alpha=self.config.weight_decay)
        torch._foreach_add_(self.params, update, alpha=-lr)
        return True

    def last_lr(self) -> float:
        """The rate of the most recent update (of the first before any)."""
        return self.schedule(max(self.count - 1, 0))

    def state_dict(self) -> Dict[str, Any]:
        return {"mu": self.mu, "nu": self.nu, "acc": self.acc, "count": self.count,
                "mini_step": self.mini_step}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for mine, theirs in (("mu", state["mu"]), ("nu", state["nu"]), ("acc", state["acc"])):
            if getattr(self, mine) is None:
                continue
            for dst, src in zip(getattr(self, mine), theirs):
                dst.copy_(src)
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])


# ----- trainer -----------------------------------------------------------------


def _unsupported(model_config, config: TrainingConfig) -> Optional[str]:
    """What the port cannot train yet, with the ROADMAP item it waits on."""
    checks = [
        (getattr(model_config, "qat", False), "QAT (ROADMAP module item 6)"),
        (getattr(model_config, "moe_experts", 0) > 0, "MoE (ROADMAP module item 8)"),
        (getattr(model_config, "num_languages", 0) > 0 or config.lid_loss_weight > 0,
         "the language-ID head and loss (ROADMAP module item 8)"),
        (config.num_model_shards > 1 or config.num_pipeline_stages > 1
         or config.num_data_shards not in (None, 1), "parallel training (ROADMAP module item 9)"),
    ]
    return next((what for bad, what in checks if bad), None)


def step_seed(seed: int, step: int) -> int:
    """The generator seed of micro-step `step` of a run seeded `seed`."""
    return (seed * 1_000_003 + step) % (1 << 63)


def _fork(rng: torch.Generator, stream: int) -> torch.Generator:
    """A generator of its own for one draw of a micro-step (stream 1:
    speed, 2: noise), seeded from `rng`'s seed, so turning an
    augmentation on leaves `rng`'s own draws (masks, dropout) as they
    were."""
    fork = torch.Generator(device=rng.device)
    fork.manual_seed((rng.initial_seed() * 1_000_003 + stream * 7_919) % (1 << 63))
    return fork


class Trainer:
    """Training loop over the offline CTC objective, plus the
    streaming-aware term with ``streaming_chunks`` (the JAX Trainer's).

    `model` is a ``VelocityASR`` on its device; `train_iter` yields
    collated numpy batches (``data.ASRCollator``, host mel or int16 PCM);
    `eval_batches` returns a
    fresh iterator of them; `seed` decides the dropout and SpecAugment
    draws. ``train_step`` / ``eval_step`` return host floats (one sync),
    ``train`` syncs once per log interval.
    """

    def __init__(self, model: torch.nn.Module, config: TrainingConfig,
                 train_iter: Iterator[Dict[str, Any]],
                 eval_batches: Optional[Callable[[], Iterator[Dict[str, Any]]]] = None,
                 seed: int = 0):
        why = _unsupported(model.config, config)
        if why:
            raise NotImplementedError(f"{why} is not ported yet")
        self.model = model
        self.config = config
        self.train_iter = train_iter
        self.eval_batches = eval_batches
        self.seed = seed
        self.device = next(model.parameters()).device
        self.params = list(model.parameters())
        self.optimizer = Optimizer(self.params, config)
        self.global_step = 0
        self.best_eval_loss = float("inf")
        self.data_wait_seconds = 0.0  # time train() spent waiting for batches

    # ----- steps ---------------------------------------------------------------

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {key: torch.as_tensor(np.asarray(batch[key])).to(self.device)
                for key in ("mel_spectrogram", "audio", "targets", "input_lengths",
                            "target_lengths") if key in batch}

    @staticmethod
    def _batch_mel(batch: Dict[str, torch.Tensor]):
        """(normalised mel, un-normalised mel or None): a host-mel batch as
        it came; a device-mel batch's waveform (``waveform`` if the
        augmentation made one, else the PCM scaled by 1/32768), its log-mel
        computed here and normalised over each utterance's valid frames."""
        if "audio" not in batch:
            return batch["mel_spectrogram"].to(torch.float32), None
        audio = batch.get("waveform")
        if audio is None:
            audio = batch["audio"].to(torch.float32) * (1.0 / 32768.0)
        raw = compute_mel_spectrogram(audio, normalize=False)
        return masked_normalize_mel(raw, batch["input_lengths"]), raw

    def _augment_waveform(self, batch: Dict[str, torch.Tensor],
                          rng: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """In training (`rng` given) with ``speed_perturb`` or
        ``noise_injection`` on: the batch with its waveform (the PCM scaled
        by 1/32768) speed-warped, which rescales ``input_lengths``, then
        noised over its (lengths - 1) * hop valid samples, each from its own
        fork of `rng`, as ``waveform``. Otherwise the batch as it is. On a
        host-mel batch either switch raises."""
        aug = self.config.augment
        if rng is None or aug is None or not aug.enabled or not (aug.speed_perturb
                                                                  or aug.noise_injection):
            return batch
        if "audio" not in batch:
            # a misconfiguration, not a fallback
            raise ValueError(
                "augmentation.noise_injection / speed_perturb require "
                "data.device_mel: true (both act on the waveform "
                "before the on-device mel front-end)")
        audio = batch["audio"].to(torch.float32) * (1.0 / 32768.0)
        lengths = batch["input_lengths"]
        if aug.speed_perturb:
            audio, lengths = speed_perturb_audio(audio, _fork(rng, 1), aug, lengths, HOP_LENGTH)
        if aug.noise_injection:
            audio = noise_inject(audio, _fork(rng, 2), aug, (lengths - 1) * HOP_LENGTH)
        return {**batch, "waveform": audio, "input_lengths": lengths}

    def _loss(self, batch: Dict[str, torch.Tensor], rng: Optional[torch.Generator]):
        """The micro-batch's loss; `rng` draws the augmentations and dropout
        (None: neither). With ``streaming_chunks`` and a device-mel batch,
        the streaming term is added in training and evaluation alike."""
        cfg = self.config
        batch = self._augment_waveform(batch, rng)
        mel, raw = self._batch_mel(batch)
        lengths = batch["input_lengths"]
        if cfg.streaming_chunks and raw is None and self.model.training:
            # a misconfiguration, not a fallback to the offline objective
            raise ValueError(
                "training.streaming_chunks requires data.device_mel: true "
                "(the streaming-aware objective needs raw mel on device)")
        aug = cfg.augment
        aug_state = None
        if rng is not None and aug is not None and aug.enabled:
            aug_state = rng.get_state()
            mel = spec_augment(mel, rng, aug, lengths)
        out_lengths = (lengths + 1) // 2

        def ctc(logits):
            return ctc_loss(logits, batch["targets"], out_lengths, batch["target_lengths"])

        loss = ctc(self.model(mel, rng=rng))
        if not cfg.streaming_chunks or raw is None:
            return loss
        smel = causal_normalize_mel(raw, lengths, cfg.streaming_chunks)
        if aug_state is not None:
            # the offline view's masks: a generator from the state its draws started at
            fork = torch.Generator(device=rng.device)
            fork.set_state(aug_state)
            smel = spec_augment(smel, fork, aug, lengths)
        s_loss = ctc(streaming_forward(self.model, smel, cfg.streaming_chunks, rng=rng))
        w = cfg.streaming_aux_weight
        return (1.0 - w) * loss + w * s_loss

    def _step(self, batch: Dict[str, Any]) -> torch.Tensor:
        """One micro-step; returns the loss as a device tensor (no sync)."""
        self.model.train()
        rng = torch.Generator(device=self.device)
        rng.manual_seed(step_seed(self.seed, self.global_step))
        loss = self._loss(self._to_device(batch), rng)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        self.optimizer.step(grads)
        self.global_step += 1
        return loss.detach()

    def train_step(self, batch: Dict[str, Any]) -> Dict[str, float]:
        loss = self._step(batch)
        return {"loss": float(loss), "lr": self.optimizer.last_lr()}

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, Any]) -> Dict[str, float]:
        self.model.eval()
        return {"eval_loss": float(self._loss(self._to_device(batch), None))}

    def evaluate(self) -> Dict[str, float]:
        if self.eval_batches is None:
            return {}
        losses = [self.eval_step(batch)["eval_loss"] for batch in self.eval_batches()]
        if not losses:
            # 0.0 would become the best eval loss and suppress every later
            # best-model checkpoint
            logger.warning("eval iterator yielded no batches; skipping eval")
            return {"eval_loss": float("inf")}
        return {"eval_loss": sum(losses) / len(losses)}

    # ----- loop ----------------------------------------------------------------

    def train(self) -> Dict[str, List[float]]:
        cfg = self.config
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        history: Dict[str, List[float]] = {"train_loss": [], "eval_loss": [], "lr": []}
        losses: List[torch.Tensor] = []
        t0 = t_loop = time.perf_counter()
        wait0, first = self.data_wait_seconds, self.global_step
        window = None
        try:
            for step in range(self.global_step, cfg.max_steps):
                if cfg.profile_dir is not None:
                    if step == cfg.profile_start:
                        window = self._start_profile()
                    elif window is not None and step == cfg.profile_start + cfg.profile_steps:
                        self._stop_profile(window)
                        window = None
                t_wait = time.perf_counter()
                batch = next(self.train_iter)
                self.data_wait_seconds += time.perf_counter() - t_wait
                if window is not None:
                    with torch.profiler.record_function(f"micro_step_{step}"):
                        losses.append(self._step(batch))
                else:
                    losses.append(self._step(batch))

                if (step + 1) % cfg.log_interval == 0:
                    avg = float(torch.stack(losses).mean())  # the interval's one sync
                    losses = []
                    lr = self.optimizer.last_lr()
                    dt = (time.perf_counter() - t0) / cfg.log_interval
                    logger.info("Step %d/%d | Loss: %.4f | LR: %.6f | %.3fs/step",
                                step + 1, cfg.max_steps, avg, lr, dt)
                    history["train_loss"].append(avg)
                    history["lr"].append(lr)
                    if cfg.metrics_path:
                        os.makedirs(os.path.dirname(os.path.abspath(cfg.metrics_path)),
                                    exist_ok=True)
                        with open(cfg.metrics_path, "a") as f:
                            f.write(json.dumps({"step": step + 1, "loss": avg, "lr": lr,
                                                "sec_per_step": dt}) + "\n")
                    t0 = time.perf_counter()

                if self.eval_batches and (step + 1) % cfg.eval_interval == 0:
                    eval_loss = self.evaluate()["eval_loss"]
                    history["eval_loss"].append(eval_loss)
                    logger.info("Eval Loss: %.4f", eval_loss)
                    if eval_loss < self.best_eval_loss:
                        self.best_eval_loss = eval_loss
                        self.save_checkpoint(os.path.join(cfg.checkpoint_dir, "best_model"))

                if (step + 1) % cfg.save_interval == 0:
                    self.save_checkpoint(os.path.join(cfg.checkpoint_dir,
                                                      f"checkpoint_step_{step + 1}"))
                    self._rotate_checkpoints()
        finally:
            if window is not None:  # a run that ends or fails inside the window
                self._stop_profile(window)
        logger.info("Trained %d micro-steps: data wait %.3f s of %.3f s",
                    cfg.max_steps - first, self.data_wait_seconds - wait0,
                    time.perf_counter() - t_loop)
        return history

    # ----- profiling -----------------------------------------------------------

    def _start_profile(self):
        """Open a ``torch.profiler`` window (CPU, and CUDA on the card) for
        micro-steps [profile_start, profile_start + profile_steps); each
        step in it runs inside a ``micro_step_<n>`` range."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)  # earlier steps' kernels stay out
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        logger.info("profiler trace started -> %s", self.config.profile_dir)
        return prof

    def _stop_profile(self, prof) -> str:
        """Close the window and write its Chrome trace into profile_dir;
        returns the trace's path."""
        cfg = self.config
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(cfg.profile_dir, exist_ok=True)
        path = os.path.join(cfg.profile_dir, f"trace_steps_{cfg.profile_start}_"
                                             f"{cfg.profile_start + cfg.profile_steps}.json")
        prof.export_chrome_trace(path)
        logger.info("profiler trace stopped -> %s", path)
        return path

    # ----- checkpoints ---------------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        """params and optimizer state (``state.pt``) and the JAX Trainer's
        ``trainer_meta.json`` keys."""
        path = os.path.abspath(path)
        os.makedirs(path, exist_ok=True)
        torch.save({"params": self.model.state_dict(),
                    "opt_state": self.optimizer.state_dict()},
                   os.path.join(path, "state.pt"))
        meta = {
            "global_step": self.global_step,
            "best_eval_loss": self.best_eval_loss,
            "training_config": dataclasses.asdict(self.config),
            "model_config": self.model.config.to_dict(),
        }
        with open(os.path.join(path, "trainer_meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
        logger.info("Saved checkpoint to %s", path)

    def load_checkpoint(self, path: str) -> None:
        path = os.path.abspath(path)
        payload = torch.load(os.path.join(path, "state.pt"), map_location=self.device,
                             weights_only=True)
        self.model.load_state_dict(payload["params"], strict=True)
        self.optimizer.load_state_dict(payload["opt_state"])
        with open(os.path.join(path, "trainer_meta.json")) as f:
            meta = json.load(f)
        self.global_step = int(meta["global_step"])
        self.best_eval_loss = float(meta["best_eval_loss"])
        logger.info("Loaded checkpoint from %s (step %d)", path, self.global_step)

    def _rotate_checkpoints(self) -> None:
        """Keep the newest keep_last ``checkpoint_step_*`` directories."""
        if self.config.keep_last <= 0:
            return
        pat = re.compile(r"checkpoint_step_(\d+)$")
        entries = sorted((int(m.group(1)), name) for name in os.listdir(self.config.checkpoint_dir)
                         if (m := pat.match(name)))
        for _, name in entries[: -self.config.keep_last]:
            shutil.rmtree(os.path.join(self.config.checkpoint_dir, name), ignore_errors=True)


# ----- metrics (velocity_asr_tpu/training.py compute_wer / compute_cer) ---------


def _edit_distance(pred: List[str], ref: List[str]) -> int:
    """Levenshtein distance via numpy row DP."""
    if not ref:
        return len(pred)
    ref_arr = np.array(ref)
    prev = np.arange(len(ref) + 1)
    for i, p in enumerate(pred, start=1):
        cur = np.empty(len(ref) + 1, dtype=np.int64)
        cur[0] = i
        sub = prev[:-1] + (ref_arr != p)
        for j in range(1, len(ref) + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, sub[j - 1])
        prev = cur
    return int(prev[-1])


def _error_rate(predictions: List[str], references: List[str], split) -> float:
    assert len(predictions) == len(references), (
        f"{len(predictions)} predictions vs {len(references)} references "
        "(a silent zip-truncation would understate the error rate)"
    )
    total_errors, total_units = 0, 0
    for pred, ref in zip(predictions, references):
        p, r = split(pred.lower()), split(ref.lower())
        total_errors += _edit_distance(p, r)
        total_units += len(r)
    return total_errors / total_units if total_units > 0 else 0.0


def compute_wer(predictions: List[str], references: List[str]) -> float:
    """Word error rate over lowercased, whitespace-split text."""
    return _error_rate(predictions, references, str.split)


def compute_cer(predictions: List[str], references: List[str]) -> float:
    """Character error rate over lowercased text."""
    return _error_rate(predictions, references, list)
