"""Self-supervised masked-spectrogram pretraining, Stage 1 (mirrors
velocity_asr_tpu/pretrain.py and its CLI, scripts/pretrain.py), and the
hand-off to the Stage-2 supervised fine-tune.

- Span masking: each valid frame starts a span with probability
  ``span_probability``, each start covering ``span_length`` frames
  (clipped to the valid frames); masked frames are replaced by a learned
  ``mask_embedding`` (a mel-space vector).
- Frequency band masking: with probability ``frequency_mask_prob`` an
  utterance gets one band of U[band_min, band_max] bins zeroed in the
  input; the target is the unmasked normalised mel.
- ``MaskedPredictor``: the VelocityASR backbone under its module names
  (``temporal_binding``, ``local_ssm``, ``global_context``: the flax tree
  is the JAX package's), then a ``recon_head`` Dense predicting the two
  input frames behind each stride-2 output frame. ``PretrainTrainer``
  trains it with the MSE over masked valid frames on the port's
  ``Trainer`` runtime; on the card its device-mel batches run the log-mel
  kernel and its scans the training scan kernels.
- The masks are drawn from an explicit ``torch.Generator`` (the JAX
  package draws from ``jax.random``: the same laws, other bits).
- ``save_pretrain_artifact`` writes the ``save_pretrained`` layout tagged
  ``objective: masked_prediction`` with the masking config;
  ``init_asr_from_backbone`` drops its backbone into a fresh VelocityASR
  (a fresh CTC head), which ``train --init-from`` uses.

    python -m velocity_asr_tpu_torch.pretrain --config configs/pretrain.yaml \\
        --model-config configs/model_synth.yaml [--max-steps N] [--batch-size N] \\
        [--synthetic N] [--checkpoint-dir DIR] [--resume CKPT] [--device cuda]

It writes ``final_model/`` (the trainer checkpoint) and
``final_backbone/`` (the artifact) under the checkpoint directory; then
``python -m velocity_asr_tpu_torch.train --config configs/finetune.yaml
--model-config configs/model_synth.yaml --init-from DIR/final_backbone``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .checkpoint import params_to_numpy, qat_params_tree, read_params
from .device import resolve_device
from .models.attention import HierarchicalGlobalContext
from .models.config import VelocityASRConfig
from .models.layers import Dense, TemporalBindingLayer
from .models.ssm import LocalSSMProcessor
from .parallel.mesh import sharded_draw
from .training import Trainer, TrainingConfig

logger = logging.getLogger(__name__)

#: The parameter subtrees MaskedPredictor and VelocityASR share.
BACKBONE_KEYS = ("temporal_binding", "local_ssm", "global_context")
PRETRAIN_OBJECTIVE = "masked_prediction"
#: the seed of the masks an evaluation draws (the same every run)
EVAL_MASK_SEED = 0


@dataclass
class MaskedPredictionConfig:
    """The masking hyperparameters (the reference's pretraining block)."""

    span_probability: float = 0.15
    span_length: int = 10  # frames (100 ms at the 10 ms hop)
    frequency_mask_prob: float = 0.3
    frequency_band_min: int = 5
    frequency_band_max: int = 10

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def sample_time_mask(rng: torch.Generator, batch: int, t_len: int,
                     input_lengths: torch.Tensor, config: MaskedPredictionConfig) -> torch.Tensor:
    """(batch, T) bool: Bernoulli(span_probability) starts on valid frames,
    each dilated to span_length frames (frame t is masked when a start
    lies in (t - span, t]: a difference of padded cumulative sums), then
    clipped to the valid frames. Drawn on `rng`'s device."""
    device = rng.device
    lengths = torch.as_tensor(input_lengths, device=device)
    valid = torch.arange(t_len, device=device)[None, :] < lengths[:, None]
    starts = (sharded_draw(lambda s: torch.rand(s, generator=rng, device=device),
                           (batch, t_len)) < config.span_probability) & valid
    c = torch.cumsum(starts.to(torch.int32), dim=1)
    lagged = F.pad(c, (config.span_length, 0))[:, :t_len]
    return ((c - lagged) > 0) & valid


def sample_freq_mask(rng: torch.Generator, batch: int, n_mels: int,
                     config: MaskedPredictionConfig) -> torch.Tensor:
    """(batch, n_mels) bool: with probability frequency_mask_prob per row,
    one band of U[band_min, band_max] bins (capped at n_mels) at a uniform
    start."""
    device = rng.device
    apply = sharded_draw(lambda s: torch.rand(s, generator=rng, device=device),
                         (batch, 1)) < config.frequency_mask_prob
    widths = sharded_draw(lambda s: torch.randint(config.frequency_band_min,
                                                  config.frequency_band_max + 1, s,
                                                  generator=rng, device=device), (batch, 1))
    widths = torch.clamp(widths, max=n_mels)
    max_start = torch.clamp(n_mels - widths + 1, min=1)
    starts = sharded_draw(lambda s: torch.randint(0, 2 ** 30, s, generator=rng, device=device),
                          (batch, 1)) % max_start
    pos = torch.arange(n_mels, device=device)[None, :]
    return (pos >= starts) & (pos < starts + widths) & apply


class MaskedPredictor(nn.Module):
    """The VelocityASR backbone and a reconstruction head: (batch, T,
    mel_bins) -> fp32 predictions (batch, 2 * ceil(T / 2), mel_bins), the
    time-masked frames (``time_mask`` (batch, T) bool) replaced by the
    mask embedding first. In training mode dropout draws from `rng`."""

    def __init__(self, config: VelocityASRConfig):
        super().__init__()
        self.config = cfg = config
        dtype = cfg.compute_dtype
        qat = {"qat": cfg.qat, "qat_bits": (cfg.qat_weight_bits, cfg.qat_activation_bits)}
        self.mask_embedding = nn.Parameter(torch.zeros(cfg.mel_bins))
        self.temporal_binding = TemporalBindingLayer(cfg.mel_bins, cfg.d_model, dtype=dtype,
                                                     **qat)
        self.local_ssm = LocalSSMProcessor(
            cfg.d_model, cfg.ssm_layers, cfg.ssm_state_dim, cfg.ssm_expand_ratio,
            cfg.ssm_kernel_size, cfg.scan_mode, dtype, cfg.dropout,
            checkpoint=cfg.gradient_checkpointing)
        self.global_context = HierarchicalGlobalContext(
            cfg.d_model, cfg.attention_heads, cfg.attention_dim, cfg.global_ssm_layers,
            cfg.global_ssm_state_dim, cfg.scan_mode, dtype, dropout=cfg.dropout,
            int8=cfg.int8_inference, int8_static=cfg.int8_static, **qat)
        self.recon_head = Dense(cfg.d_model, 2 * cfg.mel_bins, dtype=dtype)

    def forward(self, mel_spectrogram: torch.Tensor, time_mask: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        mel = mel_spectrogram
        if time_mask is not None:
            mel = torch.where(time_mask[:, :, None], self.mask_embedding.to(mel.dtype), mel)
        local = self.local_ssm(self.temporal_binding(mel), rng=rng)
        pred = self.recon_head(self.global_context(local, rng=rng))
        b, t2, _ = pred.shape
        # output frame t covers input frames (2t, 2t + 1)
        return pred.reshape(b, t2 * 2, self.config.mel_bins).to(torch.float32)


def create_pretrain_model(config: Optional[VelocityASRConfig] = None, device="cuda",
                          generator: Optional[torch.Generator] = None) -> MaskedPredictor:
    """A freshly initialised ``MaskedPredictor`` on `device`: the backbone
    as ``models.model.init_parameters`` draws it, ``recon_head`` flax's
    default (lecun-normal, bias 0), ``mask_embedding`` N(0, 0.02); draws
    from `generator` (a CPU generator; None: seeded with 0)."""
    from .models.model import init_parameters, lecun_normal_

    device = resolve_device(device)
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    model = init_parameters(MaskedPredictor(config or VelocityASRConfig()), generator)
    with torch.no_grad():
        lecun_normal_(model.recon_head.weight, generator)
        nn.init.normal_(model.mask_embedding, std=0.02, generator=generator)
    return model.to(device)


def masked_prediction_loss(pred: torch.Tensor, target_mel: torch.Tensor,
                           time_mask: torch.Tensor, input_lengths: torch.Tensor,
                           n_valid=None, shard=None) -> torch.Tensor:
    """MSE over masked valid frames (the mean over mel bins a frame), the
    prediction cut to the target's T frames; n_valid masks batch rows past
    it. Under data parallelism `shard` (a ``parallel.mesh.DataShard``)
    masks the padding rows and counts the frames over the global batch."""
    b, t, _ = target_mel.shape
    pred = pred[:, :t, :]
    lengths = torch.as_tensor(input_lengths, device=pred.device)
    valid = torch.arange(t, device=pred.device)[None, :] < lengths[:, None]
    w = (time_mask & valid).to(torch.float32)
    if n_valid is not None:
        w = w * (torch.arange(b, device=pred.device) < n_valid)[:, None].to(torch.float32)
    count = w.sum()
    if shard is not None:
        w = w * shard.row_mask(pred.device)[:, None].to(torch.float32)
        count = shard.total(w.sum())
    err = ((pred - target_mel.to(torch.float32)) ** 2).mean(dim=-1)
    return (err * w).sum() / torch.clamp(count, min=1.0)


class PretrainTrainer(Trainer):
    """``Trainer`` whose objective is masked-spectrogram prediction; batch
    labels are ignored. Training draws the masks from the micro-step's
    generator, evaluation from one seeded ``EVAL_MASK_SEED``."""

    def __init__(self, model: MaskedPredictor, config: TrainingConfig, train_iter,
                 eval_batches=None, mask_config: Optional[MaskedPredictionConfig] = None,
                 **kwargs):
        self.mask_config = mask_config or MaskedPredictionConfig()
        if getattr(model.config, "qat", False):
            raise ValueError(
                "QAT applies to the supervised fine-tune (Stage 2), not "
                "pretraining; run scripts/train.py with quantization.enabled"
            )
        if config.streaming_chunks:
            raise ValueError(
                "the streaming-aware objective is a fine-tune feature; "
                "pretraining does not support training.streaming_chunks"
            )
        aug = config.augment
        if aug is not None and aug.enabled and (aug.num_time_masks or aug.num_freq_masks):
            raise ValueError(
                "SpecAugment conflicts with the masked-prediction objective "
                "(its zero-masks corrupt the reconstruction target); use the "
                "masking: stanza instead. noise_injection alone is supported."
            )
        super().__init__(model, config, train_iter, eval_batches, **kwargs)

    def sample_masks(self, mel: torch.Tensor, input_lengths: torch.Tensor,
                     rng: Optional[torch.Generator]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(time mask (B, T), frequency mask (B, n_mels)) for a mel batch,
        from `rng` or, in evaluation (None), from a generator seeded
        ``EVAL_MASK_SEED`` on the mel's device."""
        if rng is None:
            rng = torch.Generator(device=mel.device)
            rng.manual_seed(EVAL_MASK_SEED)
        b, t, n_mels = mel.shape
        return (sample_time_mask(rng, b, t, input_lengths, self.mask_config),
                sample_freq_mask(rng, b, n_mels, self.mask_config))

    def _loss(self, batch: Dict[str, torch.Tensor], rng: Optional[torch.Generator],
              masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """The batch's masked-prediction loss; `masks` (time, frequency)
        replaces the drawn ones."""
        batch = self._augment_waveform(batch, rng)
        mel, _ = self._batch_mel(batch)
        lengths = batch["input_lengths"]
        time_mask, freq_mask = masks if masks is not None else self.sample_masks(mel, lengths,
                                                                                 rng)
        inputs = torch.where(freq_mask[:, None, :], torch.zeros_like(mel), mel)
        pred = self.model(inputs, time_mask=time_mask, rng=rng)
        return masked_prediction_loss(pred, mel, time_mask, lengths, shard=self._shard)


# ----- artifacts / the Stage-2 hand-off -----------------------------------------


def save_pretrain_artifact(save_path: str, config: VelocityASRConfig,
                           mask_config: MaskedPredictionConfig, model: MaskedPredictor) -> None:
    """{config, masking, params} in the ``save_pretrained`` layout, tagged
    ``objective: masked_prediction``."""
    from .models.model import save_pretrained

    save_pretrained(save_path, config, model,
                    extra={"objective": PRETRAIN_OBJECTIVE, "masking": mask_config.to_dict()})


def is_pretrain_artifact(path: str) -> bool:
    config_file = os.path.join(path, "config.json")
    if not os.path.exists(config_file):
        return False
    with open(config_file) as f:
        return json.load(f).get("objective") == PRETRAIN_OBJECTIVE


def load_pretrain_artifact(
        path: str) -> Tuple[VelocityASRConfig, MaskedPredictionConfig, Dict[str, Any]]:
    """(config, masking, the MaskedPredictor's flax parameter tree with
    numpy leaves) of a pretraining artifact."""
    from .models.model import CONFIG_FILE, PARAMS_FILE

    with open(os.path.join(path, CONFIG_FILE)) as f:
        payload = json.load(f)
    if payload.get("objective") != PRETRAIN_OBJECTIVE:
        raise ValueError(f"{path} is not a masked-prediction pretraining artifact")
    config = VelocityASRConfig.from_dict(payload.get("config", {}))
    mask_config = MaskedPredictionConfig(**payload.get("masking", {}))
    return config, mask_config, read_params(os.path.join(path, PARAMS_FILE))


_BACKBONE_DIMS = ("mel_bins", "d_model", "ssm_layers", "ssm_state_dim", "ssm_expand_ratio",
                  "ssm_kernel_size", "global_ssm_layers", "global_ssm_state_dim",
                  "attention_heads", "attention_dim")


def init_asr_from_backbone(model_cfg: VelocityASRConfig, pretrain_dir: str,
                           generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """The Stage-2 init, a flax parameter tree (numpy leaves) for
    `model_cfg`: a fresh VelocityASR's (``create_model`` with `generator`,
    a CPU generator; None: seeded with 0) with the artifact's backbone
    subtrees dropped in, so the CTC head (and nothing else) starts fresh.
    A QAT config gets the temporal-binding conv re-nested as
    ``conv/{kernel,bias}``. Mismatched dimensions raise, listing every
    one."""
    from .models.model import create_model

    pcfg, _, pparams = load_pretrain_artifact(pretrain_dir)
    mismatched = [f for f in _BACKBONE_DIMS if getattr(pcfg, f) != getattr(model_cfg, f)]
    if mismatched:
        raise ValueError(
            "pretrained backbone dims do not match the model config: "
            + ", ".join(f"{f} {getattr(pcfg, f)} != {getattr(model_cfg, f)}"
                        for f in mismatched))
    params = params_to_numpy(create_model(model_cfg, device="cpu", generator=generator))
    for key in BACKBONE_KEYS:
        params[key] = pparams[key]
    return qat_params_tree(params) if model_cfg.qat else params


# ----- the CLI (scripts/pretrain.py) ---------------------------------------------


def mask_config_from_yaml(masking: Optional[Dict[str, Any]]) -> MaskedPredictionConfig:
    """The ``masking:`` stanza (its tuple ``frequency_band_width`` [min,
    max] accepted); an unknown key raises."""
    d = dict(masking or {})
    band = d.pop("frequency_band_width", None)
    if band is not None:
        d["frequency_band_min"], d["frequency_band_max"] = int(band[0]), int(band[1])
    unknown = set(d) - {f.name for f in dataclasses.fields(MaskedPredictionConfig)}
    if unknown:
        raise ValueError(f"unknown masking config keys: {sorted(unknown)}")
    return MaskedPredictionConfig(**d)


def main(argv: Optional[List[str]] = None) -> dict:
    from .config import load_yaml, model_config_from_yaml, training_config_from_yaml
    from .data import cycle
    from .train import build_data

    parser = argparse.ArgumentParser(
        description="Pretrain the VELOCITY-ASR backbone (masked prediction, PyTorch port)")
    parser.add_argument("--config", default="configs/pretrain.yaml")
    parser.add_argument("--model-config", default="configs/model.yaml")
    parser.add_argument("--resume", default=None, help="trainer checkpoint to resume from")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--synthetic", type=int, default=None,
                        help="pretrain on N synthetic utterances (the unlabeled stream) "
                             "instead of the configured data")
    parser.add_argument("--checkpoint-dir", default=None,
                        help="override checkpoint.dir (metrics.jsonl moves beside it)")
    parser.add_argument("--num-workers", type=int, default=8,
                        help="data loader worker processes (0: load in this process)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(levelname)s | %(message)s")

    for flag, path, default in (("--config", args.config, "configs/pretrain.yaml"),
                                ("--model-config", args.model_config, "configs/model.yaml")):
        if path != default and not os.path.exists(path):
            parser.error(f"{flag} {path!r} does not exist")
    device = resolve_device(args.device)
    train_dict = load_yaml(args.config) if os.path.exists(args.config) else {}
    model_dict = load_yaml(args.model_config) if os.path.exists(args.model_config) else {}
    model_cfg = model_config_from_yaml(model_dict)
    train_cfg = training_config_from_yaml(train_dict)
    overrides = {"max_steps": args.max_steps, "batch_size": args.batch_size}
    train_cfg = dataclasses.replace(train_cfg, **{k: v for k, v in overrides.items()
                                                  if v is not None})
    if args.checkpoint_dir is not None:
        moved = {"checkpoint_dir": args.checkpoint_dir}
        if train_cfg.metrics_path:
            moved["metrics_path"] = os.path.join(args.checkpoint_dir,
                                                 os.path.basename(train_cfg.metrics_path))
        train_cfg = dataclasses.replace(train_cfg, **moved)
    try:
        mask_cfg = mask_config_from_yaml(train_dict.get("masking"))
    except ValueError as e:
        parser.error(str(e))
    if not train_cfg.use_amp and model_cfg.dtype != "float32":
        logger.info("use_amp disabled: forcing float32 compute")
        model_cfg = dataclasses.replace(model_cfg, dtype="float32")

    data_cfg = dict(train_dict.get("data") or {})
    if args.synthetic is not None:
        data_cfg["synthetic"] = args.synthetic
        data_cfg.setdefault("synthetic_split", "unlab")
    train_loader, eval_loader, _ = build_data(data_cfg, train_cfg.batch_size, args.num_workers,
                                              model_cfg.vocab_size)
    logger.info("Model config: %s", model_cfg)
    logger.info("Masking: %s", mask_cfg)

    model = create_pretrain_model(model_cfg, device=device)
    eval_batches = (lambda: iter(eval_loader)) if eval_loader is not None else None
    batches = cycle(train_loader)
    trainer = PretrainTrainer(model, train_cfg, batches, eval_batches, mask_config=mask_cfg)
    logger.info("Parameters: %s", f"{sum(p.numel() for p in model.parameters()):,}")
    if args.resume:
        trainer.load_checkpoint(args.resume)
    try:
        history = trainer.train()
    finally:
        batches.close()  # stops the loader's worker processes

    trainer.save_checkpoint(os.path.join(train_cfg.checkpoint_dir, "final_model"))
    backbone_dir = os.path.join(train_cfg.checkpoint_dir, "final_backbone")
    save_pretrain_artifact(backbone_dir, model_cfg, mask_cfg, model)
    logger.info("Pretraining complete. Fine-tune with: python -m velocity_asr_tpu_torch.train "
                "--init-from %s", backbone_dir)
    return {"history": history, "trainer": trainer}


if __name__ == "__main__":
    main()
