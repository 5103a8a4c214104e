"""The port's side of the parallel tests, run on every rank of a gloo
world that ``velocity_asr_tpu_torch.parallel.dryrun.spawn_world`` spawns
(so this module imports neither JAX nor the JAX package). Each suite
computes every port-side result a test module compares, once per world,
and returns them as numpy values; the inputs come from seeds, so the
test process rebuilds them for the JAX side."""


import numpy as np
import torch
import torch.distributed as dist

from velocity_asr_tpu_torch.augment import SpecAugmentConfig
from velocity_asr_tpu_torch.checkpoint import params_to_numpy
from velocity_asr_tpu_torch.models.config import VelocityASRConfig
from velocity_asr_tpu_torch.models.model import create_model
from velocity_asr_tpu_torch.models.ssm import LocalSSMProcessor
from velocity_asr_tpu_torch.parallel.dryrun import compare_step, one_rank
from velocity_asr_tpu_torch.parallel.mesh import create_mesh, shard_batch
from velocity_asr_tpu_torch.parallel.pp import pipeline_parallel
from velocity_asr_tpu_torch.parallel.sp_scan import (selective_scan_sequence_parallel,
                                                     selective_scan_sp_padded,
                                                     sequence_parallel)
from velocity_asr_tpu_torch.parallel.tp import (full_quant_stats, full_state_dict,
                                                shard_params_tp, unsharded)
from velocity_asr_tpu_torch.quantize import quant_stats_to_numpy
from velocity_asr_tpu_torch.training import Trainer, TrainingConfig

SMALL = dict(d_model=32, ssm_layers=2, ssm_state_dim=8, global_ssm_layers=1,
             global_ssm_state_dim=4, attention_heads=4, attention_dim=16, vocab_size=30,
             dropout=0.0, scan_mode="pallas", dtype="float32")
# The clip at 10 leaves these batches' gradients (norms 6.7-9.8) as they
# are: Adam's first step then sees gradients far above its eps, where the
# update rule of the tests holds whatever the order of a world's sums (at
# 1.0 the clip scales them by 0.1-0.15 and a quarter fall near eps). The
# sharded clip norm itself is held against one process (norm_gap).
TRAIN = dict(learning_rate=1e-3, warmup_steps=2, max_steps=4, grad_clip_norm=10.0,
             weight_decay=0.01, log_interval=100)
SP_LENGTHS = (64, 61, 62, 63)
PP_GRID = ((2, 2), (2, 4), (4, 2), (4, None))


def small_model(seed: int = 1, **overrides):
    return create_model(VelocityASRConfig(**{**SMALL, **overrides}), device="cpu",
                        generator=torch.Generator().manual_seed(seed))


def scan_inputs(seed: int, length: int, batch: int = 2, d_inner: int = 8, n: int = 4):
    """(x, dt, A, B, C, D) as numpy fp32, the JAX test's distributions."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, length, d_inner)).astype(np.float32),
            (np.abs(rng.standard_normal((batch, length, d_inner))) * 0.4).astype(np.float32),
            -np.arange(1, n + 1, dtype=np.float32),
            rng.standard_normal((batch, length, n)).astype(np.float32),
            rng.standard_normal((batch, length, n)).astype(np.float32),
            rng.standard_normal((d_inner,)).astype(np.float32))


def batch(seed: int, frames: int = 48, lengths=(48, 40), target_lengths=(8, 6), vocab: int = 30):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((len(lengths), frames, 80)).astype(np.float32)
    for i, n in enumerate(lengths):
        mel[i, n:] = 0.0
    targets = np.full((len(lengths), 16), 2, np.int32)
    for i, n in enumerate(target_lengths):
        targets[i, :n] = rng.integers(3, vocab, n)
    return {"mel_spectrogram": mel, "targets": targets,
            "input_lengths": np.asarray(lengths, np.int32),
            "target_lengths": np.asarray(target_lengths, np.int32)}


def qat_batch() -> dict:
    """The QAT steps' 4-row batch (the TP step's). Its rows span other
    ranges: a shard's observers differ from the whole batch's, which the
    tests assert on every rank."""
    return batch(5, vocab=64, lengths=(48, 40, 44, 36), target_lengths=(8, 6, 7, 5))


def qat_three() -> dict:
    """The padded QAT step's 3-row batch."""
    return batch(9, vocab=64, lengths=(48, 40, 30), target_lengths=(8, 6, 5))


def qat_grad_batch(rows: int, frames: int = 48) -> dict:
    """A `rows`-row batch for the QAT gradient comparisons. Fake
    quantization rounds each activation to a code, so a QAT gradient
    equals the one process's only where every rank's activations round as
    the one process's: on the CPU a call on one row rounds otherwise than
    a call on several (2.3e-6 on the logits), codes at a boundary flip
    and a gradient moves by up to 1.5e-3 of its max. So the comparisons
    give every rank, and every pipeline microbatch, two rows or more."""
    lengths = tuple(frames - 2 * i for i in range(rows))
    return batch(13, frames=frames, lengths=lengths, vocab=64,
                 target_lengths=tuple(8 - i % 4 for i in range(rows)))


def qat_model(seed: int = 4, **overrides):
    """The SMALL model with QAT on and a 64-token head (it splits over 2
    model ranks)."""
    return small_model(seed=seed, **{"vocab_size": 64, "qat": True, **overrides})


def mel(seed: int, rows: int, frames: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((rows, frames, 80)).astype(np.float32)


def grads_vs_one_process(make_model, cfg: TrainingConfig, b, mesh=None) -> dict:
    """``dryrun.compare_step`` of one micro-batch over this world's mesh
    (`cfg`'s, or `mesh`) against one process, in training mode."""
    return compare_step(Trainer(make_model(), cfg, iter(()), mesh=mesh),
                        one_rank(make_model(), cfg), b)


def _tensors(arrays):
    return [torch.tensor(a) for a in arrays]


def parallel_suite(tmp: str) -> dict:
    """Everything tests/test_torch_parallel.py compares, on this rank of
    a world of 2 or 4 (the data axis every rank; TP and EP meshes
    (world / 2, 2))."""
    world, rank = dist.get_world_size(), dist.get_rank()
    out = {"rank": rank}
    # the sequence-parallel scan and its gradient
    mesh = create_mesh()
    with torch.no_grad():
        for length in SP_LENGTHS:
            args = _tensors(scan_inputs(length, length))
            fn = selective_scan_sequence_parallel if length % world == 0 else \
                selective_scan_sp_padded
            out[f"sp_{length}"] = fn(*args, mesh).numpy()
    args = [t.requires_grad_(True) for t in _tensors(scan_inputs(7, 64))]
    w = torch.tensor(np.random.default_rng(8).standard_normal((2, 64, 8)).astype(np.float32))
    loss = (selective_scan_sp_padded(*args, mesh) * w).sum()
    out["sp_grads"] = [g.numpy() for g in torch.autograd.grad(loss, args)]
    # model-level SP: every scan of the model sharded
    sp_model = small_model(seed=2, vocab_size=37, scan_mode="sp")
    with torch.no_grad(), sequence_parallel(mesh):
        out["sp_logits"] = sp_model.eval()(torch.tensor(mel(2, 2, 120))).numpy()

    # tensor parallelism: the head over the vocabulary on a (world/2, 2) mesh
    tp_mesh = create_mesh(world // 2, 2)
    tp_model = small_model(seed=3, ssm_layers=1, vocab_size=256)
    shard_params_tp(tp_model, tp_mesh)
    out["tp_head_rows"] = tp_model.ctc_head.proj.weight.shape[0]
    with torch.no_grad():
        out["tp_logits"] = tp_model.eval()(torch.tensor(mel(0, 2, 64))).numpy()
    tp_cfg = TrainingConfig(**TRAIN, num_data_shards=world // 2, num_model_shards=2)
    trainer = Trainer(small_model(seed=4, vocab_size=64), tp_cfg, iter(()))
    out["tp_step"] = trainer.train_step(batch(5, vocab=64, lengths=(48, 40, 44, 36),
                                              target_lengths=(8, 6, 7, 5)))
    out["tp_params"] = _numpy_tree(trainer.model, trainer.mesh)
    trainer.save_checkpoint(f"{tmp}/tp_ckpt")
    out["tp_saved"] = {k: v.numpy() for k, v in full_state_dict(trainer.model,
                                                                 trainer.mesh).items()}

    # expert parallelism (and data parallelism of a MoE model, global aux)
    moe = dict(moe_experts=4, moe_top_k=2)
    ep_model = small_model(seed=6, **moe)
    shard_params_tp(ep_model, tp_mesh)
    out["ep_experts"] = ep_model.local_ssm.layers[0].moe.w_in.shape[0]
    with torch.no_grad():
        out["ep_logits"] = ep_model.eval()(torch.tensor(mel(6, 2, 64))).numpy()
    moe_batch = batch(7, lengths=(48, 40, 44, 36), target_lengths=(8, 6, 7, 5))
    ep_cfg = TrainingConfig(**TRAIN, moe_aux_weight=0.5, num_data_shards=world // 2,
                            num_model_shards=2)
    trainer = Trainer(small_model(seed=6, **moe), ep_cfg, iter(()))
    out["ep_step"] = trainer.train_step(moe_batch)
    out["ep_params"] = _numpy_tree(trainer.model, trainer.mesh)
    trainer.save_checkpoint(f"{tmp}/ep_ckpt")
    out["ep_saved"] = {k: v.numpy() for k, v in full_state_dict(trainer.model,
                                                                 trainer.mesh).items()}
    dp_moe = Trainer(small_model(seed=6, **moe),
                     TrainingConfig(**TRAIN, moe_aux_weight=0.5, num_data_shards=world),
                     iter(()))
    out["dp_moe_step"] = dp_moe.train_step(moe_batch)
    out["dp_moe_params"] = _numpy_tree(dp_moe.model, dp_moe.mesh)

    # data parallelism with padding: 3 rows over the data axis
    dp = Trainer(small_model(seed=8), TrainingConfig(**TRAIN, num_data_shards=world), iter(()))
    three = batch(9, lengths=(48, 40, 30), target_lengths=(8, 6, 5))
    out["dp3_step"] = dp.train_step(three)
    out["dp3_params"] = _numpy_tree(dp.model, dp.mesh)

    # the one-process gradients on every rank, dropout and SpecAugment on
    aug = SpecAugmentConfig(enabled=True, time_mask_frames=8, freq_mask_bins=6)
    drop = dict(dropout=0.1)
    four = batch(10, lengths=(48, 40, 44, 36), target_lengths=(8, 6, 7, 5))
    out["grad_dp"] = grads_vs_one_process(
        lambda: small_model(seed=11, **drop), TrainingConfig(**TRAIN, augment=aug,
                                                             num_data_shards=world), four)
    out["grad_dp_pad"] = grads_vs_one_process(
        lambda: small_model(seed=11, **drop), TrainingConfig(**TRAIN, augment=aug,
                                                             num_data_shards=world), three)
    out["grad_tp"] = grads_vs_one_process(
        lambda: small_model(seed=12, vocab_size=64, **drop),
        TrainingConfig(**TRAIN, augment=aug, num_data_shards=world // 2, num_model_shards=2),
        batch(13, vocab=64, lengths=(48, 40, 44, 36), target_lengths=(8, 6, 7, 5)))
    out["grad_ep"] = grads_vs_one_process(
        lambda: small_model(seed=14, **moe, **drop),
        TrainingConfig(**TRAIN, augment=aug, moe_aux_weight=0.5, num_data_shards=world // 2,
                       num_model_shards=2), four)
    out.update(qat_suite(tmp, world))
    return out


def own_rows_stats(model, b: dict, mesh) -> dict:
    """The observers of `model` (no groups) after a training forward of
    this rank's rows of `b` alone: what they held before they reduced over
    the data axis, the control a test of the reduction must differ from."""
    rows, _, _ = shard_batch(mesh, b)
    model.train()
    with torch.no_grad():
        model(torch.tensor(rows["mel_spectrogram"]))
    return quant_stats_to_numpy(model)


def qat_suite(tmp: str, world: int) -> dict:
    """QAT over the mesh: micro-steps over the data axis (4 rows, and 3
    padded), over a (world/2, 2) mesh with the head sharded, its
    checkpoint, and every rank's gradients and observers against one
    process (dropout and SpecAugment on)."""
    out = {}
    four = qat_batch()
    dp = Trainer(qat_model(), TrainingConfig(**TRAIN, num_data_shards=world), iter(()))
    out["qat_dp_step"] = dp.train_step(four)
    out["qat_dp_params"] = _numpy_tree(dp.model, dp.mesh)
    out["qat_dp_stats"] = _stats_tree(dp.model, dp.mesh)
    out["qat_dp_own_rows"] = own_rows_stats(qat_model(), four, dp.mesh)
    dp3 = Trainer(qat_model(), TrainingConfig(**TRAIN, num_data_shards=world), iter(()))
    out["qat_dp3_step"] = dp3.train_step(qat_three())
    out["qat_dp3_params"] = _numpy_tree(dp3.model, dp3.mesh)
    out["qat_dp3_stats"] = _stats_tree(dp3.model, dp3.mesh)

    tp_cfg = TrainingConfig(**TRAIN, num_data_shards=world // 2, num_model_shards=2)
    tp = Trainer(qat_model(), tp_cfg, iter(()))
    out["qat_tp_local_stats"] = tuple(tp.model.ctc_head.proj.weight_quantizer.scale.shape)
    out["qat_tp_step"] = tp.train_step(four)
    out["qat_tp_params"] = _numpy_tree(tp.model, tp.mesh)
    out["qat_tp_stats"] = _stats_tree(tp.model, tp.mesh)
    tp.save_checkpoint(f"{tmp}/tp_qat_ckpt")
    out["qat_tp_saved"] = {k: v.numpy() for k, v in full_state_dict(tp.model, tp.mesh).items()}
    out["qat_tp_saved_stats"] = {k: v.numpy() for k, v in
                                 full_quant_stats(tp.model, tp.mesh).items()}
    # the one-rank layout read back into a sharded Trainer: the same full stats
    back = Trainer(qat_model(seed=0), tp_cfg, iter(()))
    back.load_checkpoint(f"{tmp}/tp_qat_ckpt")
    out["qat_tp_reloaded_stats"] = {k: v.numpy() for k, v in
                                    full_quant_stats(back.model, back.mesh).items()}

    aug = SpecAugmentConfig(enabled=True, time_mask_frames=8, freq_mask_bins=6)
    drop = dict(dropout=0.1)
    out["grad_qat_dp"] = grads_vs_one_process(
        lambda: qat_model(seed=11, **drop),
        TrainingConfig(**TRAIN, augment=aug, num_data_shards=world), qat_grad_batch(2 * world))
    out["grad_qat_dp_pad"] = grads_vs_one_process(
        lambda: qat_model(seed=11, **drop),
        TrainingConfig(**TRAIN, augment=aug, num_data_shards=world),
        qat_grad_batch(2 * world - 1))
    out["grad_qat_tp"] = grads_vs_one_process(
        lambda: qat_model(seed=12, **drop),
        TrainingConfig(**TRAIN, augment=aug, num_data_shards=world // 2, num_model_shards=2),
        qat_grad_batch(2 * world))
    return out


def _numpy_tree(model, mesh) -> dict:
    """The model's full parameters as the flax tree (slices gathered)."""
    with unsharded(model, mesh):
        return params_to_numpy(model)


def _stats_tree(model, mesh) -> dict:
    """The model's observers as the flax quant_stats tree (slices
    gathered)."""
    with unsharded(model, mesh):
        return quant_stats_to_numpy(model)


def stack(num_layers: int = 4, seed: int = 0, **kw) -> LocalSSMProcessor:
    """The JAX test_pp stack: d_model 16, state 8, dropout 0 (kw
    overrides), initialised from a seeded generator."""
    from velocity_asr_tpu_torch.models.model import init_parameters

    kw.setdefault("dropout", 0.0)
    mod = LocalSSMProcessor(d_model=16, num_layers=num_layers, state_dim=8, **kw)
    return init_parameters(mod, torch.Generator().manual_seed(seed))


def stack_input(batch_size: int = 4, t: int = 24) -> np.ndarray:
    return np.random.default_rng(0).standard_normal((batch_size, t, 16)).astype(np.float32)


PP_TINY = dict(d_model=32, ssm_layers=4, ssm_state_dim=8, global_ssm_layers=1,
               global_ssm_state_dim=4, attention_heads=2, attention_dim=8, vocab_size=64,
               dropout=0.0, scan_mode="pallas", dtype="float32")


def pp_model(seed: int = 0, **kw):
    return create_model(VelocityASRConfig(**{**PP_TINY, **kw}), device="cpu",
                        generator=torch.Generator().manual_seed(seed))


def pp_suite() -> dict:
    """Everything tests/test_torch_pp.py compares, on this rank of a
    world of 4: the stack over 2 stages (a (2, 2) mesh) and over 4."""
    world = dist.get_world_size()
    out = {"rank": dist.get_rank()}
    meshes = {2: create_mesh(world // 2, 2), 4: create_mesh(1, 4)}
    x = torch.tensor(stack_input())
    for stages, m in PP_GRID:
        mod = stack()
        with torch.no_grad(), pipeline_parallel(meshes[stages], microbatches=m):
            out[f"fwd_{stages}_{m}"] = mod(x).numpy()
    for remat in (False, True):
        mod = stack(checkpoint=remat)
        params = list(mod.parameters())
        with pipeline_parallel(meshes[2], microbatches=4 if not remat else None):
            y = mod(x)
            g = torch.autograd.grad((y ** 2).sum(), params)
        with torch.no_grad(), pipeline_parallel(meshes[2]):
            out[f"remat_fwd_{remat}"] = mod(x).numpy()
        out[f"grads_{remat}"] = {n: t.numpy() for (n, _), t in zip(mod.named_parameters(), g)}
    model = pp_model()
    with torch.no_grad(), pipeline_parallel(meshes[2]):
        out["model_logits"] = model.eval()(torch.tensor(mel(1, 4, 64))).numpy()
    # a Trainer step with two stages, beside the plain step on the same mesh
    cfg = TrainingConfig(**TRAIN, num_pipeline_stages=2, pipeline_microbatches=2)
    b = batch(2, frames=32, lengths=(32, 30, 28, 32), target_lengths=(6, 6, 5, 6), vocab=64)
    trainer = Trainer(pp_model(), cfg, iter(()), mesh=meshes[2])
    out["trainer_loss"] = trainer.train_step(b)["loss"]
    out["trainer_params"] = _numpy_tree(trainer.model, trainer.mesh)
    drop = Trainer(pp_model(dropout=0.1), TrainingConfig(**TRAIN, num_pipeline_stages=2),
                   iter(()), mesh=meshes[2])
    out["dropout_loss"] = drop.train_step(b)["loss"]
    # the one-process gradients on every rank, 4 stages and 2 (with data 2)
    out["grad_pp4"] = grads_vs_one_process(
        lambda: pp_model(seed=3), TrainingConfig(**TRAIN, num_pipeline_stages=4,
                                                 pipeline_microbatches=4), b)
    out["grad_pp2_dp2"] = grads_vs_one_process(
        lambda: pp_model(seed=3), TrainingConfig(**TRAIN, num_data_shards=2,
                                                 num_pipeline_stages=2), b)
    # QAT: the observers sit outside the pipelined stack, on every stage;
    # 8 rows, so that every microbatch holds two (qat_grad_batch)
    eight = qat_grad_batch(8, frames=32)
    out["grad_qat_pp4"] = grads_vs_one_process(
        lambda: pp_model(seed=3, qat=True), TrainingConfig(**TRAIN, num_pipeline_stages=4,
                                                           pipeline_microbatches=4), eight)
    out["grad_qat_pp2_dp2"] = grads_vs_one_process(
        lambda: pp_model(seed=3, qat=True), TrainingConfig(**TRAIN, num_data_shards=2,
                                                           num_pipeline_stages=2), eight)
    # streaming ignores the context
    mod = stack()
    with torch.no_grad(), pipeline_parallel(meshes[2]):
        y, states = mod(x[:2], return_state=True)
    out["stream"] = (y.numpy(), [{k: v.numpy() for k, v in s.items()} for s in states])
    return out


def train_step_world(overrides: dict, b: dict) -> float:
    """One micro-step of the SMALL model over this world with the given
    TrainingConfig fields: the step's global loss."""
    return Trainer(small_model(seed=0), TrainingConfig(**overrides), iter(())).train_step(b)[
        "loss"]
