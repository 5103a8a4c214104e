"""The rest of training against the JAX package: the waveform augmentations
of device-mel batches, gradient checkpointing of the local SSM blocks, and
the trainer's profiler window.

- ``add_noise`` / ``warp_speed`` on the JAX functions' own draws
  (``noise_inject`` and ``speed_perturb_audio``, reproduced from the same
  key): the waveform within 1e-6, the new input lengths identical; the
  trainer applies them to device-mel batches in the JAX order (speed,
  then noise over the warped valid samples), each from a fork of the
  step's generator, and refuses them on host-mel batches.
- gradient checkpointing: with dropout 0.1 the checkpointed micro-step's
  loss and every gradient bit-equal to the plain one's (its dropout
  masks replayed); with dropout 0 against the JAX model with
  ``gradient_checkpointing=True``: loss within 1e-5 relative, each
  gradient within 1e-4 of its max|grad|; the scans it runs (the local
  blocks' first pass without bounds, every block recomputed with them).
- ``profile_dir``: a 3-micro-step run writes one Chrome trace covering
  exactly the configured window.
"""

import dataclasses
import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velocity_asr_tpu import augment as jaugment
from velocity_asr_tpu import training as jtraining
from velocity_asr_tpu.models import config as jconfig
from velocity_asr_tpu.models import model as jmodel
from velocity_asr_tpu_torch import augment as taugment
from velocity_asr_tpu_torch import data as tdata
from velocity_asr_tpu_torch import synth as tsynth
from velocity_asr_tpu_torch import training as ttraining
from velocity_asr_tpu_torch.audio import HOP_LENGTH
from velocity_asr_tpu_torch.checkpoint import _flatten, params_to_numpy
from velocity_asr_tpu_torch.models import model as tmodel
from velocity_asr_tpu_torch.models.config import VelocityASRConfig
from velocity_asr_tpu_torch.ops import scan as tscan

WAVE_ATOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
ZERO_GRAD = ("global_context", "cross_attention", "k_proj", "bias")
SMALL = dict(d_model=32, ssm_layers=2, ssm_state_dim=8, global_ssm_layers=1,
             global_ssm_state_dim=4, attention_heads=4, attention_dim=16, vocab_size=30,
             dropout=0.0, scan_mode="pallas", dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: under xdist the workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _audio_batch(seed, lengths=(9000, 6400, 12800), width=14400):
    """(batch, width) float32 waveforms, zero past each row's length, and
    their frame counts under the collator's rule 1 + samples // hop."""
    rng = np.random.default_rng(seed)
    audio = np.zeros((len(lengths), width), np.float32)
    for i, n in enumerate(lengths):
        audio[i, :n] = 0.3 * rng.standard_normal(n)
    frames = np.asarray([1 + n // HOP_LENGTH for n in lengths], np.int32)
    return audio, frames


AUG = taugment.SpecAugmentConfig(enabled=True, noise_injection=True, noise_min_snr_db=5.0,
                                 noise_max_snr_db=30.0, speed_perturb=True, speed_min=0.85,
                                 speed_max=1.15)


def _jax_aug():
    return jaugment.SpecAugmentConfig(**dataclasses.asdict(AUG))


@pytest.mark.parametrize("seed", [0, 1])
def test_noise_matches_jax_on_its_draws(seed):
    audio, frames = _audio_batch(seed)
    samples = (frames - 1) * HOP_LENGTH
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jaugment.noise_inject(jnp.asarray(audio), key, _jax_aug(),
                                           jnp.asarray(samples)))
    k1, k2 = jax.random.split(key)  # the JAX function's own draws
    snr = jax.random.uniform(k1, (3, 1), minval=AUG.noise_min_snr_db,
                             maxval=AUG.noise_max_snr_db)
    unit = jax.random.normal(k2, audio.shape, jnp.float32)
    ours = taugment.add_noise(torch.from_numpy(audio), torch.tensor(np.asarray(snr)),
                              torch.tensor(np.asarray(unit)), torch.from_numpy(samples))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=WAVE_ATOL)
    valid = np.arange(audio.shape[1])[None] < samples[:, None]
    np.testing.assert_array_equal(ours.numpy()[~valid], audio[~valid])  # padding untouched
    assert np.abs(ours.numpy() - audio)[valid].max() > 1e-3


@pytest.mark.parametrize("seed,lengths", [(0, (9000, 6400, 12800)), (1, (14400, 160, 5000))])
def test_speed_warp_matches_jax_on_its_draws(seed, lengths):
    """The warped waveform within 1e-6 and the new lengths identical; a
    row that fills its buffer cannot slow down."""
    audio, frames = _audio_batch(seed, lengths)
    key = jax.random.PRNGKey(10 + seed)
    ref, ref_len = jaugment.speed_perturb_audio(jnp.asarray(audio), key, _jax_aug(),
                                                jnp.asarray(frames), HOP_LENGTH)
    f = jax.random.uniform(key, (3, 1), minval=AUG.speed_min, maxval=AUG.speed_max)
    ours, ours_len = taugment.warp_speed(torch.from_numpy(audio), torch.tensor(np.asarray(f)),
                                         torch.from_numpy(frames), HOP_LENGTH)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=WAVE_ATOL)
    assert ours_len.dtype == torch.int32
    np.testing.assert_array_equal(ours_len.numpy(), np.asarray(ref_len))
    assert not np.array_equal(ours_len.numpy(), frames)


def test_draws_in_their_ranges():
    audio = torch.zeros(64, 100)
    gen = torch.Generator().manual_seed(0)
    snr, unit = taugment.draw_noise(gen, AUG, audio)
    f = taugment.draw_speed(gen, AUG, audio)
    assert snr.shape == f.shape == (64, 1) and unit.shape == audio.shape
    assert AUG.noise_min_snr_db <= snr.min() and snr.max() < AUG.noise_max_snr_db
    assert AUG.speed_min <= f.min() and f.max() < AUG.speed_max


def _small_model(seed=0, **overrides):
    cfg = VelocityASRConfig(**{**SMALL, **overrides})
    return tmodel.create_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def pcm_batch(tmp_path_factory):
    """A device-mel batch (int16 PCM) of 3 synthetic utterances."""
    ds = tsynth.SyntheticSpeechDataset(3, split="train", seed=1234, device_mel=True)
    return tdata.ASRCollator(frame_bucket=200)([ds[i] for i in range(3)])


def _to_device(batch):
    return {k: torch.as_tensor(np.asarray(batch[k])) for k in
            ("audio", "targets", "input_lengths", "target_lengths")}


def test_trainer_augments_device_mel_batches_in_jax_order(pcm_batch):
    """speed first (rescaling the lengths), then noise over the warped
    valid samples, each from its fork of the step's generator; the step's
    own generator is left as it was, so the masks and dropout draw what
    they draw without the waveform augmentations."""
    trainer = ttraining.Trainer(_small_model(), ttraining.TrainingConfig(augment=AUG), iter(()))
    batch = _to_device(pcm_batch)
    rng = torch.Generator().manual_seed(ttraining.step_seed(0, 5))
    before = rng.get_state()
    out = trainer._augment_waveform(batch, rng)
    assert torch.equal(rng.get_state(), before)
    audio = batch["audio"].to(torch.float32) / 32768.0
    want, lengths = taugment.speed_perturb_audio(audio, ttraining._fork(rng, 1), AUG,
                                                 batch["input_lengths"], HOP_LENGTH)
    want = taugment.noise_inject(want, ttraining._fork(rng, 2), AUG, (lengths - 1) * HOP_LENGTH)
    assert torch.equal(out["waveform"], want)
    assert torch.equal(out["input_lengths"], lengths)
    assert not torch.equal(lengths, batch["input_lengths"])
    loss = [ttraining.Trainer(_small_model(), ttraining.TrainingConfig(augment=AUG, warmup_steps=1),
                              iter(())).train_step(pcm_batch)["loss"] for _ in range(2)]
    assert np.isfinite(loss[0]) and loss[0] == loss[1]


@pytest.mark.parametrize("switch", ["noise_injection", "speed_perturb"])
def test_host_mel_batch_with_waveform_augmentation_raises(switch):
    aug = taugment.SpecAugmentConfig(enabled=True, **{switch: True})
    trainer = ttraining.Trainer(_small_model(), ttraining.TrainingConfig(augment=aug), iter(()))
    batch = {"mel_spectrogram": np.zeros((2, 64, 80), np.float32),
             "targets": np.full((2, 4), 5, np.int32),
             "input_lengths": np.asarray([64, 50], np.int32),
             "target_lengths": np.asarray([4, 3], np.int32)}
    with pytest.raises(ValueError, match="require data.device_mel: true"):
        trainer.train_step(batch)
    # evaluation applies no augmentation: the host-mel batch evaluates
    assert np.isfinite(trainer.eval_step(batch)["eval_loss"])


# ----- gradient checkpointing -------------------------------------------------------


def _host_batch(seed=3):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((2, 96, 80)).astype(np.float32)
    mel[1, 70:] = 0.0
    targets = np.full((2, 16), 2, np.int32)
    targets[0, :12] = rng.integers(3, 30, 12)
    targets[1, :9] = rng.integers(3, 30, 9)
    return {"mel_spectrogram": mel, "targets": targets,
            "input_lengths": np.asarray([96, 70], np.int32),
            "target_lengths": np.asarray([12, 9], np.int32)}


def _loss_and_grads(model, batch, seed):
    trainer = ttraining.Trainer(model, ttraining.TrainingConfig(), iter(()))
    model.train()
    rng = None if seed is None else torch.Generator().manual_seed(seed)
    loss = trainer._loss(trainer._to_device(batch), rng)
    return loss, torch.autograd.grad(loss, list(model.parameters()))


@pytest.mark.parametrize("batch_kind", ["host_mel", "device_mel"])
def test_checkpointing_bit_equal_with_dropout(batch_kind, pcm_batch):
    """Dropout 0.1: the checkpointed micro-step replays the first pass's
    masks, so its loss and every gradient equal the plain step's bit for
    bit (the same generator seed on both)."""
    batch = _host_batch() if batch_kind == "host_mel" else pcm_batch
    plain = _small_model(seed=2, dropout=0.1)
    remat = _small_model(seed=2, dropout=0.1, gradient_checkpointing=True)
    loss_a, grads_a = _loss_and_grads(plain, batch, seed=11)
    loss_b, grads_b = _loss_and_grads(remat, batch, seed=11)
    assert torch.equal(loss_a, loss_b)
    for (name, _), a, b in zip(plain.named_parameters(), grads_a, grads_b):
        assert torch.equal(a, b), name
    # the masks matter: another seed gives another loss
    assert not torch.equal(_loss_and_grads(plain, batch, seed=12)[0], loss_a)


def test_checkpointing_runs_the_planned_scans(monkeypatch):
    """A checkpointed micro-step runs the local blocks' first pass without
    bounds (no autograd), then every block's bounds forward (the local
    ones recomputed) and backward; evaluation runs no checkpoint."""
    calls = []
    for name in ("scan_fwd", "scan_fwd_bounds", "scan_bwd"):
        fn = getattr(tscan, name)
        monkeypatch.setattr(tscan, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    local, glob_ = SMALL["ssm_layers"], SMALL["global_ssm_layers"]
    trainer = ttraining.Trainer(_small_model(gradient_checkpointing=True),
                                ttraining.TrainingConfig(), iter(()))
    trainer.train_step(_host_batch())
    assert {n: calls.count(n) for n in set(calls)} == {
        "scan_fwd": local, "scan_fwd_bounds": local + glob_, "scan_bwd": local + glob_}
    calls.clear()
    trainer.eval_step(_host_batch())
    assert calls == ["scan_fwd"] * (local + glob_)


def test_checkpointing_matches_jax():
    """Dropout 0, both with gradient_checkpointing: the port's loss within
    1e-5 relative of the JAX model's, every gradient within 1e-4 of its
    max|grad| (a gradient that is 0 in exact arithmetic within 1e-4 of
    the largest)."""
    port = _small_model(seed=4, gradient_checkpointing=True)
    params = params_to_numpy(port)
    batch = _host_batch(5)
    jm = jmodel.create_model(jconfig.VelocityASRConfig(
        **{**SMALL, "scan_mode": "sequential", "gradient_checkpointing": True}))

    def jloss(p):
        logits = jm.apply({"params": p}, jnp.asarray(batch["mel_spectrogram"]))
        return jtraining.ctc_loss(logits, jnp.asarray(batch["targets"]),
                                  (jnp.asarray(batch["input_lengths"]) + 1) // 2,
                                  jnp.asarray(batch["target_lengths"]))

    ref_loss, ref_grads = jax.value_and_grad(jloss)(params)
    loss, grads = _loss_and_grads(port, batch, seed=None)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    with torch.no_grad():
        for p, g in zip(port.parameters(), grads):
            p.copy_(g)
    ours = dict(_flatten(params_to_numpy(port)))
    ref = {k: np.asarray(v) for k, v in _flatten(jax.device_get(ref_grads))}
    assert ours.keys() == ref.keys()
    top = max(np.abs(v).max() for v in ref.values())
    for key, want in ref.items():
        # the key projection's bias: softmax ignores a shift of every key,
        # so its gradient is round-off on both sides, held against the largest
        scale = top if key == ZERO_GRAD else np.abs(want).max()
        np.testing.assert_allclose(ours[key], want, rtol=0, atol=GRAD_REL * scale,
                                   err_msg=str(key))


# ----- profile_dir ----------------------------------------------------------------


def test_profile_dir_writes_one_trace_of_the_window(tmp_path):
    """max_steps 3, profile_start 1, profile_steps 1: one Chrome trace in
    profile_dir, holding micro-step 1 and no other."""
    cfg = ttraining.TrainingConfig(max_steps=3, warmup_steps=1, log_interval=100,
                                   eval_interval=100, save_interval=100,
                                   checkpoint_dir=str(tmp_path / "run"),
                                   profile_dir=str(tmp_path / "trace"), profile_start=1,
                                   profile_steps=1)
    batches = iter([_host_batch(i) for i in range(3)])
    trainer = ttraining.Trainer(_small_model(), cfg, batches)
    trainer.train()
    traces = glob.glob(str(tmp_path / "trace" / "*"))
    assert [t.rsplit("/", 1)[-1] for t in traces] == ["trace_steps_1_2.json"]
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    steps = sorted({e["name"] for e in events if e.get("name", "").startswith("micro_step_")})
    assert steps == ["micro_step_1"]
    assert any(e.get("name") == "aten::mm" or e.get("name") == "aten::addmm" for e in events)


def test_profile_window_closes_when_the_run_fails(tmp_path):
    """A run that fails inside the window still writes its trace."""
    cfg = ttraining.TrainingConfig(max_steps=4, warmup_steps=1, log_interval=100,
                                   eval_interval=100, save_interval=100,
                                   checkpoint_dir=str(tmp_path / "run"),
                                   profile_dir=str(tmp_path / "trace"), profile_start=0,
                                   profile_steps=3)
    trainer = ttraining.Trainer(_small_model(), cfg, iter([_host_batch(0)]))
    with pytest.raises(StopIteration):
        trainer.train()
    assert glob.glob(str(tmp_path / "trace" / "trace_steps_0_3.json"))
