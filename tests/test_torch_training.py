"""The port's training path against the JAX package's, at a small size
(d_model 32, 2 local SSM blocks with N=8, 1 global block with N=4, fp32,
dropout 0 and SpecAugment off where the two are compared):

- ``ctc_loss`` and its gradient against the JAX ``ctc_loss`` (an
  infeasible example included), rtol/atol 1e-5;
- ``warmup_cosine_schedule`` at counts 0..N, rtol 1e-6 (both in fp32);
- the parameters after one update, and after two micro-steps with
  accumulation 2, against the JAX ``Trainer`` on the same weights and
  batches (``scan_mode`` "pallas": JAX runs its Pallas backward in
  interpret mode). Adam's first step moves each weight by about lr times
  sign(g) / (1 + 1e-8 / |g|), so a gradient within round-off of 0 (the
  key projection's bias has an exact zero gradient: softmax ignores a
  shift of every key) may move either way, and one near 1e-8 moves by a
  fraction of lr that round-off decides: weights whose gradient exceeds
  1e-5 (over 80% of them here) must agree within 1e-6 (0.2% of the
  step), every weight within 2 lr;
- SpecAugment's mask rule, the synth train split (bit-equal), the YAML
  reader (``yaml.safe_load``), ``save_pretrained`` read by the JAX
  ``from_pretrained`` (bit-exact), resume (2 + 2 steps equal 4), the CLI
  for 2 steps on the CPU, and a training step after an inference-mode
  forward.
"""

import dataclasses
import glob
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from velocity_asr_tpu import augment as jaugment
from velocity_asr_tpu import synth as jsynth
from velocity_asr_tpu import training as jtraining
from velocity_asr_tpu.models import config as jconfig
from velocity_asr_tpu.models import model as jmodel
from velocity_asr_tpu.utils import config as jyaml
from velocity_asr_tpu_torch import augment as taugment
from velocity_asr_tpu_torch import config as tyaml
from velocity_asr_tpu_torch import data as tdata
from velocity_asr_tpu_torch import synth as tsynth
from velocity_asr_tpu_torch import training as ttraining
from velocity_asr_tpu_torch.checkpoint import (_flatten, params_from_numpy, params_to_numpy,
                                               read_params)
from velocity_asr_tpu_torch.models import model as tmodel
from velocity_asr_tpu_torch.models import ssm as tssm
from velocity_asr_tpu_torch.models.config import VelocityASRConfig
from velocity_asr_tpu_torch.models.layers import Dropout
from velocity_asr_tpu_torch.ops import cuda_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(d_model=32, ssm_layers=2, ssm_state_dim=8, global_ssm_layers=1,
             global_ssm_state_dim=4, attention_heads=4, attention_dim=16, vocab_size=30,
             dropout=0.0, scan_mode="pallas", dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: several test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batch(seed, frames=64, lengths=(64, 50), target_lengths=(10, 7)):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((len(lengths), frames, 80)).astype(np.float32)
    for i, n in enumerate(lengths):
        mel[i, n:] = 0.0
    targets = np.full((len(lengths), 32), 2, np.int32)
    for i, n in enumerate(target_lengths):
        targets[i, :n] = rng.integers(3, 30, n)
    return {"mel_spectrogram": mel, "targets": targets,
            "input_lengths": np.asarray(lengths, np.int32),
            "target_lengths": np.asarray(target_lengths, np.int32)}


def _small_model(seed=0, **overrides):
    cfg = VelocityASRConfig(**{**SMALL, **overrides})
    return tmodel.create_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))


# ----- loss and schedule ---------------------------------------------------------


def test_ctc_loss_and_gradient_match_jax():
    """Batch of 4: a plain example, one with repeated tokens, one whose
    target cannot be aligned in its frames (loss 0, no gradient), one with
    an empty target."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((4, 12, 30)).astype(np.float32) * 2
    targets = np.full((4, 8), 2, np.int32)
    targets[0, :5] = [5, 6, 7, 8, 9]
    targets[1, :6] = [5, 5, 6, 6, 6, 7]
    targets[2, :7] = [4, 4, 4, 4, 9, 9, 9]  # 7 tokens + 5 repeats > 8 frames
    in_lens = np.array([12, 12, 8, 6], np.int32)
    tgt_lens = np.array([5, 6, 7, 0], np.int32)

    def jloss(lg):
        return jtraining.ctc_loss(lg, jnp.asarray(targets), jnp.asarray(in_lens),
                                  jnp.asarray(tgt_lens))

    ref, ref_grad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    lg = torch.tensor(logits, requires_grad=True)
    per = ttraining.ctc_loss_per_example(lg, *map(torch.tensor, (targets, in_lens, tgt_lens)))
    assert per[2] == 0.0
    loss = per.mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(ref_grad), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(jtraining.ctc_loss_per_example(
        jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(in_lens),
        jnp.asarray(tgt_lens))), rtol=1e-5, atol=1e-5)
    assert not lg.grad[2].any()


@pytest.mark.parametrize("warmup,total", [(500, 100), (10, 50), (0, 20)])
def test_schedule_matches_jax(warmup, total):
    ref = jtraining.warmup_cosine_schedule(3e-4, warmup, total)
    ours = ttraining.warmup_cosine_schedule(3e-4, warmup, total)
    counts = np.arange(0, total + 10)
    np.testing.assert_allclose([ours(int(c)) for c in counts],
                               np.asarray(jax.vmap(ref)(jnp.asarray(counts))), rtol=1e-6)


# ----- one update against the JAX Trainer ------------------------------------------------


def _trainer_pair(accumulation, batches):
    """A JAX Trainer and a port Trainer on the same weights (the port's
    init, carried across) and the same config."""
    port = _small_model(seed=1)
    params = params_to_numpy(port)
    kw = dict(learning_rate=1e-3, warmup_steps=2, max_steps=4, grad_clip_norm=1.0,
              weight_decay=0.01, gradient_accumulation_steps=accumulation, log_interval=100)
    jt = jtraining.Trainer(jmodel.create_model(jconfig.VelocityASRConfig(**SMALL)),
                           jtraining.TrainingConfig(**kw), iter(batches), params=params)
    tt = ttraining.Trainer(port, ttraining.TrainingConfig(**kw), iter(batches))
    return jt, tt, params


def _mean_grads(model, batches):
    """The port's mean gradient over the batches, laid out as the flax
    parameter tree (written into the model's parameters, then read out)."""
    trainer = ttraining.Trainer(model, ttraining.TrainingConfig(), iter(()))
    model.train()
    params = list(model.parameters())
    grads = [torch.zeros_like(p) for p in params]
    for b in batches:
        loss = trainer._loss(trainer._to_device(b), None)
        for acc, g in zip(grads, torch.autograd.grad(loss, params)):
            acc += g / len(batches)
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.copy_(g)
    return dict(_flatten(params_to_numpy(model)))


@pytest.mark.parametrize("accumulation", [1, 2])
def test_update_matches_jax_trainer(accumulation):
    batches = [_batch(1), _batch(2, lengths=(64, 40), target_lengths=(9, 12))][:accumulation]
    jt, tt, params = _trainer_pair(accumulation, batches)
    for b in batches:
        ref, ours = jt.train_step(b), tt.train_step(b)
        np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=1e-5)
        assert ours["lr"] == pytest.approx(ref["lr"], rel=1e-6)
    if accumulation == 2:
        assert tt.optimizer.count == 1 and tt.optimizer.mini_step == 0
    start = dict(_flatten(params))
    jax_after = dict(_flatten(jax.device_get(jt.params)))
    port_after = dict(_flatten(params_to_numpy(tt.model)))
    check = _small_model(seed=1)
    grads = _mean_grads(check, batches)
    lr = tt.optimizer.last_lr()
    covered = total = 0
    for key, ref in jax_after.items():
        ours = port_after[key]
        assert np.abs(ours - start[key]).max() > 0 or not np.abs(grads[key]).max(), key
        assert np.abs(ours - ref).max() <= 2 * lr, key
        big = np.abs(grads[key]) > 1e-5
        np.testing.assert_allclose(ours[big], ref[big], rtol=0, atol=1e-6, err_msg=str(key))
        covered += big.sum()
        total += big.size
    assert covered > 0.75 * total


# ----- augmentation, data, config --------------------------------------------------


def test_spec_augment_mask_rule():
    """Masks are zeros; each time mask lies within its utterance's valid
    frames and is at most half of them wide (and at most
    time_mask_frames); frequency masks are at most freq_mask_bins wide;
    a 1-frame clip is never time-masked. Same rule as the JAX function
    (checked on its output too)."""
    cfg = taugment.SpecAugmentConfig(enabled=True, num_time_masks=1, time_mask_frames=50,
                                     num_freq_masks=1, freq_mask_bins=15)
    lengths = torch.tensor([1, 7, 40, 300, 300, 120])
    mel = torch.rand(6, 300, 80) + 1.0  # no zeros of its own
    jcfg = jaugment.SpecAugmentConfig(**dataclasses.asdict(cfg))
    for seed in range(25):
        outs = [taugment.spec_augment(mel, torch.Generator().manual_seed(seed), cfg, lengths),
                torch.from_numpy(np.asarray(jaugment.spec_augment(
                    jnp.asarray(mel.numpy()), jax.random.PRNGKey(seed), jcfg,
                    jnp.asarray(lengths.numpy()))))]
        for out in outs:
            zero = out == 0
            assert torch.equal(out[~zero], mel[~zero])
            time_masked = zero.all(-1)  # whole frames
            freq_masked = zero.all(1)  # whole bins
            assert freq_masked.sum(-1).max() <= 15
            for row, n in enumerate(lengths.tolist()):
                frames = time_masked[row].nonzero().flatten()
                if frames.numel():
                    assert frames.max() < n
                    assert frames.max() - frames.min() + 1 <= min(50, n // 2)
                assert n > 1 or not frames.numel()
    # masks differ from row to row and are drawn from the generator
    a = taugment.spec_augment(mel, torch.Generator().manual_seed(0), cfg, lengths)
    b = taugment.spec_augment(mel, torch.Generator().manual_seed(0), cfg, lengths)
    assert torch.equal(a, b)


@pytest.mark.parametrize("split,idx", [("train", 0), ("train", 1234), ("dev", 5)])
def test_synth_train_items_equal_jax(split, idx):
    ref = jsynth.SyntheticSpeechDataset(2000, split=split, seed=1234)
    ours = tsynth.SyntheticSpeechDataset(2000, split=split, seed=1234)
    assert ours.vocab == ref.vocab and len(ours.vocab) == 30 and len(ours) == len(ref)
    a, b = ref[idx], ours[idx]
    assert set(a) == set(b)
    for key in a:
        if key == "text":
            assert a[key] == b[key]
        else:
            assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml"))),
                         ids=os.path.basename)
def test_yaml_reader_matches_safe_load(path):
    with open(path) as f:
        ref = yaml.safe_load(f)
    assert tyaml.load_yaml(path) == ref


def test_yaml_mapping_matches_jax():
    train = tyaml.load_yaml(os.path.join(ROOT, "configs", "train_synth.yaml"))
    model = tyaml.load_yaml(os.path.join(ROOT, "configs", "model_synth.yaml"))
    assert (dataclasses.asdict(tyaml.training_config_from_yaml(train))
            == dataclasses.asdict(jyaml.training_config_from_yaml(train)))
    assert (tyaml.model_config_from_yaml(model).to_dict()
            == jyaml.model_config_from_yaml(model).to_dict())
    with pytest.raises(ValueError):
        tyaml.parse_yaml("a:\n  - 1\n")


def test_data_loader_order_and_cycle():
    ds = list(range(10))
    order = lambda seed: [b.tolist() for b in tdata.DataLoader(  # noqa: E731
        ds, batch_size=3, num_workers=0, collate_fn=torch.tensor, drop_last=True, seed=seed)]
    assert order(5) == order(5) != order(6)
    first = order(5)
    assert len(first) == 3 and sorted(sum(first, [])) != list(range(10))  # one dropped
    loader = tdata.DataLoader(ds, batch_size=3, num_workers=0, collate_fn=torch.tensor,
                              shuffle=False)
    it = tdata.cycle(loader)
    got = [next(it).tolist() for _ in range(5)]
    assert got == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9], [0, 1, 2]]
    with pytest.raises(RuntimeError, match="no batches"):
        next(tdata.cycle(tdata.DataLoader([], batch_size=2, num_workers=0)))


# ----- checkpoints and resume ---------------------------------------------------------


def test_save_pretrained_loads_in_jax_bit_exactly(tmp_path):
    model = _small_model(seed=4)
    cfg = model.config
    tmodel.save_pretrained(str(tmp_path), cfg, model, extra={"note": "port"})
    jm, jparams = jmodel.from_pretrained(str(tmp_path), scan_mode="sequential")
    assert jm.config.d_model == cfg.d_model and jm.config.vocab_size == cfg.vocab_size
    ours = dict(_flatten(params_to_numpy(model)))
    theirs = dict(_flatten(jax.device_get(jparams)))
    assert set(ours) == set(theirs)
    for key in ours:
        assert theirs[key].dtype == np.float32
        np.testing.assert_array_equal(theirs[key], ours[key], err_msg=str(key))
    # and the port reads its own file back bit for bit
    back = params_from_numpy(read_params(str(tmp_path / "params.msgpack")))
    for key, value in model.state_dict().items():
        assert torch.equal(back[key], value), key
    assert json.load(open(tmp_path / "config.json"))["note"] == "port"


def _resume_config(tmp_path, max_steps):
    aug = taugment.SpecAugmentConfig(enabled=True, num_time_masks=2, time_mask_frames=10,
                                     num_freq_masks=2, freq_mask_bins=5)
    return ttraining.TrainingConfig(learning_rate=1e-3, warmup_steps=2, max_steps=max_steps,
                                    gradient_accumulation_steps=2, log_interval=1,
                                    save_interval=1000, checkpoint_dir=str(tmp_path),
                                    augment=aug)


def test_resume_two_plus_two_equals_four(tmp_path):
    """With dropout and SpecAugment on, 2 steps, a checkpoint, a fresh
    trainer that resumes and 2 more steps give the 4-step run's weights
    bit for bit: each micro-step's draws are seeded from (seed, step)."""
    batches = [_batch(10 + i) for i in range(4)]
    straight = ttraining.Trainer(_small_model(seed=2, dropout=0.1), _resume_config(tmp_path, 4),
                                 iter(batches), seed=7)
    straight.train()
    first = ttraining.Trainer(_small_model(seed=2, dropout=0.1), _resume_config(tmp_path, 2),
                              iter(batches[:2]), seed=7)
    first.train()
    first.save_checkpoint(str(tmp_path / "ckpt"))
    meta = json.load(open(tmp_path / "ckpt" / "trainer_meta.json"))
    assert set(meta) == {"global_step", "best_eval_loss", "training_config", "model_config"}
    resumed = ttraining.Trainer(_small_model(seed=99, dropout=0.1), _resume_config(tmp_path, 4),
                                iter(batches[2:]), seed=7)
    resumed.load_checkpoint(str(tmp_path / "ckpt"))
    assert resumed.global_step == 2
    resumed.train()
    for (key, a), b in zip(straight.model.state_dict().items(),
                           resumed.model.state_dict().values()):
        assert torch.equal(a, b), key
    assert resumed.optimizer.count == straight.optimizer.count == 2


def test_dropout_draws_from_the_generator():
    model = _small_model(seed=3, dropout=0.5).train()
    mel = torch.tensor(_batch(0)["mel_spectrogram"])
    with pytest.raises(ValueError, match="torch.Generator"):
        model(mel)
    a = model(mel, rng=torch.Generator().manual_seed(1))
    b = model(mel, rng=torch.Generator().manual_seed(1))
    c = model(mel, rng=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    model.eval()
    torch.testing.assert_close(model(mel), model(mel, rng=torch.Generator().manual_seed(1)))
    d = Dropout(0.25).train()
    x = torch.ones(100000)
    y = d(x, torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.all(y[kept] == 1 / 0.75)
    assert abs(kept.float().mean().item() - 0.75) < 0.01


def test_training_step_after_inference_forward():
    """A forward under inference_mode first (it fills the cached time
    encoding and pooling matrices), then a training step on the same
    shapes: the cached tables must stay usable under autograd."""
    model = _small_model(seed=5)
    batch = _batch(3)
    tmodel.forward(model, torch.tensor(batch["mel_spectrogram"]))
    trainer = ttraining.Trainer(model, ttraining.TrainingConfig(warmup_steps=1), iter(()))
    out = trainer.train_step(batch)
    assert np.isfinite(out["loss"])
    assert trainer.optimizer.count == 1


HOST_MEL_WAVEFORM = "noise_injection / speed_perturb require data.device_mel"


@pytest.mark.parametrize("change,error,match", [
    # gradient checkpointing and profile_dir are ported: they train
    pytest.param({"model": {"gradient_checkpointing": True}}, None, None,
                 id="gradient_checkpointing"),
    # streaming needs device-mel batches: a host-mel batch is a
    # misconfiguration, not a fallback to the offline objective
    pytest.param({"train": {"streaming_chunks": 200}}, ValueError, "device_mel",
                 id="streaming_chunks"),
    # parallel training is ported: num_model_shards trains over a world of 2
    pytest.param({"train": {"num_model_shards": 2}}, None, None, id="num_model_shards"),
    pytest.param({"train": {"profile_dir": "trace", "profile_start": 5}}, None, None,
                 id="profile_dir"),
    # the waveform augmentations act on device-mel batches' audio: on a
    # host-mel batch they raise the JAX package's ValueError
    pytest.param({"train": {"augment": taugment.SpecAugmentConfig(enabled=True,
                                                                  noise_injection=True)}},
                 ValueError, HOST_MEL_WAVEFORM, id="augment"),
    pytest.param({"train": {"augment": taugment.SpecAugmentConfig(enabled=True,
                                                                  speed_perturb=True)}},
                 ValueError, HOST_MEL_WAVEFORM, id="speed_perturb"),
    # the language-ID loss is ported: without the head it is the JAX
    # Trainer's ValueError
    pytest.param({"train": {"lid_loss_weight": 0.3}}, ValueError,
                 "training.lid_loss_weight > 0 requires a model with num_languages > 0 "
                 "\\(the language-ID head\\)", id="lid_loss_weight"),
])
def test_unported_options_raise(change, error, match, monkeypatch):
    """Options the port does not train raise, naming their ROADMAP item,
    when the Trainer is built (a language-ID loss without the head raises
    the JAX Trainer's ValueError there); streaming_chunks and the waveform
    augmentations raise ValueError at the first micro-step on a host-mel
    batch; the ported options (error None) take a finite step. Model
    options are set when the model is built, as the blocks read them."""
    model = _small_model(seed=0, **change.get("model", {}))
    cfg = ttraining.TrainingConfig(**change.get("train", {}))
    if error is None and cfg.num_model_shards > 1:
        from torch_parallel_workers import train_step_world
        from velocity_asr_tpu_torch.parallel.dryrun import spawn_world

        losses = spawn_world(2, train_step_world, (change["train"], _batch(2)), timeout=120)
        assert np.isfinite(losses[0]) and losses[0] == losses[1]
        return
    if error is None:
        remat = []
        apply = tssm.CheckpointedBlock.apply
        monkeypatch.setattr(tssm.CheckpointedBlock, "apply",
                            staticmethod(lambda *a: remat.append(1) or apply(*a)))
        out = ttraining.Trainer(model, cfg, iter(())).train_step(_batch(2))
        assert np.isfinite(out["loss"])
        # checkpointing runs every local block as CheckpointedBlock
        want = SMALL["ssm_layers"] if change.get("model") else 0
        assert len(remat) == want
        return
    with pytest.raises(error, match=match):
        ttraining.Trainer(model, cfg, iter(())).train_step(_batch(2))


def test_eval_step_runs_the_inference_scan(monkeypatch):
    """eval_step runs without autograd (the no-state scan), train_step
    through SelectiveScanFn."""
    from velocity_asr_tpu_torch.ops import scan as tscan

    calls = []
    for name in ("scan_fwd", "scan_fwd_bounds", "scan_bwd"):
        fn = getattr(tscan, name)
        monkeypatch.setattr(tscan, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    trainer = ttraining.Trainer(_small_model(seed=6), ttraining.TrainingConfig(), iter(()))
    trainer.eval_step(_batch(4))
    assert calls == ["scan_fwd"] * 3
    calls.clear()
    trainer.train_step(_batch(4))
    assert sorted(set(calls)) == ["scan_bwd", "scan_fwd_bounds"] and len(calls) == 6


def test_cli_two_steps_on_cpu(tmp_path):
    """python -m velocity_asr_tpu_torch.train for 2 steps on the CPU, at a
    small width, writes final_model/ and a final_pretrained/ that the port
    loads, with vocabulary.json."""
    (tmp_path / "model.yaml").write_text(
        "model:\n  d_model: 32\n  dropout: 0.1\nssm:\n  num_layers: 2\n  state_dim: 8\n"
        "global_context:\n  ssm_layers: 1\n  ssm_state_dim: 4\n  attention_dim: 16\n"
        "output:\n  vocab_size: 1000\nperformance:\n  scan_mode: pallas\n")
    train = open(os.path.join(ROOT, "configs", "train_synth.yaml")).read()
    (tmp_path / "train.yaml").write_text(train)
    out = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", "velocity_asr_tpu_torch.train", "--config",
         str(tmp_path / "train.yaml"), "--model-config", str(tmp_path / "model.yaml"),
         "--synthetic", "8", "--max-steps", "2", "--batch-size", "2", "--checkpoint-dir",
         str(out), "--num-workers", "0", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    meta = json.load(open(out / "final_model" / "trainer_meta.json"))
    assert meta["global_step"] == 2 and meta["model_config"]["vocab_size"] == 30
    model = tmodel.from_pretrained(str(out / "final_pretrained"), device="cpu")
    assert model.config.d_model == 32 and model.config.vocab_size == 30
    assert len(json.load(open(out / "final_pretrained" / "vocabulary.json"))) == 30


def test_no_kernel_launch_on_the_cpu():
    """The CPU path runs the plain versions: nothing is counted."""
    cuda_lib.reset_launch_counts()
    trainer = ttraining.Trainer(_small_model(seed=8), ttraining.TrainingConfig(), iter(()))
    trainer.train_step(_batch(5))
    assert not cuda_lib.launch_counts
