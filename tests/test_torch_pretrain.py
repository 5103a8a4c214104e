"""The port's masked-spectrogram pretraining and the Stage-2 hand-off
(``velocity_asr_tpu_torch/pretrain.py``) against the JAX package's:

- the mask samplers draw from a ``torch.Generator`` (JAX draws from
  ``jax.random``, so the bits differ): their structure and statistics:
  spans of span_length frames from Bernoulli starts on valid frames only,
  coverage near 1 - (1 - p)^L, bands of U[min, max] contiguous bins with
  probability frequency_mask_prob;
- ``MaskedPredictor`` (fp32, with and without a mask, an odd T) and
  ``masked_prediction_loss`` (with n_valid) against JAX on the same
  weights and masks: 1e-5;
- one ``PretrainTrainer`` micro-step (dropout off, host mel and device
  mel) against ``jax.grad`` of the JAX ``_loss_fn`` with JAX's own masks
  injected: loss at rel 1e-5, every gradient within 1e-4 of its max;
- the trainer's refusals with the JAX messages;
- artifacts both ways bit-equal; ``init_asr_from_backbone`` (backbone
  from the artifact, a fresh head, the mismatch message, the QAT
  re-nesting) against JAX's;
- the pretrain CLI (and its masking stanza) and ``train --init-from`` its
  artifact, on the CPU at tiny size.
"""

import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velocity_asr_tpu import augment as jaugment
from velocity_asr_tpu import pretrain as jpretrain
from velocity_asr_tpu import training as jtraining
from velocity_asr_tpu.models import config as jconfig
from velocity_asr_tpu_torch import pretrain as tpretrain
from velocity_asr_tpu_torch import training as ttraining
from velocity_asr_tpu_torch.augment import SpecAugmentConfig
from velocity_asr_tpu_torch.checkpoint import (_flatten, params_from_numpy, params_to_numpy,
                                               read_params)
from velocity_asr_tpu_torch.models import model as tmodel
from velocity_asr_tpu_torch.models.config import VelocityASRConfig

SMALL = dict(d_model=16, ssm_layers=2, ssm_state_dim=4, global_ssm_layers=1,
             global_ssm_state_dim=4, attention_heads=2, attention_dim=8, vocab_size=30,
             dropout=0.0, dtype="float32")
# the JAX loaders initialise a model: its sequential scan compiles quickly
SEQ = {**SMALL, "scan_mode": "sequential"}
MASKING = jpretrain.MaskedPredictionConfig()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: under xdist the workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def perturbed(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + scale * rng.standard_normal(p.shape)).astype(np.float32),
        jax.device_get(tree))


def grad_tree(model, grads):
    clone = copy.deepcopy(model)
    with torch.no_grad():
        for p, g in zip(clone.parameters(), grads):
            p.copy_(torch.zeros_like(p) if g is None else g)
    return dict(_flatten(params_to_numpy(clone)))


def assert_grads_match(port, loss, ref_loss, ref_grads):
    """The port's loss (rel 1e-5) and every gradient (within 1e-4 of its
    max|grad|, of the largest where a gradient is 0 in exact arithmetic)
    against JAX's."""
    grads = torch.autograd.grad(loss, list(port.parameters()), allow_unused=True)
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-5)
    ours, theirs = grad_tree(port, grads), dict(_flatten(jax.device_get(ref_grads)))
    assert set(ours) == set(theirs)
    top = max(np.abs(v).max() for v in theirs.values())
    for key, g in theirs.items():
        scale = np.abs(g).max()
        scale = top if scale <= 1e-6 * top else scale
        assert np.abs(ours[key] - g).max() <= 1e-4 * scale, key
    return theirs


# ----- the mask samplers ----------------------------------------------------------


def _runs(row):
    idx = np.flatnonzero(np.diff(np.r_[0, row.astype(np.int8), 0]))
    return list(zip(idx[::2], idx[1::2]))


def test_time_mask_spans_and_coverage():
    cfg = tpretrain.MaskedPredictionConfig(span_probability=0.05, span_length=10)
    lengths = torch.tensor([20000, 12000, 7, 0])
    mask = tpretrain.sample_time_mask(torch.Generator().manual_seed(1), 4, 20000, lengths,
                                      cfg).numpy()
    assert mask.dtype == bool and mask.shape == (4, 20000)
    for row, n in zip(mask, lengths.tolist()):
        assert not row[n:].any()  # only valid frames
        for s, t in _runs(row[:n]):  # every span at least span_length, unless clipped
            assert t - s >= cfg.span_length or t == n
    # coverage: 1 - (1 - p)^L of the frames at least span_length from the start
    expect = 1 - (1 - cfg.span_probability) ** cfg.span_length
    cover = mask[:2, cfg.span_length:12000].mean()
    assert abs(cover - expect) < 0.015, (cover, expect)
    # the reference block's numbers: ~80% (its README's "approximately 50%"
    # is the arithmetic of p ~ 0.065)
    full = tpretrain.sample_time_mask(torch.Generator().manual_seed(2), 16, 20000,
                                      torch.full((16,), 20000), MASKING)
    assert abs(full[:, 10:].float().mean().item() - (1 - 0.85 ** 10)) < 0.01


def test_freq_mask_bands_and_probability():
    cfg = tpretrain.MaskedPredictionConfig(frequency_mask_prob=0.3, frequency_band_min=5,
                                           frequency_band_max=10)
    mask = tpretrain.sample_freq_mask(torch.Generator().manual_seed(3), 4000, 80, cfg).numpy()
    widths = mask.sum(axis=1)
    applied = widths > 0
    assert abs(applied.mean() - 0.3) < 0.03
    assert widths[applied].min() == 5 and widths[applied].max() == 10
    assert set(np.unique(widths[applied]).tolist()) == set(range(5, 11))
    assert all(len(_runs(row)) == 1 for row in mask[applied][:200])  # one contiguous band
    starts = mask[applied].argmax(axis=1)
    assert starts.min() == 0 and (starts + widths[applied]).max() == 80
    narrow = tpretrain.sample_freq_mask(torch.Generator().manual_seed(4), 200, 6,
                                        dataclasses.replace(cfg, frequency_mask_prob=1.0))
    assert narrow.sum(dim=1).max().item() == 6  # the width is capped at n_mels


# ----- the model and the loss ----------------------------------------------------------


def _jax_masks(key, lengths, b, t, n_mels, cfg=MASKING):
    """The masks the JAX PretrainTrainer's _loss_fn draws from `key`."""
    mask_rng, freq_rng, _ = jax.random.split(key, 3)
    return (np.asarray(jpretrain.sample_time_mask(mask_rng, b, t, jnp.asarray(lengths), cfg)),
            np.asarray(jpretrain.sample_freq_mask(freq_rng, b, n_mels, cfg)))


@pytest.fixture(scope="module")
def pair():
    jm = jpretrain.MaskedPredictor(config=jconfig.VelocityASRConfig(scan_mode="sequential",
                                                                    **SMALL))
    params = perturbed(jax.jit(lambda k: jm.init(k, jnp.zeros((1, 64, 80)),
                                                 time_mask=jnp.zeros((1, 64), bool)))(
        jax.random.PRNGKey(1))["params"], 2)
    port = tpretrain.MaskedPredictor(VelocityASRConfig(scan_mode="pallas", **SMALL))
    port.load_state_dict(params_from_numpy(params), strict=True)
    return jm, params, port.eval()


@pytest.mark.parametrize("masked", [False, True])
def test_masked_predictor_and_loss_match_jax(pair, masked):
    jm, params, port = pair
    rng = np.random.default_rng(5)
    mel = rng.standard_normal((3, 63, 80)).astype(np.float32)  # odd T: T + 1 predicted frames
    lengths = np.asarray([63, 40, 9], np.int32)
    time_mask = (rng.random((3, 63)) < 0.4) if masked else None
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(mel),
                              time_mask=None if time_mask is None else jnp.asarray(time_mask)))
    with torch.no_grad():
        out = port(torch.from_numpy(mel),
                   time_mask=None if time_mask is None else torch.from_numpy(time_mask))
    assert out.dtype == torch.float32 and out.shape == (3, 64, 80) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    if masked:
        for n_valid in (None, 2):
            ours = tpretrain.masked_prediction_loss(out, torch.from_numpy(mel),
                                                    torch.from_numpy(time_mask),
                                                    torch.from_numpy(lengths), n_valid)
            theirs = jpretrain.masked_prediction_loss(
                jnp.asarray(ref), jnp.asarray(mel), jnp.asarray(time_mask),
                jnp.asarray(lengths), None if n_valid is None else jnp.asarray(n_valid))
            assert float(ours) == pytest.approx(float(theirs), rel=1e-5)


def test_mask_embedding_and_head_init_follow_flax():
    port = tpretrain.create_pretrain_model(VelocityASRConfig(**{**SMALL, "d_model": 128}),
                                           device="cpu")
    emb = port.mask_embedding.detach().numpy()
    assert emb.shape == (80,) and 0.01 < emb.std() < 0.03
    w = port.recon_head.weight.detach().numpy()  # (out, in): lecun-normal over fan_in 128
    std = (1 / 128) ** 0.5 / 0.87962566103423978
    assert np.abs(w).max() <= 2 * std + 1e-7 and w.std() == pytest.approx((1 / 128) ** 0.5,
                                                                          rel=0.05)
    assert not port.recon_head.bias.detach().any()
    jm = jpretrain.MaskedPredictor(config=jconfig.VelocityASRConfig(**{**SMALL, "d_model": 128}))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 80)),
                                            time_mask=jnp.zeros((1, 8), bool)))["params"]
    assert ({k: v.shape for k, v in _flatten(shapes)}
            == {k: v.shape for k, v in _flatten(params_to_numpy(port))})


# ----- the trainer -----------------------------------------------------------------


def _host_batch(seed):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((2, 200, 80)).astype(np.float32)
    mel[1, 151:] = 0.0
    return {"mel_spectrogram": mel, "targets": np.full((2, 4), 3, np.int32),
            "input_lengths": np.asarray([200, 151], np.int32),
            "target_lengths": np.asarray([4, 4], np.int32)}


def _audio_batch(seed):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((2, 199 * 160)) * 3000).astype(np.int16)
    audio[1, 120 * 160:] = 0
    return {"audio": audio, "targets": np.full((2, 4), 3, np.int32),
            "input_lengths": np.asarray([200, 121], np.int32),
            "target_lengths": np.asarray([4, 4], np.int32)}


@pytest.mark.parametrize("source", ["host_mel", "device_mel"])
def test_pretrain_step_matches_jax_grad(pair, source):
    jm, params, port = pair
    batch = _host_batch(6) if source == "host_mel" else _audio_batch(7)
    cfg = dict(learning_rate=1e-3, warmup_steps=2, max_steps=4, num_data_shards=1)
    jt = jpretrain.PretrainTrainer(jm, jtraining.TrainingConfig(**cfg), iter([batch]),
                                   params=params, mask_config=MASKING)
    sharded, n_valid = jt.shard_batch(batch)
    key = jax.random.PRNGKey(9)
    ref, ref_g = jax.jit(jax.value_and_grad(
        lambda p: jt._loss_fn(p, None, sharded, key, True, n_valid)[0]))(params)
    time_mask, freq_mask = (np.array(m) for m in _jax_masks(key, batch["input_lengths"], 2,
                                                             200, 80))
    assert time_mask[1, 151:].sum() == 0 and time_mask.any() and time_mask.mean() < 1
    tt = tpretrain.PretrainTrainer(port, ttraining.TrainingConfig(**cfg), iter(()),
                                   mask_config=tpretrain.MaskedPredictionConfig())
    port.train()
    try:
        loss = tt._loss(tt._to_device(batch), torch.Generator(),
                        masks=(torch.from_numpy(time_mask), torch.from_numpy(freq_mask)))
        grads = assert_grads_match(port, loss, ref, ref_g)
    finally:
        port.eval()
    assert np.abs(grads[("mask_embedding",)]).max() > 0


def test_eval_masks_are_fixed_and_training_masks_drawn():
    port = tpretrain.create_pretrain_model(VelocityASRConfig(**SMALL), device="cpu")
    tt = tpretrain.PretrainTrainer(port, ttraining.TrainingConfig(), iter(()))
    batch = _host_batch(8)
    assert tt.eval_step(batch) == tt.eval_step(batch)
    mel, lengths = torch.from_numpy(batch["mel_spectrogram"]), torch.tensor([200, 151])
    a = tt.sample_masks(mel, lengths, torch.Generator().manual_seed(1))
    b = tt.sample_masks(mel, lengths, torch.Generator().manual_seed(2))
    assert not torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(tt.sample_masks(mel, lengths, None),
                                                 tt.sample_masks(mel, lengths, None)))


@pytest.mark.parametrize("case", ["qat", "streaming", "specaugment"])
def test_refusals_match_jax(case):
    cfg, train_kw = dict(SMALL), {}
    if case == "qat":
        cfg["qat"] = True
    elif case == "streaming":
        train_kw["streaming_chunks"] = 2
    jaug = taug = None
    if case == "specaugment":
        jaug = jaugment.SpecAugmentConfig(enabled=True)
        taug = SpecAugmentConfig(enabled=True)
    msgs = []
    for build in (
            lambda: tpretrain.PretrainTrainer(
                tpretrain.MaskedPredictor(VelocityASRConfig(**cfg)),
                ttraining.TrainingConfig(augment=taug, **train_kw), iter(())),
            lambda: jpretrain.PretrainTrainer(
                jpretrain.MaskedPredictor(config=jconfig.VelocityASRConfig(**cfg)),
                jtraining.TrainingConfig(augment=jaug, **train_kw), iter(()))):
        with pytest.raises(ValueError) as err:
            build()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# ----- artifacts and the Stage-2 hand-off ------------------------------------------


def _trees_equal(a, b):
    fa, fb = dict(_flatten(a)), dict(_flatten(b))
    return set(fa) == set(fb) and all(
        np.asarray(fa[k]).dtype == np.asarray(fb[k]).dtype
        and np.array_equal(np.asarray(fa[k]), np.asarray(fb[k])) for k in fa)


def test_artifacts_read_both_ways_bit_equal(pair, tmp_path):
    jm, params, port = pair
    cfg = VelocityASRConfig(**SEQ)
    masking = tpretrain.MaskedPredictionConfig(span_probability=0.1, frequency_band_max=8)
    tpretrain.save_pretrain_artifact(str(tmp_path / "ours"), cfg, masking, port)
    jcfg, jmask, jparams = jpretrain.load_pretrain_artifact(str(tmp_path / "ours"))
    assert jcfg.to_dict() == cfg.to_dict() and jmask.to_dict() == masking.to_dict()
    assert _trees_equal(jax.device_get(jparams), params)
    jpretrain.save_pretrain_artifact(str(tmp_path / "jax"), jconfig.VelocityASRConfig(**SEQ),
                                     jpretrain.MaskedPredictionConfig(**masking.to_dict()),
                                     params)
    tcfg, tmask, tparams = tpretrain.load_pretrain_artifact(str(tmp_path / "jax"))
    assert tmask == masking and tcfg.to_dict() == jconfig.VelocityASRConfig(**SEQ).to_dict()
    assert _trees_equal(tparams, params)
    assert ((tmp_path / "ours" / "params.msgpack").read_bytes()
            == (tmp_path / "jax" / "params.msgpack").read_bytes())
    assert tpretrain.is_pretrain_artifact(str(tmp_path / "jax"))
    assert not tpretrain.is_pretrain_artifact("checkpoints/synth_run/final_pretrained")
    with pytest.raises(ValueError, match="not a masked-prediction"):
        tpretrain.load_pretrain_artifact("checkpoints/synth_run/final_pretrained")


def test_init_asr_from_backbone_matches_jax(pair, tmp_path):
    jm, params, port = pair
    art = str(tmp_path / "art")
    tpretrain.save_pretrain_artifact(art, VelocityASRConfig(**SEQ),
                                     tpretrain.MaskedPredictionConfig(), port)
    for qat in (False, True):
        cfg = VelocityASRConfig(**{**SEQ, "qat": qat})
        fresh = params_to_numpy(tmodel.create_model(cfg, device="cpu"))
        ours = tpretrain.init_asr_from_backbone(cfg, art)
        theirs = jax.device_get(jpretrain.init_asr_from_backbone(
            jconfig.VelocityASRConfig(**{**SEQ, "qat": qat}), art))
        assert ({k for k, _ in _flatten(ours)} == {k for k, _ in _flatten(theirs)})
        if qat:
            assert "conv" in ours["temporal_binding"] and "conv_kernel" not in ours[
                "temporal_binding"]
            np.testing.assert_array_equal(ours["temporal_binding"]["conv"]["kernel"],
                                          params["temporal_binding"]["conv_kernel"])
        for key in ("local_ssm", "global_context"):
            assert _trees_equal(ours[key], params[key]) and _trees_equal(theirs[key], params[key])
        assert _trees_equal(ours["ctc_head"], fresh["ctc_head"])  # the fresh head
        model = tmodel.create_model(cfg, device="cpu")
        model.load_state_dict(params_from_numpy(ours), strict=True)
    bad = {"d_model": 32, "ssm_layers": 3, "attention_dim": 16}
    msgs = []
    for fn, cfg_cls in ((tpretrain.init_asr_from_backbone, VelocityASRConfig),
                        (jpretrain.init_asr_from_backbone, jconfig.VelocityASRConfig)):
        with pytest.raises(ValueError) as err:
            fn(cfg_cls(**{**SEQ, **bad}), art)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "d_model 16 != 32" in msgs[0] and "ssm_layers" in msgs[0]


# ----- the CLIs --------------------------------------------------------------------


def _tiny_yamls(tmp_path, masking_extra=""):
    model_yaml = tmp_path / "model.yaml"
    model_yaml.write_text(
        "model:\n  mel_bins: 80\n  d_model: 16\n  dropout: 0.1\nssm:\n  num_layers: 2\n"
        "  state_dim: 4\nglobal_context:\n  ssm_layers: 1\n  ssm_state_dim: 4\n"
        "  attention_heads: 2\n  attention_dim: 8\noutput:\n  vocab_size: 30\n"
        "performance:\n  scan_mode: pallas\n  dtype: float32\n")
    train_yaml = tmp_path / "pretrain.yaml"
    train_yaml.write_text(
        "data:\n  synthetic: 4\n  synthetic_split: unlab\n  device_mel: true\n"
        "  synthetic_max_words: 3\ntraining:\n  batch_size: 2\n  max_steps: 2\n"
        "optimizer:\n  learning_rate: 1.0e-3\n  warmup_steps: 1\n"
        "masking:\n  span_probability: 0.2\n  frequency_band_width: [3, 6]\n" + masking_extra
        + f"checkpoint:\n  dir: {tmp_path}/pre\nlogging:\n  log_interval: 1\n"
        "  eval_interval: 100\n")
    return str(model_yaml), str(train_yaml)


def test_pretrain_cli_then_finetune_from_its_backbone(tmp_path):
    from velocity_asr_tpu_torch import pretrain as cli
    from velocity_asr_tpu_torch import train as train_cli

    model_yaml, train_yaml = _tiny_yamls(tmp_path)
    out = cli.main(["--config", train_yaml, "--model-config", model_yaml, "--num-workers", "0",
                    "--device", "cpu"])
    assert len(out["history"]["train_loss"]) == 2
    assert all(np.isfinite(out["history"]["train_loss"]))
    backbone = str(tmp_path / "pre" / "final_backbone")
    assert os.path.isdir(tmp_path / "pre" / "final_model")
    cfg, masking, tree = jpretrain.load_pretrain_artifact(backbone)  # JAX reads it
    assert masking.frequency_band_min == 3 and masking.frequency_band_max == 6
    assert masking.span_probability == 0.2
    ft_yaml = tmp_path / "ft.yaml"
    ft_yaml.write_text(
        "data:\n  synthetic: 4\n  device_mel: true\n  synthetic_max_words: 3\n"
        "training:\n  batch_size: 2\n  max_steps: 1\noptimizer:\n  warmup_steps: 1\n"
        "logging:\n  log_interval: 1\n  eval_interval: 100\n")
    ft = train_cli.main(["--config", str(ft_yaml), "--model-config", model_yaml,
                         "--init-from", backbone, "--checkpoint-dir", str(tmp_path / "ft"),
                         "--num-workers", "0", "--device", "cpu"])
    assert np.isfinite(ft["history"]["train_loss"]).all()
    with open(tmp_path / "ft" / "final_pretrained" / "config.json") as f:
        assert json.load(f)["config"]["d_model"] == 16
    # one update at lr 3e-4 moves the backbone only a little from the artifact's
    after = read_params(str(tmp_path / "ft" / "final_pretrained" / "params.msgpack"))
    delta = np.abs(after["local_ssm"]["norm"]["scale"] - tree["local_ssm"]["norm"]["scale"])
    assert delta.max() < 1e-2


def test_pretrain_cli_refuses_unknown_masking_keys(tmp_path, capsys):
    from velocity_asr_tpu_torch import pretrain as cli

    model_yaml, train_yaml = _tiny_yamls(tmp_path, masking_extra="  span_lenght: 3\n")
    with pytest.raises(SystemExit):
        cli.main(["--config", train_yaml, "--model-config", model_yaml, "--device", "cpu"])
    assert "unknown masking config keys: ['span_lenght']" in capsys.readouterr().err
