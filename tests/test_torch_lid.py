"""The port's language-ID head, multilingual corpus and the surfaces that
serve it, against the JAX package's.

- ``synth``: each language's lexicon, ``SyntheticSpeechDataset``
  (languages 4) items with their ``language`` (host mel and device mel)
  and both collations, ``write_corpus`` manifests and WAVs at languages 1
  and 4: all bit-exact; a multilingual corpus's first utterances are a
  shorter corpus's;
- the head on a small fp32 model (LID alone, and with MoE): logits and
  ``lid_logits`` with and without ``feature_lengths`` at atol 1e-4 (the
  sequential oracle scan in JAX, the kernel path's plain versions here);
  its init (lecun-normal kernel, LayerNorm 1/0) against flax's;
- one fp32 micro-step of CTC + the language-ID cross entropy, dropout
  off, loss and every gradient against ``jax.grad`` of the JAX Trainer's
  loss (as ``test_torch_moe``); the head-less refusal's message;
- the three committed checkpoints (``moe_run``, ``multilang_run``,
  ``multilang_moe_run``) build, load, and write back byte for byte;
- ``evaluate --identify-language`` and ``transcribe --identify-language``
  on a small saved model: the JSON fields equal to the JAX CLIs'
  (probabilities at 1e-4), and each CLI's refusals with JAX's messages;
- ``/transcribe?identify_language=1`` on both request paths gives the
  JAX Transcriber's languages; the train CLI upcycles a dense checkpoint
  into an MoE + LID model and trains a labelled micro-step; a tiny MoE +
  LID model's ``.pt2`` export against its eager forward at 1e-5.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scripts.transcribe import Transcriber as JaxTranscriber
from tests.test_torch_moe import _perturb, assert_step_matches_jax
from velocity_asr_tpu import data as jdata
from velocity_asr_tpu import synth as jsynth
from velocity_asr_tpu import training as jtraining
from velocity_asr_tpu.decode import CTCDecoder as JaxDecoder
from velocity_asr_tpu.models import config as jconfig
from velocity_asr_tpu.models import model as jmodel
from velocity_asr_tpu_torch import data as tdata
from velocity_asr_tpu_torch import evaluate as tevaluate
from velocity_asr_tpu_torch import export as texport
from velocity_asr_tpu_torch import serve as tserve
from velocity_asr_tpu_torch import synth as tsynth
from velocity_asr_tpu_torch import training as ttraining
from velocity_asr_tpu_torch import transcribe as ttranscribe
from velocity_asr_tpu_torch.checkpoint import (params_from_numpy, params_to_numpy, read_params,
                                               write_msgpack)
from velocity_asr_tpu_torch.decode import CTCDecoder, create_default_vocabulary
from velocity_asr_tpu_torch.models import model as tmodel
from velocity_asr_tpu_torch.models.config import VelocityASRConfig

SMALL = dict(d_model=16, ssm_layers=2, ssm_state_dim=4, global_ssm_layers=1,
             global_ssm_state_dim=4, attention_heads=2, attention_dim=8, vocab_size=30,
             dropout=0.0, dtype="float32", stream_summary_tokens=8, stream_memory_chunks=2,
             num_languages=4)
COMMITTED = ["moe_run", "multilang_run", "multilang_moe_run"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: under xdist the workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ----- the multilingual corpus -----------------------------------------------------


@pytest.mark.parametrize("language", range(tsynth.NUM_SYNTH_LANGUAGES))
def test_language_lexicon_equals_jax(language):
    assert (tsynth.make_language_lexicon(language, 300, seed=5)
            == jsynth.make_language_lexicon(language, 300, seed=5))
    with pytest.raises(ValueError, match="out of range"):
        tsynth.make_language_lexicon(tsynth.NUM_SYNTH_LANGUAGES)


@pytest.mark.parametrize("device_mel", [False, True])
def test_multilingual_items_and_collation_equal_jax(device_mel):
    ours = tsynth.SyntheticSpeechDataset(8, split="train", languages=4, device_mel=device_mel)
    ref = jsynth.SyntheticSpeechDataset(8, split="train", languages=4, device_mel=device_mel)
    langs = [ours.language_for(i) for i in range(8)]
    assert langs == [ref.language_for(i) for i in range(8)] and len(set(langs)) > 1
    items, ref_items = [ours[i] for i in range(4)], [ref[i] for i in range(4)]
    for a, b in zip(items, ref_items):
        assert set(a) == set(b) and a["language"] == b["language"]
        for key in a:
            if key != "text":
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    batch = tdata.ASRCollator(frame_bucket=200)(items)
    ref_batch = jdata.ASRCollator(frame_bucket=200)(ref_items)
    assert batch["language"].dtype == np.int32
    np.testing.assert_array_equal(batch["language"], ref_batch["language"])
    assert ("audio" in batch) == device_mel
    with pytest.raises(ValueError, match="languages must be"):
        tsynth.SyntheticSpeechDataset(4, languages=tsynth.NUM_SYNTH_LANGUAGES + 1)


@pytest.mark.parametrize("languages", [1, 4])
def test_write_corpus_is_byte_equal_to_jax(tmp_path, languages):
    def files(root, n):
        manifest = open(os.path.join(root, "test_manifest.jsonl")).read()
        wavs = [open(os.path.join(root, f"test_{i:05d}.wav"), "rb").read() for i in range(n)]
        return manifest.replace(str(root), "ROOT"), wavs

    tsynth.write_corpus(str(tmp_path / "ours"), 6, languages=languages)
    jsynth.write_corpus(str(tmp_path / "jax"), 6, languages=languages)
    ours, theirs = files(tmp_path / "ours", 6), files(tmp_path / "jax", 6)
    assert ours == theirs
    assert ours[0].count('"language"') == (6 if languages > 1 else 0)
    # the first utterances of a longer corpus are the shorter corpus's
    tsynth.write_corpus(str(tmp_path / "short"), 3, languages=languages)
    short = files(tmp_path / "short", 3)
    assert short[0] == "".join(ours[0].splitlines(keepends=True)[:3]) and short[1] == ours[1][:3]


# ----- the head --------------------------------------------------------------------


def _pair(**overrides):
    cfg = {**SMALL, **overrides}
    jm = jmodel.create_model(jconfig.VelocityASRConfig(scan_mode="sequential", **cfg))
    params = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.zeros((1, 64, 80)))["params"], 6)
    port = tmodel.create_model(VelocityASRConfig(scan_mode="pallas", **cfg), device="cpu")
    port.load_state_dict(params_from_numpy(params), strict=True)
    return jm, params, port


@pytest.fixture(scope="module")
def lid_pair():
    return _pair()


@pytest.mark.parametrize("moe", [0, 4])
def test_lid_logits_match_jax(moe, lid_pair):
    jm, params, port = lid_pair if not moe else _pair(moe_experts=moe)
    mel = np.random.default_rng(1).standard_normal((2, 200, 80)).astype(np.float32)
    lengths = np.asarray([100, 61], np.int32)
    for fl in (lengths, None):
        ref, ref_feats = jmodel.forward(jm, params, jnp.asarray(mel), return_features=True,
                                        feature_lengths=None if fl is None else jnp.asarray(fl))
        with torch.no_grad():
            logits, feats = port(torch.from_numpy(mel), return_features=True,
                                 feature_lengths=None if fl is None else torch.from_numpy(fl))
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
        assert feats["lid_logits"].dtype == torch.float32
        np.testing.assert_allclose(feats["lid_logits"].numpy(), np.asarray(ref_feats["lid_logits"]),
                                   rtol=0, atol=1e-4)
    with torch.no_grad():  # a streaming step never computes the head
        out, _ = port(torch.from_numpy(mel[:, :64]), return_state=True)
    assert out.shape == (2, 32, 30)


def test_lid_head_init_follows_flax():
    cfg = {**SMALL, "d_model": 128, "num_languages": 64}
    jm = jmodel.create_model(jconfig.VelocityASRConfig(scan_mode="sequential", **cfg))
    assert "lid_head" in jax.eval_shape(lambda: jmodel.init_params(
        jm, jax.random.PRNGKey(0), example_frames=16))
    port = tmodel.create_model(VelocityASRConfig(**cfg), device="cpu")
    # the JAX head alone: a flax Dense with its default init, as model.py builds it
    import flax.linen as nn

    theirs = np.asarray(nn.Dense(64, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128)))["params"]["kernel"])
    ours = port.lid_head.weight.detach().numpy()
    std = (1 / 128) ** 0.5 / 0.87962566103423978
    for w in (ours, theirs):
        assert np.abs(w).max() <= 2 * std + 1e-7 and np.abs(w).max() > 1.9 * std
        assert w.std() == pytest.approx((1 / 128) ** 0.5, rel=0.05)  # lecun: var 1 / fan_in
    assert not port.lid_head.bias.detach().any()
    assert port.lid_norm.eps == 1e-6 and bool((port.lid_norm.weight == 1).all())


def test_ctc_plus_lid_step_matches_jax_grad(lid_pair):
    jm, params, port = lid_pair
    rng = np.random.default_rng(2)
    mel = rng.standard_normal((2, 200, 80)).astype(np.float32)
    mel[1, 150:] = 0.0
    targets = np.full((2, 32), 2, np.int32)
    targets[0, :20], targets[1, :14] = rng.integers(3, 30, 20), rng.integers(3, 30, 14)
    batch = {"mel_spectrogram": mel, "targets": targets,
             "input_lengths": np.asarray([200, 150], np.int32),
             "target_lengths": np.asarray([20, 14], np.int32),
             "language": np.asarray([3, 1], np.int32)}
    grads = assert_step_matches_jax(jm, params, port, batch, lid_loss_weight=0.3)
    assert np.abs(grads[("lid_head", "kernel")]).max() > 0


def test_lid_loss_without_head_raises_as_jax():
    cfg = {**SMALL, "num_languages": 0}
    port = tmodel.create_model(VelocityASRConfig(**cfg), device="cpu")
    jm = jmodel.create_model(jconfig.VelocityASRConfig(scan_mode="sequential", **cfg))
    msgs = []
    for build in (lambda: ttraining.Trainer(port, ttraining.TrainingConfig(lid_loss_weight=0.3),
                                            iter(())),
                  lambda: jtraining.Trainer(jm, jtraining.TrainingConfig(lid_loss_weight=0.3),
                                            iter(()))):
        with pytest.raises(ValueError) as err:
            build()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "num_languages > 0" in msgs[0]


# ----- the committed checkpoints ----------------------------------------------------


@pytest.mark.parametrize("name", COMMITTED)
def test_committed_checkpoint_loads_and_writes_back_byte_exact(name, tmp_path):
    ckpt = f"checkpoints/{name}/final_pretrained"
    model = tmodel.from_pretrained(ckpt, device="cpu")
    cfg = model.config
    assert (cfg.moe_experts > 0) == ("moe" in name)
    assert (cfg.num_languages > 0) == ("multilang" in name)
    assert (model.lid_head is not None) == (cfg.num_languages > 0)
    tmodel.save_pretrained(str(tmp_path), cfg, model)
    with open(os.path.join(ckpt, "params.msgpack"), "rb") as f:
        committed = f.read()
    with open(tmp_path / "params.msgpack", "rb") as f:
        assert f.read() == committed
    assert write_msgpack(params_to_numpy(model)) == committed
    back = params_from_numpy(read_params(str(tmp_path / "params.msgpack")))
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())


# ----- the CLIs and the server ----------------------------------------------------


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A small MoE + LID model saved by the port (its scan mode the JAX
    package's sequential oracle) and a 4-utterance multilingual corpus."""
    root = tmp_path_factory.mktemp("lid")
    cfg = VelocityASRConfig(**{**SMALL, "moe_experts": 4, "scan_mode": "sequential"})
    model = tmodel.create_model(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        model.lid_head.weight.mul_(30.0)  # well-separated languages, no near-ties
    tmodel.save_pretrained(str(root / "ckpt"), cfg, model)
    manifest = tsynth.write_corpus(str(root / "corpus"), 4, languages=4)
    return str(root / "ckpt"), manifest, root


def _run_jax_cli(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module] + argv)
    if module == "evaluate":
        from scripts.evaluate import main
    else:
        from scripts.transcribe import main
    return main()


def test_evaluate_identify_language_equals_jax_cli(saved, monkeypatch):
    ckpt, manifest, root = saved
    args = ["--checkpoint", ckpt, "--test-set", manifest, "--batch-size", "4",
            "--identify-language"]
    ours = tevaluate.main(args + ["--device", "cpu", "--output", str(root / "ours.json")])
    theirs = _run_jax_cli("evaluate", args + ["--output", str(root / "jax.json")], monkeypatch)
    assert ours["lid_accuracy"] == theirs["lid_accuracy"]
    a, b = (json.load(open(root / f)) for f in ("ours.json", "jax.json"))
    assert list(a) == list(b) and a["lid"] == b["lid"]
    for ra, rb in zip(a["results"], b["results"]):
        assert (ra["language_pred"], ra["language"]) == (rb["language_pred"], rb["language"])


def test_transcribe_identify_language_equals_jax_cli(saved, monkeypatch):
    ckpt, manifest, root = saved
    args = ["--input-dir", os.path.dirname(manifest), "--checkpoint", ckpt,
            "--identify-language", "--json"]
    assert ttranscribe.main(args + ["--device", "cpu", "--output", str(root / "t_ours.json")]) == 0
    _run_jax_cli("transcribe", args + ["--output", str(root / "t_jax.json")], monkeypatch)
    ours, theirs = (json.load(open(root / f)) for f in ("t_ours.json", "t_jax.json"))
    assert [r["file"] for r in ours] == [r["file"] for r in theirs] and len(ours) == 4
    for a, b in zip(ours, theirs):
        assert a["language"] == b["language"]
        assert a["language_prob"] == pytest.approx(b["language_prob"], abs=1e-4)
        np.testing.assert_allclose(a["language_probs"], b["language_probs"], atol=1e-4)


@pytest.mark.parametrize("cli,extra,message", [
    ("transcribe", ["x.wav", "--streaming"], "--identify-language is not supported with "
                                             "--streaming"),
    ("evaluate", ["--test-set", "m.jsonl", "--streaming"], "--identify-language is not "
                                                           "supported with --streaming"),
    ("evaluate", ["--audio-dir", "."], "--identify-language accuracy needs --test-set"),
])
def test_cli_refusals_match_jax(cli, extra, message, capsys):
    main = ttranscribe.main if cli == "transcribe" else tevaluate.main
    with pytest.raises(SystemExit):
        main(extra + ["--checkpoint", "c", "--identify-language"])
    assert message in capsys.readouterr().err
    source = open(f"scripts/{cli}.py").read()
    assert message.split("--identify-language ")[-1][:20] in source


def test_cli_refuses_a_headless_model(capsys):
    ckpt = "checkpoints/synth_run/final_pretrained"
    with pytest.raises(SystemExit):
        ttranscribe.main(["x.wav", "--checkpoint", ckpt, "--identify-language",
                          "--device", "cpu"])
    assert "requires a model with a LID head" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="requires a model with a LID head"):
        tevaluate.main(["--checkpoint", ckpt, "--test-set", "m.jsonl", "--identify-language",
                        "--device", "cpu"])


def test_server_identify_language_on_both_paths(saved):
    ckpt, manifest, _ = saved
    rows = [json.loads(line) for line in open(manifest)]
    jm, jp = jmodel.from_pretrained(ckpt)
    vocab = create_default_vocabulary(30)
    jax_tr = JaxTranscriber(jm, jp, JaxDecoder(vocab))
    service = tserve.ASRService(ttranscribe.Transcriber(tmodel.from_pretrained(ckpt, device="cpu"),
                                                        CTCDecoder(vocab)))
    try:
        for row in rows[:2]:
            data = open(row["audio_path"], "rb").read()
            ref = {}
            jax_tr._lid_result(ttranscribe.load_audio(row["audio_path"]), ref)
            for timestamps in (False, True):  # the micro-batched path, the single one
                got = service.transcribe_bytes(data, timestamps=timestamps, beam=0,
                                               identify_language=True)
                assert got["language"] == ref["language"]
                np.testing.assert_allclose(got["language_probs"], ref["language_probs"],
                                           atol=1e-4)
                assert "text" in got
    finally:
        service.close()


def test_train_cli_upcycles_a_dense_checkpoint_and_grafts_the_head(tmp_path):
    """--init-from a dense, head-less checkpoint into an MoE + LID config
    on the multilingual corpus: every expert starts as its block's FFN,
    the head as the fresh model's, and one labelled micro-step trains."""
    from velocity_asr_tpu_torch import train as ttrain

    dense_cfg = VelocityASRConfig(**{**SMALL, "num_languages": 0, "dropout": 0.1})
    dense = tmodel.create_model(dense_cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    tmodel.save_pretrained(str(tmp_path / "dense"), dense_cfg, dense)
    (tmp_path / "model.yaml").write_text(
        "model:\n  d_model: 16\n  dropout: 0.0\nssm:\n  num_layers: 2\n  state_dim: 4\n"
        "  moe_experts: 4\n  moe_top_k: 2\nglobal_context:\n  ssm_layers: 1\n"
        "  ssm_state_dim: 4\n  attention_heads: 2\n  attention_dim: 8\n"
        "output:\n  vocab_size: 30\n  num_languages: 4\nperformance:\n  dtype: float32\n")
    (tmp_path / "train.yaml").write_text(
        "data:\n  synthetic: 8\n  synthetic_languages: 4\n  synthetic_max_words: 3\n"
        "training:\n  batch_size: 2\n  max_steps: 1\n  lid_loss_weight: 0.3\n"
        "  use_amp: false\nlogging:\n  log_interval: 1\n")
    seen = []
    loss = ttraining.Trainer._loss
    ttraining.Trainer._loss = lambda self, batch, rng: seen.append(set(batch)) or loss(
        self, batch, rng)
    try:
        out = ttrain.main(["--config", str(tmp_path / "train.yaml"), "--model-config",
                           str(tmp_path / "model.yaml"), "--init-from", str(tmp_path / "dense"),
                           "--checkpoint-dir", str(tmp_path / "run"), "--num-workers", "0",
                           "--device", "cpu"])
    finally:
        ttraining.Trainer._loss = loss
    assert "language" in seen[0] and np.isfinite(out["history"]["train_loss"][0])
    fresh = tmodel.create_model(out["trainer"].model.config, device="cpu")
    tree = ttrain.init_tree(params_to_numpy(dense), fresh)
    dense_tree = params_to_numpy(dense)
    for i in range(2):
        moe, ffn = tree["local_ssm"][f"layers_{i}"]["moe"], dense_tree["local_ssm"][f"layers_{i}"]
        for e in range(4):
            np.testing.assert_array_equal(moe["w_in"][e], ffn["ffn_in"]["kernel"])
            np.testing.assert_array_equal(moe["b_out"][e], ffn["ffn_out"]["bias"])
    np.testing.assert_array_equal(tree["lid_head"]["kernel"],
                                  fresh.lid_head.weight.detach().numpy().T)
    saved = tmodel.from_pretrained(str(tmp_path / "run" / "final_pretrained"), device="cpu")
    assert saved.config.moe_experts == 4 and saved.lid_head is not None


def test_moe_lid_export_matches_eager(tmp_path):
    cfg = VelocityASRConfig(**{**SMALL, "moe_experts": 4})
    model = tmodel.create_model(cfg, device="cpu")
    path = texport.export_program(model, str(tmp_path / "m.pt2"), (1, 120, 80))
    mel = torch.randn(1, 120, 80, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        np.testing.assert_allclose(texport.load_exported(path)(mel).numpy(),
                                   model(mel).numpy(), rtol=1e-5, atol=1e-5)
