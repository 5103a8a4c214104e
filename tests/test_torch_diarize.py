"""The port's speaker diarization (``velocity_asr_tpu_torch/diarize.py``,
the speaker and conversation parts of ``synth.py``, the server's
/diarize) against the JAX package's:

- synth: speaker profiles, ``render`` with and without a profile and
  without noise (bit-equal; the default path is the ASR corpus's),
  ``render_conversation``, both datasets' items and
  ``write_conversations``' manifest and WAVs, all bit-exact;
- ``SpeakerEncoder`` / ``SpeakerClassifier`` on carried weights, with and
  without ``input_lengths``: fp32 within 1e-5, bf16 within 1e-2 (bf16
  rounds each Dense's inputs and outputs to 8 bits of mantissa, 3.9e-3
  relative, and the two packages round at different places); the
  Diarizer's masked window normalisation with the encoder; the
  AM-softmax loss with n_valid;
- one ``SpeakerTrainer`` micro-step (dropout off) against ``jax.grad`` of
  the JAX ``_loss_fn``: loss rel 1e-5, gradients within 1e-4 of their max;
- the host functions (VAD, regions, windows, DER, AHC, centroid
  reassignment, k-means, silhouette, spectral clustering) equal to JAX's;
- ``Diarizer.diarize`` with the committed ``speaker_run`` encoder on a
  short conversation: the same segments as the JAX Diarizer's;
- speaker artifacts both ways bit-equal (the committed ones written back
  byte for byte);
- the CLI (train, eval, files with transcripts) and the server's
  /diarize on the CPU at tiny size.
"""

import dataclasses
import json
import os
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_pretrain import assert_grads_match, perturbed
from velocity_asr_tpu import diarize as jdiarize
from velocity_asr_tpu import synth as jsynth
from velocity_asr_tpu import training as jtraining
from velocity_asr_tpu_torch import diarize as tdiarize
from velocity_asr_tpu_torch import serve as tserve
from velocity_asr_tpu_torch import synth as tsynth
from velocity_asr_tpu_torch import training as ttraining
from velocity_asr_tpu_torch.audio import compute_mel_spectrogram_np, load_audio
from velocity_asr_tpu_torch.checkpoint import (_flatten, params_from_numpy, params_to_numpy,
                                               read_params, write_msgpack)
from velocity_asr_tpu_torch.decode import CTCDecoder, create_default_vocabulary
from velocity_asr_tpu_torch.models import model as tmodel
from velocity_asr_tpu_torch.models.config import VelocityASRConfig
from velocity_asr_tpu_torch.transcribe import Transcriber

SPEAKER_RUN = "checkpoints/speaker_run/final_speaker"
COMMITTED = [SPEAKER_RUN, "checkpoints/speaker_v2/final_speaker"]
SMALL = dict(d_model=32, ssm_layers=2, ssm_state_dim=8, embedding_dim=16, n_speakers=5,
             dropout=0.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: under xdist the workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ----- synth ----------------------------------------------------------------------


def test_speaker_profiles_equal_jax():
    for i in (0, 7, 1_000_016):
        assert (dataclasses.asdict(tsynth.SpeakerProfile.for_id(i, seed=5))
                == dataclasses.asdict(jsynth.SpeakerProfile.for_id(i, seed=5)))
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    assert (dataclasses.asdict(tsynth.SpeakerProfile.sample(rng_a))
            == dataclasses.asdict(jsynth.SpeakerProfile.sample(rng_b)))


@pytest.mark.parametrize("profile,noise", [(None, True), (3, True), (3, False), (None, False)])
def test_render_equals_jax(profile, noise):
    ours, theirs = tsynth.SynthVoice(seed=11), jsynth.SynthVoice(seed=11)
    args = dict(add_noise=noise)
    a = ours.render("ab cde fg", np.random.default_rng(2), profile=None if profile is None
                    else tsynth.SpeakerProfile.for_id(profile), **args)
    b = theirs.render("ab cde fg", np.random.default_rng(2), profile=None if profile is None
                      else jsynth.SpeakerProfile.for_id(profile), **args)
    assert a.dtype == np.float32 and np.array_equal(a, b)
    if profile is None and noise:  # the ASR corpus's default path, unchanged
        assert np.array_equal(a, ours.render("ab cde fg", np.random.default_rng(2)))


def test_render_conversation_equals_jax():
    turns = [(0, "ab cd"), (1, "efg"), (0, "hij kl")]
    a, segs_a = tsynth.render_conversation(
        tsynth.SynthVoice(), turns, [tsynth.SpeakerProfile.for_id(k) for k in (4, 9)],
        np.random.default_rng(8))
    b, segs_b = jsynth.render_conversation(
        jsynth.SynthVoice(), turns, [jsynth.SpeakerProfile.for_id(k) for k in (4, 9)],
        np.random.default_rng(8))
    assert np.array_equal(a, b) and segs_a == segs_b and len(segs_a) == 3


def test_datasets_equal_jax():
    ours = tsynth.SyntheticSpeakerDataset(5, 3, split="eval", max_words=3)
    theirs = jsynth.SyntheticSpeakerDataset(5, 3, split="eval", max_words=3)
    assert len(ours) == len(theirs) == 15
    for i in (0, 6, 14):
        a, b = ours[i], theirs[i]
        assert set(a) == set(b) and a["text"] == b["text"] and a["targets"].tolist() == [i % 5]
        for key in ("mel_spectrogram", "input_lengths", "targets", "target_lengths"):
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key
    conv_a = tsynth.SyntheticConversationDataset(3, turns_range=(2, 3), words_range=(1, 2))[2]
    conv_b = jsynth.SyntheticConversationDataset(3, turns_range=(2, 3), words_range=(1, 2))[2]
    assert np.array_equal(conv_a["audio"], conv_b["audio"])
    assert conv_a["segments"] == conv_b["segments"]
    assert conv_a["n_speakers"] == conv_b["n_speakers"]


def test_write_conversations_is_byte_equal_to_jax(tmp_path):
    kw = dict(turns_range=(2, 3), words_range=(1, 3))
    for root, mod in (("ours", tsynth), ("jax", jsynth)):
        mod.write_conversations(str(tmp_path / root), 2, **kw)
    for name in ("test_conv_0000.wav", "test_conv_0001.wav"):
        assert (tmp_path / "ours" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    manifests = [(tmp_path / r / "test_conversations.jsonl").read_text().replace(str(tmp_path / r),
                                                                                "R")
                 for r in ("ours", "jax")]
    assert manifests[0] == manifests[1] and manifests[0].count('"segments"') == 2


# ----- the model ------------------------------------------------------------------


def _classifier_pair(dtype="float32"):
    jm = jdiarize.SpeakerClassifier(config=jdiarize.SpeakerEncoderConfig(
        scan_mode="sequential", dtype=dtype, **SMALL))
    params = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 80)))["params"],
                       1)
    port = tdiarize.SpeakerClassifier(tdiarize.SpeakerEncoderConfig(scan_mode="pallas",
                                                                    dtype=dtype, **SMALL))
    port.load_state_dict(params_from_numpy(params), strict=True)
    return jm, params, port.eval()


@pytest.fixture(scope="module")
def fp32_pair():
    return _classifier_pair()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_classifier_matches_jax(dtype, fp32_pair):
    jm, params, port = fp32_pair if dtype == "float32" else _classifier_pair(dtype)
    mel = np.random.default_rng(0).standard_normal((3, 61, 80)).astype(np.float32)
    tol = 1e-5 if dtype == "float32" else 1e-2
    for lengths in (np.asarray([61, 40, 9], np.int32), None):
        emb, cos = jm.apply({"params": params}, jnp.asarray(mel),
                            input_lengths=None if lengths is None else jnp.asarray(lengths))
        with torch.no_grad():
            e, c = port(torch.from_numpy(mel),
                        None if lengths is None else torch.from_numpy(lengths))
        assert e.dtype == c.dtype == torch.float32
        np.testing.assert_allclose(e.numpy(), np.asarray(emb), rtol=0, atol=tol)
        np.testing.assert_allclose(c.numpy(), np.asarray(cos), rtol=0, atol=tol)
        np.testing.assert_allclose(np.linalg.norm(e.numpy(), axis=1), 1.0, atol=1e-5)


def test_diarizer_window_normalisation_matches_jax(fp32_pair):
    _, params, _ = fp32_pair
    cfg = jdiarize.SpeakerEncoderConfig(scan_mode="sequential", **SMALL)
    ours = tdiarize.Diarizer(encoder_config=tdiarize.SpeakerEncoderConfig(**SMALL),
                             encoder_params=params["encoder"], device="cpu")
    theirs = jdiarize.Diarizer(encoder_config=cfg, encoder_params=params["encoder"])
    rng = np.random.default_rng(4)
    windows = (rng.standard_normal((4, 150, 80)) * 3 - 5).astype(np.float32)
    lengths = np.asarray([150, 90, 31, 1], np.int32)
    windows[np.arange(150)[None, :] >= lengths[:, None]] = 0.0
    ref = np.asarray(theirs._embed(params["encoder"], jnp.asarray(windows), jnp.asarray(lengths)))
    got = ours._embed(torch.from_numpy(windows), torch.from_numpy(lengths.astype(np.int64)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    # and through the host planning: embed_windows over a raw mel
    mel = (rng.standard_normal((500, 80)) - 4).astype(np.float32)
    plan = [(0, 150), (120, 150), (400, 100), (480, 20)]
    np.testing.assert_allclose(ours.embed_windows(mel, plan), theirs.embed_windows(mel, plan),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_valid", [None, 3])
def test_am_softmax_loss_matches_jax(n_valid):
    rng = np.random.default_rng(2)
    cos = np.tanh(rng.standard_normal((5, 7))).astype(np.float32)
    labels = rng.integers(0, 7, 5).astype(np.int32)
    ours = tdiarize.am_softmax_loss(torch.from_numpy(cos), torch.from_numpy(labels), 0.2, 30.0,
                                    n_valid)
    theirs = jdiarize.am_softmax_loss(jnp.asarray(cos), jnp.asarray(labels), 0.2, 30.0,
                                      None if n_valid is None else jnp.asarray(n_valid))
    assert float(ours) == pytest.approx(float(theirs), rel=1e-6)


def test_speaker_trainer_step_matches_jax_grad(fp32_pair):
    jm, params, port = fp32_pair
    rng = np.random.default_rng(3)
    mel = rng.standard_normal((3, 100, 80)).astype(np.float32)
    mel[2, 57:] = 0.0
    batch = {"mel_spectrogram": mel, "targets": np.asarray([[4], [0], [2]], np.int32),
             "input_lengths": np.asarray([100, 100, 57], np.int32),
             "target_lengths": np.ones(3, np.int32)}
    cfg = dict(learning_rate=1e-3, warmup_steps=2, max_steps=4, num_data_shards=1)
    jt = jdiarize.SpeakerTrainer(jm, jtraining.TrainingConfig(**cfg), iter([batch]),
                                 params=params)
    sharded, n_valid = jt.shard_batch(batch)
    ref, ref_g = jax.jit(jax.value_and_grad(
        lambda p: jt._loss_fn(p, None, sharded, jax.random.PRNGKey(0), True, n_valid)[0]))(
        params)
    tt = tdiarize.SpeakerTrainer(port, ttraining.TrainingConfig(**cfg), iter(()))
    port.train()
    try:
        grads = assert_grads_match(port, tt._loss(tt._to_device(batch), torch.Generator()),
                                   ref, ref_g)
    finally:
        port.eval()
    assert np.abs(grads[("class_weights",)]).max() > 0


def test_speaker_trainer_refuses_streaming_as_jax(fp32_pair):
    jm, _, port = fp32_pair
    msgs = []
    for build in (lambda: tdiarize.SpeakerTrainer(
                      port, ttraining.TrainingConfig(streaming_chunks=2), iter(())),
                  lambda: jdiarize.SpeakerTrainer(
                      jm, jtraining.TrainingConfig(streaming_chunks=2), iter(()))):
        with pytest.raises(ValueError) as err:
            build()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_speaker_model_init_follows_flax():
    cfg = tdiarize.SpeakerEncoderConfig(**SMALL)
    port = tdiarize.create_speaker_model(cfg, device="cpu")
    w = port.class_weights.detach().numpy()
    assert w.shape == (5, 16) and 0.035 < w.std() < 0.065
    proj = port.encoder.emb_proj.weight.detach().numpy()
    std = (1 / 64) ** 0.5 / 0.87962566103423978
    assert proj.shape == (16, 64) and np.abs(proj).max() <= 2 * std + 1e-7
    jm = jdiarize.SpeakerClassifier(config=jdiarize.SpeakerEncoderConfig(**SMALL))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 80))))
    assert ({k: v.shape for k, v in _flatten(shapes["params"])}
            == {k: v.shape for k, v in _flatten(params_to_numpy(port))})


# ----- host functions -----------------------------------------------------------


def _clustered_embeddings(seed, k=3, n=40, dim=16, spread=0.35):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, dim))
    labels = rng.integers(0, k, n)
    return (centers[labels] + spread * rng.standard_normal((n, dim))).astype(np.float32)


def test_vad_regions_windows_equal_jax():
    audio = jsynth.SyntheticConversationDataset(1, turns_range=(3, 3))[0]["audio"]
    mel = compute_mel_spectrogram_np(audio, normalize=False)
    for thr in (0.15, 0.35):
        a = tdiarize.energy_vad(mel, thr)
        b = jdiarize.energy_vad(mel, thr)
        assert np.array_equal(a, b) and a.any() and not a.all()
        assert tdiarize.speech_regions(a) == jdiarize.speech_regions(b)
        for window, hop in ((150, 40), (60, 60)):
            assert (tdiarize.window_plan(tdiarize.speech_regions(a), window, hop)
                    == jdiarize.window_plan(jdiarize.speech_regions(b), window, hop))
    assert not tdiarize.energy_vad(np.zeros((50, 80), np.float32)).any()


def test_der_equals_jax():
    ref = [{"start": 0.0, "end": 2.0, "speaker": 0}, {"start": 2.5, "end": 4.0, "speaker": 1},
           {"start": 3.5, "end": 5.0, "speaker": 0}]
    hyps = [[(0.1, 1.9, 5), (2.4, 4.2, 6)], [], [(0.0, 5.0, "a")],
            [{"start": 0.0, "end": 2.0, "speaker": 1}, {"start": 2.5, "end": 5.0, "speaker": 0}]]
    for hyp in hyps:
        for collar in (0.0, 0.25):
            assert (tdiarize.diarization_error_rate(ref, hyp, collar)
                    == jdiarize.diarization_error_rate(ref, hyp, collar))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clustering_equals_jax(seed):
    emb = _clustered_embeddings(seed)
    for n_spk in (None, 2, 3):
        assert np.array_equal(tdiarize.cluster_embeddings(emb, n_spk),
                              jdiarize.cluster_embeddings(emb, n_spk))
        assert np.array_equal(tdiarize.spectral_cluster_embeddings(emb, n_spk),
                              jdiarize.spectral_cluster_embeddings(emb, n_spk))
    labels = tdiarize.spectral_cluster_embeddings(emb)
    assert np.array_equal(tdiarize.reassign_to_centroids(emb, labels, 2),
                          jdiarize.reassign_to_centroids(emb, labels, 2))
    assert tdiarize._mean_silhouette(emb, labels) == jdiarize._mean_silhouette(emb, labels)
    x = emb[:, :4].astype(np.float64)
    assert np.array_equal(tdiarize._kmeans(x, 3, seed=seed), jdiarize._kmeans(x, 3, seed=seed))
    for n in (0, 1):
        assert tdiarize.spectral_cluster_embeddings(emb[:n]).tolist() == [0] * n


@pytest.fixture(scope="module")
def committed_diarizers():
    """The committed speaker_run encoder in both packages (JAX's
    sequential scan, which compiles in seconds)."""
    cfg, params = jdiarize.load_speaker_artifact(SPEAKER_RUN)
    theirs = jdiarize.Diarizer(encoder_config=dataclasses.replace(cfg, scan_mode="sequential"),
                               encoder_params=params["encoder"])
    return tdiarize.Diarizer(SPEAKER_RUN, device="cpu"), theirs


def test_diarize_short_conversation_equals_jax(committed_diarizers):
    ours, theirs = committed_diarizers
    conv = tsynth.SyntheticConversationDataset(1, turns_range=(4, 4), words_range=(3, 5),
                                               split="dev")[0]
    for n_spk in (None, conv["n_speakers"]):
        a = [s.to_dict() for s in ours.diarize(conv["audio"], n_speakers=n_spk)]
        b = [s.to_dict() for s in theirs.diarize(conv["audio"], n_speakers=n_spk)]
        assert a == b and len(a) >= 2
    assert tdiarize.diarization_error_rate(conv["segments"], a)["der"] < 0.2


# ----- artifacts ------------------------------------------------------------------


@pytest.mark.parametrize("path", COMMITTED)
def test_committed_artifacts_read_and_write_back_byte_exact(path, tmp_path):
    cfg, tree = tdiarize.load_speaker_artifact(path)
    assert tdiarize.is_speaker_artifact(path)
    model = tdiarize.SpeakerClassifier(cfg)
    model.load_state_dict(params_from_numpy(tree), strict=True)
    tdiarize.save_speaker_artifact(str(tmp_path), cfg, model)
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        assert (tmp_path / "params.msgpack").read_bytes() == f.read()
    with open(os.path.join(path, "config.json")) as f:
        assert json.loads((tmp_path / "config.json").read_text()) == json.load(f)


def test_port_artifact_reads_in_jax_bit_equal(fp32_pair, tmp_path):
    _, params, port = fp32_pair
    cfg = tdiarize.SpeakerEncoderConfig(scan_mode="sequential", **SMALL)
    tdiarize.save_speaker_artifact(str(tmp_path), cfg, port)
    jcfg, jparams = jdiarize.load_speaker_artifact(str(tmp_path))
    assert jcfg.to_dict() == cfg.to_dict()
    ours, theirs = dict(_flatten(params)), dict(_flatten(jax.device_get(jparams)))
    assert set(ours) == set(theirs) and all(np.array_equal(ours[k], theirs[k]) for k in ours)
    assert write_msgpack(read_params(str(tmp_path / "params.msgpack"))) == (
        tmp_path / "params.msgpack").read_bytes()
    with pytest.raises(ValueError, match="not a speaker-embedding artifact"):
        tdiarize.load_speaker_artifact("checkpoints/synth_run/final_pretrained")


# ----- the CLI and the server ---------------------------------------------------


@pytest.fixture(scope="module")
def tiny_asr(tmp_path_factory):
    root = tmp_path_factory.mktemp("asr")
    cfg = VelocityASRConfig(d_model=16, ssm_layers=1, ssm_state_dim=4, global_ssm_layers=1,
                            global_ssm_state_dim=4, attention_heads=2, attention_dim=8,
                            vocab_size=30, dtype="float32")
    tmodel.save_pretrained(str(root), cfg, tmodel.create_model(cfg, device="cpu"))
    return str(root)


def test_cli_train_eval_files(tmp_path, tiny_asr, capsys):
    ckpt = str(tmp_path / "spk")
    trainer = tdiarize.main(["train", "--checkpoint-dir", ckpt, "--num-speakers", "3",
                             "--utts-per-speaker", "2", "--steps", "2", "--batch-size", "2",
                             "--d-model", "16", "--layers", "1", "--embedding-dim", "8",
                             "--max-words", "2", "--num-workers", "0", "--device", "cpu"])
    assert trainer.global_step == 2 and trainer.config.warmup_steps == 0
    art = os.path.join(ckpt, "final_speaker")
    jcfg, _ = jdiarize.load_speaker_artifact(art)  # JAX reads what the CLI wrote
    assert (jcfg.d_model, jcfg.ssm_layers, jcfg.n_speakers) == (16, 1, 3)
    out = str(tmp_path / "der.json")
    agg = tdiarize.main(["eval", "--speaker-model", art, "--num-convs", "1",
                         "--known-speakers", "--out", out, "--device", "cpu"])
    keys = {"der", "miss_rate", "fa_rate", "confusion_rate", "mean_der",
            "speaker_count_accuracy", "n_conversations", "total_speech_s", "collar",
            "known_speakers", "cluster_method", "speaker_model"}
    with open("checkpoints/speaker_run/der_known_k.json") as f:
        assert set(json.load(f)) == keys
    with open(out) as f:
        assert json.load(f) == agg and set(agg) == keys
    wav_dir = tmp_path / "convs"
    tsynth.write_conversations(str(wav_dir), 1, turns_range=(2, 2), words_range=(2, 3))
    wav = str(wav_dir / "test_conv_0000.wav")
    records = tdiarize.main(["files", wav, str(tmp_path / "missing.wav"), "--speaker-model",
                             art, "--asr-model", tiny_asr, "--num-speakers", "2", "--json",
                             "--device", "cpu"])
    assert records[0]["segments"] and all("text" in s for s in records[0]["segments"])
    assert "error" in records[1]  # per-file isolation
    assert json.loads(capsys.readouterr().out) == records


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_diarize(committed_diarizers, tiny_asr, tmp_path):
    diarizer, _ = committed_diarizers
    model = tmodel.from_pretrained(tiny_asr, device="cpu")
    transcriber = Transcriber(model, CTCDecoder(create_default_vocabulary(30)))
    tsynth.write_conversations(str(tmp_path), 1, turns_range=(3, 3), words_range=(2, 3))
    wav = (tmp_path / "test_conv_0000.wav").read_bytes()
    pcm = load_audio(str(tmp_path / "test_conv_0000.wav"))
    servers = []
    try:
        for diar in (diarizer, None):
            service = tserve.ASRService(transcriber, diarizer=diar)
            server = ThreadingHTTPServer(("127.0.0.1", 0), tserve.make_handler(service))
            threading.Thread(target=server.serve_forever, daemon=True).start()
            servers.append((server, service))
        port, bare = (s.server_address[1] for s, _ in servers)
        for query, n_spk in (("", None), ("?num_speakers=2&transcripts=1", 2)):
            code, out = _post(port, f"/diarize{query}", wav)
            want = [s.to_dict() for s in diarizer.diarize(pcm, n_speakers=n_spk)]
            assert code == 200 and set(out) == {"segments", "num_speakers", "duration", "rtf"}
            got = [{k: v for k, v in s.items() if k != "text"} for s in out["segments"]]
            assert got == json.loads(json.dumps(want))
            assert out["num_speakers"] == len({s["speaker"] for s in want})
            assert all(("text" in s) == bool(query) for s in out["segments"])
        assert _post(port, "/diarize?num_speakers=x", wav)[0] == 400
        code, out = _post(bare, "/diarize", wav)
        assert code == 400 and "--speaker-model" in out["error"]
    finally:
        for server, service in servers:
            server.shutdown()
            server.server_close()
            service.close()
