"""The entry points on the new data sources and formats, on the committed
checkpoint (``checkpoints/synth_run/final_pretrained``) on the CPU:

- ``evaluate --audio-dir`` over a directory of WAV and FLAC files gives
  the texts ``transcribe --input-dir`` gives (a FLAC of a WAV's int16 PCM
  is lossless, so both files of an utterance give one text), and refuses
  ``--int8-static``;
- ``evaluate --test-set <split> --librispeech-root`` reads a LibriSpeech
  tree and scores the same transcripts as the manifest over the same
  files, batched and ``--streaming``;
- a FLAC body to ``/transcribe`` returns its WAV's text, and an
  undecodable body stays a 400;
- ``python -m velocity_asr_tpu_torch.train`` from a LibriSpeech tree, a
  manifest and dummy data takes its steps.

Transcripts are compared exactly.
"""

import http.client
import json
import os
import shutil
import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from tests.flac_encoder import encode_flac
from velocity_asr_tpu_torch import evaluate as tevaluate
from velocity_asr_tpu_torch import serve as tserve
from velocity_asr_tpu_torch import synth as tsynth
from velocity_asr_tpu_torch import train as ttrain
from velocity_asr_tpu_torch import transcribe as ttranscribe
from velocity_asr_tpu_torch.io import decode_audio_file

CKPT = "checkpoints/synth_run/final_pretrained"
SPLIT = "test-clean"
SMALL_MODEL_YAML = (
    "model:\n  d_model: 32\n  dropout: 0.1\nssm:\n  num_layers: 2\n  state_dim: 8\n"
    "global_context:\n  ssm_layers: 1\n  ssm_state_dim: 4\n  attention_dim: 16\n"
    "output:\n  vocab_size: 30\nperformance:\n  scan_mode: pallas\n")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: under xdist the workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flac_of(wav_path, flac_path):
    data, _ = decode_audio_file(wav_path)
    pcm = np.round(data[0] * 32768.0).astype(np.int16)
    with open(flac_path, "wb") as f:
        f.write(encode_flac(pcm, mode="fixed2"))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three held-out utterances as WAVs, and a LibriSpeech tree (FLAC) of
    the same three with its manifest."""
    root = tmp_path_factory.mktemp("cli")
    wavs = str(root / "wavs")
    tsynth.write_corpus(wavs, 3, split="test", seed=1234)
    tree = str(root / "tree")
    manifest = tsynth.write_librispeech_tree(tree, SPLIT, 3, encode_flac, speakers=1,
                                             chapters=1, synth_split="test")
    return wavs, tree, manifest


def test_evaluate_audio_dir_matches_transcribe(corpus, tmp_path):
    wavs, _, _ = corpus
    mixed = tmp_path / "mixed"
    mixed.mkdir()
    for i in range(2):
        src = os.path.join(wavs, f"test_{i:05d}.wav")
        shutil.copy(src, mixed / f"u{i}.wav")
        _flac_of(src, str(mixed / f"u{i}_copy.flac"))
    (mixed / "notes.txt").write_text("not audio")
    out_eval, out_tr = tmp_path / "eval.json", tmp_path / "tr.json"
    tevaluate.main(["--checkpoint", CKPT, "--audio-dir", str(mixed), "--device", "cpu",
                    "--output", str(out_eval)])
    assert ttranscribe.main(["--input-dir", str(mixed), "--checkpoint", CKPT, "--device", "cpu",
                             "--json", "--output", str(out_tr)]) == 0
    got, want = json.loads(out_eval.read_text()), json.loads(out_tr.read_text())
    assert [r["file"] for r in got] == [r["file"] for r in want] == [
        str(mixed / n) for n in ("u0.wav", "u0_copy.flac", "u1.wav", "u1_copy.flac")]
    assert [r["text"] for r in got] == [r["text"] for r in want]
    assert got[0]["text"] == got[1]["text"] and got[2]["text"] == got[3]["text"]
    with pytest.raises(SystemExit):
        tevaluate.main(["--checkpoint", CKPT, "--audio-dir", str(mixed), "--int8-static"])


def test_evaluate_audio_dir_lists_failed_files(corpus, tmp_path):
    """A file that does not decode is listed with its error, as the
    transcribe CLI lists it, and the others are transcribed."""
    wavs, _, _ = corpus
    mixed = tmp_path / "mixed"
    mixed.mkdir()
    shutil.copy(os.path.join(wavs, "test_00000.wav"), mixed / "a.wav")
    (mixed / "b.flac").write_bytes(b"fLaC" + bytes(64))
    out_eval, out_tr = tmp_path / "eval.json", tmp_path / "tr.json"
    tevaluate.main(["--checkpoint", CKPT, "--audio-dir", str(mixed), "--device", "cpu",
                    "--output", str(out_eval)])
    assert ttranscribe.main(["--input-dir", str(mixed), "--checkpoint", CKPT, "--device", "cpu",
                             "--json", "--output", str(out_tr)]) == 1
    got, want = ([{k: v for k, v in r.items() if k != "rtf"} for r in json.loads(p.read_text())]
                 for p in (out_eval, out_tr))
    assert got == want
    assert [r["file"] for r in got] == [str(mixed / "a.wav"), str(mixed / "b.flac")]
    assert "text" in got[0] and "native decoder failed" in got[1]["error"]


@pytest.mark.parametrize("streaming", [False, True])
def test_evaluate_librispeech_split_matches_manifest(corpus, tmp_path, streaming):
    _, tree, manifest = corpus
    extra = ["--streaming"] if streaming else []
    results = []
    for test_set in (["--test-set", SPLIT, "--librispeech-root", tree],
                     ["--test-set", manifest]):
        out = tmp_path / f"r{len(results)}.json"
        tevaluate.main(["--checkpoint", CKPT, *test_set, "--device", "cpu", "--batch-size",
                        "2", "--output", str(out), *extra])
        results.append(json.loads(out.read_text()))
    split, man = results
    assert split["utterances"] == man["utterances"] == 3
    assert split["results"] == man["results"] and split["wer"] == man["wer"]
    assert split["wer"] < 0.5


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/transcribe", body=body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_flac_body_to_transcribe(corpus, tmp_path):
    wavs, _, _ = corpus
    wav = os.path.join(wavs, "test_00001.wav")
    flac = str(tmp_path / "u.flac")
    _flac_of(wav, flac)
    svc = tserve.ASRService.from_checkpoint(CKPT, device="cpu", max_streams=1)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), tserve.make_handler(svc))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        port = httpd.server_address[1]
        with open(wav, "rb") as f:
            status_wav, out_wav = _post(port, f.read())
        with open(flac, "rb") as f:
            status_flac, out_flac = _post(port, f.read())
        status_bad, out_bad = _post(port, b"fLaC" + bytes(64))
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.close()
    assert status_wav == status_flac == 200
    assert out_flac["text"] == out_wav["text"] and out_wav["text"]
    assert out_flac["duration"] == out_wav["duration"]
    assert status_bad == 400 and "native decoder failed on request body" in out_bad["error"]


def _yaml(path, text):
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("source", ["librispeech", "manifest", "dummy"])
def test_train_cli_from_each_source(corpus, tmp_path, source):
    """Two micro-steps from each source; the vocabulary written beside
    the weights is the source's (LibriSpeech's 31 tokens, the manifest's
    characters, none for dummy data)."""
    _, tree, manifest = corpus
    data = {"librispeech": f"  librispeech_root: {tree}\n  train_splits: [{SPLIT}]\n"
                           f"  val_splits: [{SPLIT}]\n",
            "manifest": f"  manifest: {manifest}\n  eval_manifest: {manifest}\n",
            "dummy": "  frame_bucket: 200\n"}[source]
    config = _yaml(tmp_path / "train.yaml",
                   f"data:\n{data}training:\n  batch_size: 2\n  max_steps: 2\n"
                   "optimizer:\n  warmup_steps: 1\nlogging:\n  log_interval: 1\n"
                   "  eval_interval: 2\n")
    model = _yaml(tmp_path / "model.yaml", SMALL_MODEL_YAML)
    out = ttrain.main(["--config", config, "--model-config", model, "--max-steps", "2",
                       "--num-workers", "0", "--device", "cpu",
                       "--checkpoint-dir", str(tmp_path / "run")])
    assert len(out["history"]["train_loss"]) == 2
    assert all(np.isfinite(out["history"]["train_loss"]))
    vocab_file = tmp_path / "run" / "final_pretrained" / "vocabulary.json"
    if source == "dummy":
        assert not vocab_file.exists() and out["history"]["eval_loss"] == []
        assert out["trainer"].model.config.vocab_size == 30
    else:
        vocab = json.loads(vocab_file.read_text())
        assert len(vocab) == out["trainer"].model.config.vocab_size
        assert ("'" in vocab) == (source == "librispeech")
        assert len(out["history"]["eval_loss"]) == 1
