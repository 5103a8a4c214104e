"""The port's evaluation pipeline against the JAX package's: ASRDataset,
ASRCollator and calibration_batches (data.py), compute_wer/compute_cer
(training.py), and the batched greedy evaluation (evaluate.py) against
the greedy batch branch of scripts/evaluate.py, on a 6-utterance
held-out synthetic manifest written under tmp_path.

Tolerances: items, batches and metrics are bit-exact (the same numpy
host mel, padding and dynamic programming on both sides); the
evaluation gives the same transcripts.
"""

import json

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velocity_asr_tpu import data as jdata
from velocity_asr_tpu import decode as jdecode
from velocity_asr_tpu import training as jtraining
from velocity_asr_tpu.models import config as jconfig
from velocity_asr_tpu.models import model as jmodel
from velocity_asr_tpu_torch import data as tdata
from velocity_asr_tpu_torch import evaluate as tevaluate
from velocity_asr_tpu_torch import synth as tsynth
from velocity_asr_tpu_torch import training as ttraining

CKPT = "checkpoints/synth_run/final_pretrained"
N_UTTS = 6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU ops: with several test
    workers on the same cores, torch's thread pool otherwise spends most
    of its time waiting at barriers (a 1-second evaluation took 2 minutes
    under 3 workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    return tsynth.write_corpus(str(tmp_path_factory.mktemp("synth")), N_UTTS, split="test",
                               seed=1234)


def _datasets(manifest):
    kw = dict(max_duration=None, min_duration=0.0)
    return tdata.ASRDataset(manifest, **kw), jdata.ASRDataset(manifest, **kw)


def _assert_same_batch(ours, ref):
    assert set(ours) == set(ref)
    for key in ours:
        if key == "texts":
            assert ours[key] == ref[key]
        else:
            assert ours[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


def test_dataset_items_match_jax(manifest):
    ours, ref = _datasets(manifest)
    assert len(ours) == len(ref) == N_UTTS
    assert ours.samples == ref.samples and ours.vocab == ref.vocab
    for i in range(N_UTTS):
        a, b = ours[i], ref[i]
        assert set(a) == set(b)
        np.testing.assert_array_equal(a["mel_spectrogram"], b["mel_spectrogram"])
        np.testing.assert_array_equal(a["targets"], b["targets"])
        assert a["input_lengths"] == b["input_lengths"] and a["text"] == b["text"]


def test_dataset_filters_like_jax(manifest, tmp_path):
    rows = [json.loads(line) for line in open(manifest)]
    rows[0]["duration"] = 0.1  # below min_duration
    rows[1]["audio_path"] = str(tmp_path / "missing.wav")
    del rows[2]["duration"]  # unknown duration: kept
    path = tmp_path / "m.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows) + "\n")
    ours, ref = tdata.ASRDataset(str(path)), jdata.ASRDataset(str(path))
    assert ours.samples == ref.samples and len(ours) == N_UTTS - 2


@pytest.mark.parametrize("frame_bucket,target_bucket", [(200, 1), (100, 32), (1, 1)])
def test_collator_matches_jax(manifest, frame_bucket, target_bucket):
    ours, ref = _datasets(manifest)
    items = [ours[i] for i in range(4)]
    kw = dict(frame_bucket=frame_bucket, target_bucket=target_bucket)
    _assert_same_batch(tdata.ASRCollator(**kw)(items), jdata.ASRCollator(**kw)(items))


def test_calibration_batches_match_jax(manifest):
    ours, ref = _datasets(manifest)
    for max_items in (None, 5):
        a = list(tdata.calibration_batches(ours, tdata.ASRCollator(frame_bucket=200), 4, 2,
                                           max_items=max_items))
        b = list(jdata.calibration_batches(ref, jdata.ASRCollator(frame_bucket=200), 4, 2,
                                           max_items=max_items))
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_wer_cer_match_jax():
    preds = ["the cat sat", "", "Hello  world", "abc", "a b c d"]
    refs = ["the cat sat on", "silence here", "hello world", "", "a x c"]
    for ours, ref in ((ttraining.compute_wer, jtraining.compute_wer),
                      (ttraining.compute_cer, jtraining.compute_cer)):
        assert ours(preds, refs) == ref(preds, refs)
        assert ours([], []) == ref([], []) == 0.0
        with pytest.raises(AssertionError):
            ours(preds[:2], refs)
    assert ttraining._edit_distance(list("kitten"), list("sitting")) == 3


def _jax_greedy_batch_predictions(manifest, batch_size):
    """The greedy batch branch of scripts/evaluate.py."""
    with open(f"{CKPT}/config.json") as f:
        cfg = json.load(f)["config"]
    jm = jmodel.create_model(jconfig.VelocityASRConfig.from_dict(dict(cfg, scan_mode="sequential")))
    with open(f"{CKPT}/params.msgpack", "rb") as f:  # no op-by-op init for a template
        jp = flax.serialization.msgpack_restore(f.read())
    ds = jdata.ASRDataset(manifest, max_duration=None, min_duration=0.0)
    collator = jdata.ASRCollator(frame_bucket=200, target_bucket=1)
    with open(f"{CKPT}/vocabulary.json") as f:
        decoder = jdecode.CTCDecoder(json.load(f))

    @jax.jit
    def greedy_tokens(p, mel, input_lengths):
        logits = jmodel.forward(jm, p, mel)
        out_lens = (input_lengths + 1) // 2
        pad = (jnp.arange(logits.shape[1])[None, :] >= out_lens[:, None])[:, :, None]
        logits = jnp.where(pad, -1e9, logits)
        logits = logits.at[:, :, 0].set(jnp.where(pad[..., 0], 0.0, logits[:, :, 0]))
        return jdecode.ctc_greedy_decode_jax(logits)

    preds = []
    for start in range(0, len(ds), batch_size):
        batch = collator([ds[i] for i in range(start, min(start + batch_size, len(ds)))])
        toks, lens = greedy_tokens(jp, jnp.asarray(batch["mel_spectrogram"]),
                                   jnp.asarray(batch["input_lengths"]))
        toks, lens = np.asarray(toks), np.asarray(lens)
        preds += [decoder._tokens_to_text(toks[b, : lens[b]].tolist())
                  for b in range(toks.shape[0])]
    return preds


def test_evaluate_matches_jax_greedy_batch_path(manifest, tmp_path):
    out_path = tmp_path / "eval.json"
    result = tevaluate.main(["--checkpoint", CKPT, "--test-set", manifest, "--batch-size", "4",
                             "--device", "cpu", "--output", str(out_path)])
    with open(out_path) as f:
        written = json.load(f)
    with open(f"{CKPT}/../eval_int8_dynamic.json") as f:
        assert set(written) == set(json.load(f))  # the JAX package's eval file keys
    assert written["utterances"] == N_UTTS
    preds = [r["prediction"] for r in written["results"]]
    refs = [r["reference"] for r in written["results"]]
    assert preds == _jax_greedy_batch_predictions(manifest, 4)
    assert written["wer"] == result["wer"] == jtraining.compute_wer(preds, refs)
    assert written["cer"] == jtraining.compute_cer(preds, refs)


def test_evaluate_int8_static_calibrates_on_at_most_max_utts(manifest, monkeypatch):
    seen = []
    real = tevaluate.calibrate_int8_model

    def spy(model, batches, num_batches=100):
        batches = list(batches)
        seen.extend(b.shape[0] for b in batches)
        return real(model, batches, num_batches)

    monkeypatch.setattr(tevaluate, "calibrate_int8_model", spy)
    result = tevaluate.main(["--checkpoint", CKPT, "--test-set", manifest, "--batch-size", "2",
                             "--max-utts", "3", "--calib-batches", "8", "--int8-static",
                             "--device", "cpu"])
    assert seen == [2, 1]  # min(n=3, 8 * 2) utterances, in batches of 2
    assert 0.0 <= result["wer"] <= 1.0


def test_evaluate_raises_for_cuda_without_a_card(manifest):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point runs on it")
    with pytest.raises(RuntimeError, match="cuda"):
        tevaluate.main(["--checkpoint", CKPT, "--test-set", manifest])
