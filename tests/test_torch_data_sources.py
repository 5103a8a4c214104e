"""The port's data sources against the JAX package's: LibriSpeech read from
its on-disk layout (a FLAC tree this file writes from the synthetic
corpus, in LibriSpeech's directories and upper-case transcripts), split
concatenation, the loaders with the validation sets in the train
vocabulary, manifests with an eval manifest, the dummy random dataset,
language labels, and ``train.build_data``'s choice of source.

Tolerances: tokens, texts, lengths, audio and vocabularies identical;
the host mel within 1e-5 (the same numpy arithmetic on both sides);
dummy items and collated batches bit-equal.
"""

import json
import logging

import numpy as np
import pytest
import torch

from scripts import train as jtrain
from tests.flac_encoder import encode_flac
from velocity_asr_tpu import data as jdata
from velocity_asr_tpu.models import config as jconfig
from velocity_asr_tpu_torch import data as tdata
from velocity_asr_tpu_torch import synth as tsynth
from velocity_asr_tpu_torch import train as ttrain

MEL_ATOL = 1e-5
TRAIN, DEV = "train-clean-100", "dev-clean"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: under xdist the workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A LibriSpeech root: 6 train utterances (2 speakers x 2 chapters),
    3 dev utterances, and 2 of another train split; manifests over them."""
    root = str(tmp_path_factory.mktemp("librispeech"))
    manifests = {
        TRAIN: tsynth.write_librispeech_tree(root, TRAIN, 6, encode_flac),
        DEV: tsynth.write_librispeech_tree(root, DEV, 3, encode_flac, speakers=1, chapters=1,
                                           synth_split="dev"),
        "train-clean-360": tsynth.write_librispeech_tree(root, "train-clean-360", 2,
                                                         encode_flac, speakers=1,
                                                         synth_split="train_dev"),
    }
    return root, manifests


def _assert_same_items(ours, ref, n):
    assert len(ours) == len(ref) == n
    for i in range(n):
        a, b = ours[i], ref[i]
        assert set(a) == set(b)
        assert a["text"] == b["text"]
        np.testing.assert_array_equal(a["targets"], b["targets"])
        assert a["target_lengths"] == b["target_lengths"]
        assert a["input_lengths"] == b["input_lengths"]
        if "audio" in a:
            np.testing.assert_array_equal(a["audio"], b["audio"])
        else:
            np.testing.assert_allclose(a["mel_spectrogram"], b["mel_spectrogram"], rtol=0,
                                       atol=MEL_ATOL)


@pytest.mark.parametrize("device_mel", [False, True])
def test_librispeech_items_match_jax(tree, device_mel):
    root, _ = tree
    ours = tdata.LibriSpeechDataset(root, TRAIN, device_mel=device_mel)
    ref = jdata.LibriSpeechDataset(root, TRAIN, device_mel=device_mel)
    assert ours.entries == ref.entries and ours.vocab == ref.vocab
    assert len(ours.vocab) == 31 and ours.entries[0][1].isupper()
    _assert_same_items(ours, ref, 6)
    assert ours[0]["text"] == ours[0]["text"].lower()


def test_librispeech_truncates_at_max_duration(tree):
    root, _ = tree
    ours = tdata.LibriSpeechDataset(root, TRAIN, max_duration=0.5)
    ref = jdata.LibriSpeechDataset(root, TRAIN, max_duration=0.5)
    _assert_same_items(ours, ref, 6)
    assert ours[0]["input_lengths"] == 1 + 8000 // 160


def test_librispeech_missing_split_raises(tree):
    with pytest.raises(FileNotFoundError, match="LibriSpeech split not found"):
        tdata.LibriSpeechDataset(tree[0], "test-other")


def test_concatenated_splits_and_loaders_match_jax(tree):
    """Two train splits concatenate in order; the validation set shares
    the train vocabulary; the loaders' datasets and the validation
    batches equal the JAX package's."""
    root, _ = tree
    kw = dict(root=root, train_splits=[TRAIN, "train-clean-360"], val_splits=[DEV],
              batch_size=2)
    ours = tdata.create_librispeech_dataloaders(num_workers=0, **kw)
    ref = jdata.create_librispeech_dataloaders(num_workers=1, **kw)
    assert ours[2] == ref[2]
    assert isinstance(ours[0].dataset, torch.utils.data.ConcatDataset)
    _assert_same_items(ours[0].dataset, ref[0].dataset, 8)
    assert ours[1].dataset.vocab is ours[2]
    _assert_same_items(ours[1].dataset, ref[1].dataset, 3)
    assert ours[0].drop_last and ours[0].shuffle and not ours[1].shuffle
    for a, b in zip(ours[1], ref[1]):
        assert set(a) == set(b) and a["texts"] == b["texts"]
        for key in ("mel_spectrogram", "targets", "input_lengths", "target_lengths"):
            np.testing.assert_allclose(a[key], b[key], rtol=0, atol=MEL_ATOL)


def _model_cfg():
    return jconfig.VelocityASRConfig(vocab_size=30)


def _data_sections(root, manifests, tmp_path):
    eval_manifest = manifests[DEV]
    return {
        "manifest": {"manifest": manifests[TRAIN], "eval_manifest": eval_manifest,
                     "min_duration": 0.0},
        "librispeech": {"librispeech_root": root, "train_splits": [TRAIN],
                        "val_splits": [DEV]},
        "dummy": {"manifest": str(tmp_path / "missing.jsonl"),
                  "librispeech_root": str(tmp_path / "nowhere")},
    }


@pytest.mark.parametrize("source", ["manifest", "librispeech", "dummy"])
def test_build_data_picks_the_jax_source(tree, tmp_path, source):
    """The same ``data:`` section gives the same kind of data: the same
    train and eval datasets (items equal), the same vocabulary, the
    eval manifest encoded in the train vocabulary; the dummy fallback has
    no eval set and no vocabulary."""
    root, manifests = tree
    section = _data_sections(root, manifests, tmp_path)[source]
    ours = ttrain.build_data(dict(section), 2, 0, 30)
    ref = jtrain.build_data(dict(section), _model_cfg(), 2, logging.getLogger("test"))
    assert type(ours[0].dataset).__name__ == type(ref[0].dataset).__name__
    assert ours[2] == ref[2]
    if source == "dummy":
        assert ours[1] is None and ref[1] is None and ours[2] is None
        for i in range(3):
            a, b = ours[0].dataset[i], ref[0].dataset[i]
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])
        return
    _assert_same_items(ours[0].dataset, ref[0].dataset, len(ref[0].dataset))
    _assert_same_items(ours[1].dataset, ref[1].dataset, len(ref[1].dataset))
    assert ours[1].dataset.vocab == ours[2]


def test_eval_manifest_encodes_in_the_train_vocabulary(tree, tmp_path):
    """An eval manifest with a character the train set lacks encodes it
    as <unk> of the train vocabulary, as the JAX package's does."""
    root, manifests = tree
    rows = [json.loads(line) for line in open(manifests[DEV])]
    rows[0]["text"] = "q'x " + rows[0]["text"]
    path = tmp_path / "eval.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    section = {"manifest": manifests[TRAIN], "eval_manifest": str(path), "min_duration": 0.0}
    ours = ttrain.build_data(dict(section), 2, 0)
    ref = jtrain.build_data(dict(section), _model_cfg(), 2, logging.getLogger("test"))
    assert "'" not in ours[2]
    _assert_same_items(ours[1].dataset, ref[1].dataset, 3)
    assert ours[1].dataset[0]["targets"][1] == ours[2]["<unk>"]


def test_dummy_dataset_bit_equal_to_jax():
    ours, ref = ttrain.DummyASRDataset(vocab_size=30, seed=4), jtrain.DummyASRDataset(
        vocab_size=30, seed=4)
    assert len(ours) == len(ref) == 1000
    for i in (0, 1, 517, 999):
        a, b = ours[i], ref[i]
        assert a.keys() == b.keys() and a["text"] == b["text"] == ""
        for key in ("mel_spectrogram", "targets", "input_lengths", "target_lengths"):
            assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("device_mel", [False, True])
def test_language_labels_collate_as_jax(tree, tmp_path, device_mel):
    """A manifest's language labels ride along into the item and the
    batch as the JAX package's; a batch mixing labelled and unlabelled
    items raises as the JAX collator does."""
    _, manifests = tree
    rows = [json.loads(line) for line in open(manifests[TRAIN])]
    for i, r in enumerate(rows):
        r["language"] = i % 3
    path = tmp_path / "lang.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    kw = dict(min_duration=0.0, device_mel=device_mel)
    ours, ref = tdata.ASRDataset(str(path), **kw), jdata.ASRDataset(str(path), **kw)
    items, ref_items = [ours[i] for i in range(4)], [ref[i] for i in range(4)]
    assert [int(it["language"]) for it in items] == [0, 1, 2, 0]
    a, b = tdata.ASRCollator()(items), jdata.ASRCollator()(ref_items)
    assert a["language"].dtype == b["language"].dtype == np.int32
    np.testing.assert_array_equal(a["language"], b["language"])
    del items[1]["language"], ref_items[1]["language"]
    with pytest.raises(ValueError, match="mixes labeled and unlabeled") as err:
        tdata.ASRCollator()(items)
    with pytest.raises(ValueError) as ref_err:
        jdata.ASRCollator()(ref_items)
    assert str(err.value) == str(ref_err.value)


def test_manifest_tokenizer_argument():
    """ASRDataset encodes with a tokenizer when given one, and builds no
    vocabulary then, as the JAX package's does."""

    class Upper:
        def encode(self, text):
            return [ord(c) for c in text.upper()]

    rows = [{"audio_path": "/nonexistent.wav", "text": "ab"}]
    import os
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".jsonl", delete=False) as f:
        f.write(json.dumps(rows[0]) + "\n")
    try:
        ours = tdata.ASRDataset(f.name, tokenizer=Upper())
        ref = jdata.ASRDataset(f.name, tokenizer=Upper())
        assert ours.vocab is None and ref.vocab is None
        assert ours.text_to_tokens("ab") == ref.text_to_tokens("ab") == [65, 66]
    finally:
        os.unlink(f.name)
