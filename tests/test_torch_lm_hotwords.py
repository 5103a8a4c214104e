"""Parity of the port's n-gram LM, hot-word booster and LM build with the
JAX package's (the same code, copied framework-free).

- ``CharNGramLM.load`` of the committed ``checkpoints/synth_run/lm.json.gz``:
  ``score``, ``total_score`` and ``log_prob`` within 1e-9 of the JAX
  package's on 50 seeded token sequences;
- ``CharNGramLM.train`` then ``save`` on 200 synthetic sentences: the same
  JSON as the JAX package's, the same perplexity;
- ``SyntheticSpeechDataset.text_for``: the JAX package's sentences;
- ``HotwordBooster``: the same words and prefixes, ``score`` of every
  prefix and ``total_score`` equal; ``load_hotwords_arg`` and
  ``CombinedScorer`` likewise;
- ``python -m velocity_asr_tpu_torch.train_lm``: the JAX package's LM for
  the same texts, and its parser errors.
"""

import gzip
import json

import numpy as np
import pytest

from velocity_asr_tpu import hotwords as jhot
from velocity_asr_tpu import lm as jlm
from velocity_asr_tpu import synth as jsynth
from velocity_asr_tpu_torch import hotwords as thot
from velocity_asr_tpu_torch import lm as tlm
from velocity_asr_tpu_torch import synth as tsynth
from velocity_asr_tpu_torch import train_lm

LM_PATH = "checkpoints/synth_run/lm.json.gz"
SCORE_TOL = 1e-9


@pytest.fixture(scope="module")
def committed_lms():
    return tlm.CharNGramLM.load(LM_PATH), jlm.CharNGramLM.load(LM_PATH)


def _sequences(n, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(0, 30))).tolist() for _ in range(n)]


def _payload(path):
    with gzip.open(path, "rt") as f:
        return json.load(f)


def test_committed_lm_scores_match_jax(committed_lms):
    ours, ref = committed_lms
    assert (ours.order, ours.vocab_size, ours.token_to_idx) == (
        ref.order, ref.vocab_size, ref.token_to_idx)
    seqs = _sequences(50, ours.vocab_size)
    assert any(len(s) > ours.order for s in seqs)
    for seq in seqs:
        assert abs(ours.score(seq) - ref.score(seq)) <= SCORE_TOL
        assert abs(ours.total_score(seq) - ref.total_score(seq)) <= SCORE_TOL
        for i in range(len(seq)):
            assert abs(ours.log_prob(seq[:i], seq[i]) - ref.log_prob(seq[:i], seq[i])) <= SCORE_TOL
    # summing score over a sequence's prefixes is its total_score
    seq = seqs[0] or [5, 6]
    assert sum(ours.score(seq[:i + 1]) for i in range(len(seq))) == pytest.approx(
        ours.total_score(seq), abs=1e-9)


@pytest.mark.parametrize("split", ["train", "test"])
def test_synth_text_for_matches_jax(split):
    ours = tsynth.SyntheticSpeechDataset(50, split=split, seed=1234)
    ref = jsynth.SyntheticSpeechDataset(50, split=split, seed=1234)
    assert [ours.text_for(i) for i in range(50)] == [ref.text_for(i) for i in range(50)]
    assert ours.vocab == ref.vocab
    # the item's transcript is the sentence text_for gives
    assert ours[3]["text"] == ours.text_for(3)


@pytest.mark.parametrize("order", [1, 3, 5])
def test_lm_train_and_save_match_jax(tmp_path, order):
    ds = tsynth.SyntheticSpeechDataset(200, split="train", seed=1234)
    texts = [ds.text_for(i) for i in range(200)]
    ours = tlm.CharNGramLM.train(texts, ds.vocab, order=order)
    ref = jlm.CharNGramLM.train(texts, ds.vocab, order=order)
    ours.save(str(tmp_path / "ours.json.gz"))
    ref.save(str(tmp_path / "ref.json.gz"))
    assert _payload(tmp_path / "ours.json.gz") == _payload(tmp_path / "ref.json.gz")
    assert ours.perplexity(texts[:20]) == ref.perplexity(texts[:20])
    back = tlm.CharNGramLM.load(str(tmp_path / "ours.json.gz"))
    for seq in _sequences(10, ours.vocab_size, seed=order):
        assert back.total_score(seq) == ref.total_score(seq)


def test_lm_refusals(tmp_path):
    vocab = {"<blank>": 0, "<unk>": 1, "a": 2}
    for cls in (tlm.CharNGramLM, jlm.CharNGramLM):
        with pytest.raises(ValueError, match="order"):
            cls.train(["a"], vocab, order=0)
        with pytest.raises(ValueError, match="no non-empty"):
            cls.train(["", ""], vocab)
    path = tmp_path / "other.json"
    path.write_text(json.dumps({"format": "something else"}))
    with pytest.raises(ValueError, match="not a char n-gram"):
        tlm.CharNGramLM.load(str(path))


HOTWORD_LISTS = [
    ["cat", "category", "dog"],
    ["velocity asr", "ab", "b", "Zebra", "x-ray"],  # a phrase, case, an OOV word
]


def _vocab():
    specials = ["<blank>", "<unk>", "<pad>", " "]
    return {tok: i for i, tok in enumerate(specials + list("abcdefghijklmnopqrstuvwxyz"))}


@pytest.mark.parametrize("words", HOTWORD_LISTS, ids=["trie", "phrase-oov"])
def test_hotword_booster_matches_jax(words):
    vocab = _vocab()
    kw = dict(bonus_per_char=1.5, completion_bonus=0.75)
    ours, ref = thot.HotwordBooster(words, vocab, **kw), jhot.HotwordBooster(words, vocab, **kw)
    assert ours.words == ref.words and ours.prefixes == ref.prefixes
    texts = ["cat category dog", "catdog ca", "velocity asr ab b zebra", "a b c  d", ""]
    seqs = [[vocab[c] for c in t] for t in texts] + _sequences(20, len(vocab), seed=9)
    for seq in seqs:
        assert ours.total_score(seq) == ref.total_score(seq)
        for i in range(len(seq) + 1):
            assert ours.score(seq[:i]) == ref.score(seq[:i])
        assert sum(ours.score(seq[:i + 1]) for i in range(len(seq))) == pytest.approx(
            ours.total_score(seq))


def test_hotword_refusals_and_loading(tmp_path):
    vocab = _vocab()
    with pytest.raises(ValueError, match="boundary"):
        thot.HotwordBooster(["cat"], {"c": 0, "a": 1, "t": 2})
    with pytest.raises(ValueError, match="no usable hotwords"):
        thot.HotwordBooster(["x-ray", "  "], vocab)
    assert thot.load_hotwords_arg(None, vocab) is None
    path = tmp_path / "words.txt"
    path.write_text("# domain words\ncat  # a pet\n\ndog\n")
    for spec, want in ((str(path), {"cat", "dog"}), ("cat, dog,,", {"cat", "dog"})):
        ours = thot.load_hotwords_arg(spec, vocab)
        ref = jhot.load_hotwords_arg(spec, vocab)
        assert ours.words == ref.words == {tuple(vocab[c] for c in w) for w in want}


def test_combined_scorer_matches_jax(committed_lms):
    vocab = _vocab()
    lm_t, lm_j = committed_lms
    ours = tlm.CombinedScorer([(thot.HotwordBooster(["cat"], vocab), 2.0), (lm_t, 0.5)])
    ref = jlm.CombinedScorer([(jhot.HotwordBooster(["cat"], vocab), 2.0), (lm_j, 0.5)])
    for seq in _sequences(20, len(vocab), seed=4) + [[vocab[c] for c in "the cat sat"]]:
        assert abs(ours.score(seq) - ref.score(seq)) <= SCORE_TOL
        assert abs(ours.total_score(seq) - ref.total_score(seq)) <= SCORE_TOL
    with pytest.raises(ValueError, match="at least one"):
        tlm.CombinedScorer([])


def test_train_lm_cli_matches_jax(tmp_path):
    out = str(tmp_path / "lm.json.gz")
    ours = train_lm.main(["--synthetic", "300", "--order", "3", "--out", out])
    ds = jsynth.SyntheticSpeechDataset(300, split="train", seed=1234)
    ref = jlm.CharNGramLM.train([ds.text_for(i) for i in range(300)], dict(ds.vocab), order=3)
    ref_path = str(tmp_path / "ref.json.gz")
    ref.save(ref_path)
    assert _payload(out) == _payload(ref_path)
    assert ours.order == 3

    # a manifest with the checkpoint's vocabulary
    manifest = tmp_path / "m.jsonl"
    manifest.write_text('{"text": "Hello World"}\n\n{"text": "cat"}\n')
    out2 = str(tmp_path / "m.json.gz")
    lm = train_lm.main(["--manifest", str(manifest), "--checkpoint",
                        "checkpoints/synth_run/final_pretrained", "--order", "2", "--out", out2])
    with open("checkpoints/synth_run/final_pretrained/vocabulary.json") as f:
        vocab = {t: i for i, t in enumerate(json.load(f))}
    want = jlm.CharNGramLM.train(["hello world", "cat"], vocab, order=2)
    want.save(ref_path)
    assert _payload(out2) == _payload(ref_path) and lm.vocab_size == len(vocab)


@pytest.mark.parametrize("argv, msg", [
    (["--text", "t.txt"], "need --checkpoint"),
    (["--synthetic", "3", "--manifest", "m.jsonl"], "not allowed with argument"),
    ([], "one of the arguments"),
], ids=["no-vocab", "two-sources", "no-source"])
def test_train_lm_cli_errors(argv, msg, capsys):
    with pytest.raises(SystemExit):
        train_lm.main(argv)
    assert msg in capsys.readouterr().err
