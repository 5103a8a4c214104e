"""Parity of the port's offline beam search with the JAX package's.

The same numpy-seeded logits go through both packages:

- ``beam.ctc_beam_search_torch`` against ``ctc_beam_search_jax`` at
  k in {1, 4, 8}, vocab 12 and 30, T 40-80, batch 3: identical tokens and
  lengths in every slot, scores within 1e-5 + 1e-7 |score| (fp32 sums of
  T log posteriors whose last bits differ between the two log-softmax
  implementations); also with logits rounded to multiples of 0.5 (exact
  score ties, broken as the JAX package breaks them) and with blank
  forced beyond each row's length; k = 1 equals greedy decoding;
- the host prefix beam ``decode.ctc_beam_search`` with a small trained
  ``CharNGramLM`` at lm_weight 0.5: identical hypotheses, scores within
  1e-9 (both numpy);
- ``CTCDecoder.decode_beam_search`` with an LM, hot words and a
  ``CombinedScorer``, on both backends ("device" against the JAX
  package's "jax"): the same texts, and the n-best's scores as above;
- ``align_tokens_to_frames``: identical stamps, posteriors within 1e-6;
- the ``evaluate`` and ``transcribe`` CLIs at ``--device cpu`` with
  ``--beam-width 4 --lm`` (and the hot-word oracle, and streaming) on the
  committed checkpoint: the JAX package's beam-8 transcripts of the same
  utterances (``checkpoints/synth_run/eval_*.json``), and the JAX
  scripts' parser errors.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velocity_asr_tpu import beam as jbeam
from velocity_asr_tpu import decode as jdecode
from velocity_asr_tpu import hotwords as jhot
from velocity_asr_tpu import lm as jlm
from velocity_asr_tpu_torch import beam as tbeam
from velocity_asr_tpu_torch import decode as tdecode
from velocity_asr_tpu_torch import evaluate as tevaluate
from velocity_asr_tpu_torch import hotwords as thot
from velocity_asr_tpu_torch import lm as tlm
from velocity_asr_tpu_torch import synth as tsynth
from velocity_asr_tpu_torch import transcribe as ttranscribe
from velocity_asr_tpu_torch.ops import cuda_lib

CKPT = "checkpoints/synth_run/final_pretrained"
LM_PATH = "checkpoints/synth_run/lm.json.gz"
RUN = "checkpoints/synth_run"
SCORE_TOL = dict(rtol=1e-7, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: under xdist the workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _logits(seed, batch, t_len, vocab, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((batch, t_len, vocab))
            * scale).astype(np.float32)


def _both(logits, k):
    ref = [np.asarray(a) for a in jbeam.ctc_beam_search_jax(jnp.asarray(logits), beam_width=k)]
    ours = [a.numpy() for a in tbeam.ctc_beam_search_torch(torch.from_numpy(logits), k)]
    return ours, ref


def _assert_beams_equal(ours, ref):
    (tt, tl, ts), (jt, jl, js) = ours, ref
    assert tt.dtype == np.int32 and tl.dtype == np.int32 and ts.dtype == np.float32
    assert tt.shape == jt.shape and ts.shape == js.shape
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tl, jl)
    filled = js > -1e29
    np.testing.assert_array_equal(ts > -1e29, filled)
    np.testing.assert_allclose(ts[filled], js[filled], **SCORE_TOL)


@pytest.mark.parametrize("vocab", [12, 30])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_beam_search_matches_jax(k, vocab):
    t_len = int(np.random.default_rng(k * vocab).integers(40, 81))
    logits = _logits(k + vocab, 3, t_len, vocab)
    ours, ref = _both(logits, k)
    _assert_beams_equal(ours, ref)
    assert ours[1][:, 0].min() > 0  # the best beams emitted tokens


@pytest.mark.parametrize("k", [4, 8])
def test_beam_search_matches_jax_on_exact_ties(k):
    """Logits on a grid of 0.5: equal logits give equal log posteriors,
    so candidate scores tie exactly and the tie order decides which
    hypothesis survives (stable lexsort, top_k lower index first)."""
    logits = np.round(_logits(20 + k, 3, 60, 12, scale=1.0) * 2) / 2
    ours, ref = _both(logits, k)
    _assert_beams_equal(ours, ref)
    flat = ours[2][ours[2] > -1e29]
    assert len(np.unique(flat)) < flat.size  # ties survived to the final beams


def test_beam_search_matches_jax_with_blank_forced():
    """Per-row lengths with blank forced beyond them, as the batched
    evaluation feeds the beam: the padded frames change no beam."""
    logits = _logits(31, 3, 64, 30)
    lens = torch.tensor([64, 41, 7])
    masked = tdecode.force_blank_beyond(torch.from_numpy(logits), lens).numpy()
    ours, ref = _both(masked, 8)
    _assert_beams_equal(ours, ref)
    for b, n in enumerate(lens.tolist()):
        alone = tbeam.ctc_beam_search_torch(torch.from_numpy(logits[b:b + 1, :n]), 8)
        np.testing.assert_array_equal(ours[1][b], alone[1][0].numpy())
        np.testing.assert_array_equal(ours[0][b, :, :n], alone[0][0].numpy())


def test_beam_width_1_is_greedy():
    logits = torch.from_numpy(_logits(40, 3, 70, 12))
    toks, lens, _ = tbeam.ctc_beam_search_torch(logits, 1)
    assert tbeam.beams_to_token_lists(toks, lens) == [
        [g] for g in tdecode.ctc_greedy_decode(logits)]


def test_beam_search_counts_no_launch_on_cpu():
    before = dict(cuda_lib.launch_counts)
    tbeam.ctc_beam_search_torch(torch.from_numpy(_logits(1, 2, 10, 12)), 4)
    assert dict(cuda_lib.launch_counts) == before


@pytest.fixture(scope="module")
def small_lms():
    """An order-3 LM trained on 200 synthetic sentences, in both packages
    (the synthetic vocabulary: blank, unk, pad, space, a-z)."""
    ds = tsynth.SyntheticSpeechDataset(200, split="train", seed=1234)
    texts = [ds.text_for(i) for i in range(200)]
    return (tlm.CharNGramLM.train(texts, ds.vocab, order=3),
            jlm.CharNGramLM.train(texts, ds.vocab, order=3), ds.vocab)


def _results(rs):
    return [[(r.text, r.tokens) for r in item] for item in rs]


def _scores(rs):
    return np.array([r.score for item in rs for r in item])


def test_host_beam_with_lm_matches_jax(small_lms):
    lm_t, lm_j, _ = small_lms
    logits = _logits(50, 2, 40, 30, scale=2.0)
    ours = tdecode.ctc_beam_search(torch.from_numpy(logits), beam_width=4, lm_weight=0.5,
                                   lm_scorer=lm_t)
    ref = jdecode.ctc_beam_search(logits, beam_width=4, lm_weight=0.5, lm_scorer=lm_j)
    assert _results(ours) == _results(ref)
    np.testing.assert_allclose(_scores(ours), _scores(ref), rtol=0, atol=1e-9)
    # the LM moved the search: not the acoustic-only beams
    plain = tdecode.ctc_beam_search(logits, beam_width=4)
    assert _results(plain) != _results(ours)


def test_host_and_device_backends_agree_without_lm():
    logits = torch.from_numpy(_logits(51, 3, 50, 12))
    dec = tdecode.CTCDecoder(tdecode.create_default_vocabulary(12))
    host = dec.decode_beam_search(logits, beam_width=6, backend="host", return_all_beams=True)
    dev = dec.decode_beam_search(logits, beam_width=6, backend="device", return_all_beams=True)
    assert [[r.tokens for r in item][:1] for item in host] == [
        [r.tokens for r in item][:1] for item in dev]
    assert dec.decode_beam_search(logits, beam_width=6, backend="host") == \
        dec.decode_beam_search(logits, beam_width=6)


def _scorers(kind, lms, vocab):
    lm_t, lm_j, _ = lms
    words = ["cat", "hello", "ab"]
    if kind == "none":
        return (None, 0.0), (None, 0.0)
    if kind == "lm":
        return (lm_t, 0.5), (lm_j, 0.5)
    if kind == "hotwords":
        return (thot.HotwordBooster(words, vocab), 2.0), (jhot.HotwordBooster(words, vocab), 2.0)
    return ((tlm.CombinedScorer([(thot.HotwordBooster(words, vocab), 2.0), (lm_t, 0.5)]), 1.0),
            (jlm.CombinedScorer([(jhot.HotwordBooster(words, vocab), 2.0), (lm_j, 0.5)]), 1.0))


@pytest.mark.parametrize("scorer", ["none", "lm", "hotwords", "combined"])
@pytest.mark.parametrize("backend", ["device", "host"])
def test_decode_beam_search_matches_jax(small_lms, backend, scorer):
    vocab_map = small_lms[2]
    vocab = [t for t, _ in sorted(vocab_map.items(), key=lambda kv: kv[1])]
    (s_t, w_t), (s_j, w_j) = _scorers(scorer, small_lms, vocab_map)
    logits = _logits(60, 2, 45, len(vocab), scale=2.0)
    ours = tdecode.CTCDecoder(vocab).decode_beam_search(
        torch.from_numpy(logits), beam_width=4, backend=backend, lm_scorer=s_t,
        lm_weight=w_t, return_all_beams=True)
    ref = jdecode.CTCDecoder(vocab).decode_beam_search(
        jnp.asarray(logits), beam_width=4, backend="jax" if backend == "device" else "host",
        lm_scorer=s_j, lm_weight=w_j, return_all_beams=True)
    assert _results(ours) == _results(ref)
    np.testing.assert_allclose(_scores(ours), _scores(ref), **SCORE_TOL)
    texts = tdecode.CTCDecoder(vocab).decode_beam_search(
        torch.from_numpy(logits), beam_width=4, backend=backend, lm_scorer=s_t, lm_weight=w_t)
    assert texts == [item[0].text for item in ref]


def test_decode_beam_search_refuses_an_unknown_backend():
    dec = tdecode.CTCDecoder(tdecode.create_default_vocabulary(12))
    with pytest.raises(ValueError, match="unknown beam backend 'jax'"):
        dec.decode_beam_search(torch.zeros(1, 4, 12), backend="jax")


@pytest.mark.parametrize("tokens", [[5, 7, 7, 3], [4], [2, 2, 2], list(range(1, 12))],
                         ids=["repeat", "one", "triple", "long"])
def test_align_tokens_to_frames_matches_jax(tokens):
    log_probs = jdecode._log_softmax_np(_logits(70 + len(tokens), 1, 30, 12)[0])
    ours = tdecode.align_tokens_to_frames(log_probs, tokens)
    ref = jdecode.align_tokens_to_frames(log_probs, tokens)
    assert ours[0] == ref[0] and len(ours[0]) == len(tokens)
    np.testing.assert_allclose(ours[1], ref[1], rtol=0, atol=1e-6)


def test_align_tokens_to_frames_edges():
    log_probs = jdecode._log_softmax_np(_logits(80, 1, 3, 12)[0])
    assert tdecode.align_tokens_to_frames(log_probs, []) == ([], [])
    with pytest.raises(ValueError, match=r"cannot align 3 tokens to 3 frames \(needs >= 5\)"):
        tdecode.align_tokens_to_frames(log_probs, [5, 5, 5])


# ------------------------------------------------------------ entry points


def _jax_predictions(name, n):
    with open(f"{RUN}/{name}") as f:
        return [r["prediction"] for r in json.load(f)["results"][:n]]


@pytest.fixture(scope="module")
def two_utterances(tmp_path_factory):
    return tsynth.write_corpus(str(tmp_path_factory.mktemp("corpus")), 2, split="test",
                               seed=1234)


@pytest.mark.parametrize("extra, jax_file", [
    (["--lm", LM_PATH], "eval_beam8_lm.json"),
    (["--hotwords-oracle"], "eval_hotwords_oracle.json"),
    (["--streaming", "--lm", LM_PATH], "eval_streaming_beam8_lm.json"),
], ids=["lm", "oracle", "streaming-lm"])
def test_evaluate_beam_cli(two_utterances, tmp_path, extra, jax_file):
    out = str(tmp_path / "eval.json")
    metrics = tevaluate.main(["--checkpoint", CKPT, "--test-set", two_utterances,
                              "--device", "cpu", "--beam-width", "4", "--output", out] + extra)
    with open(out) as f:
        result = json.load(f)
    with open(f"{RUN}/{jax_file}") as f:
        jax_keys = set(json.load(f))
    assert set(result) == jax_keys
    assert [r["prediction"] for r in result["results"]] == _jax_predictions(jax_file, 2)
    assert metrics["wer"] == result["wer"]
    if "--streaming" in extra:
        assert result["beam_width"] == 4 and result["lm"] is True
        assert result["lookahead"] == 0


def test_transcribe_beam_cli(two_utterances, capsys):
    wav = two_utterances.replace("test_manifest.jsonl", "test_00000.wav")
    base = [wav, "--checkpoint", CKPT, "--device", "cpu", "--beam-width", "4", "--lm", LM_PATH,
            "--json"]
    assert ttranscribe.main(base) == 0
    assert json.loads(capsys.readouterr().out)["text"] == _jax_predictions(
        "eval_beam8_lm.json", 1)[0]
    assert ttranscribe.main(base + ["--streaming", "--hotwords", "the,and"]) == 0
    result = json.loads(capsys.readouterr().out)
    assert result["streaming"] is True and result["text"]


@pytest.mark.parametrize("argv, msg", [
    (["--lm", LM_PATH], "--lm fuses into the beam search"),
    (["--hotwords", "cat"], "--hotwords biases the beam search"),
    (["--beam-width", "1", "--hotwords", "cat"], "--hotwords biases the beam search"),
], ids=["lm", "hotwords", "beam-1"])
def test_transcribe_beam_cli_errors(two_utterances, argv, msg, capsys):
    wav = two_utterances.replace("test_manifest.jsonl", "test_00000.wav")
    with pytest.raises(SystemExit):
        ttranscribe.main([wav, "--checkpoint", CKPT, "--device", "cpu"] + argv)
    assert msg in capsys.readouterr().err


@pytest.mark.parametrize("argv, msg", [
    (["--lm", LM_PATH], "--lm fuses into the beam search"),
    (["--hotwords", "cat"], "hotword boosting biases the beam search"),
    (["--hotwords-oracle", "--beam-width", "1"], "hotword boosting biases the beam search"),
    (["--beam-width", "8", "--hotwords", "cat", "--hotwords-oracle"], "mutually exclusive"),
    (["--beam-width", "8", "--hotwords-oracle", "--streaming"],
     "--hotwords-oracle is not supported with --streaming"),
], ids=["lm", "hotwords", "oracle-beam-1", "both-hotwords", "oracle-streaming"])
def test_evaluate_beam_cli_errors(two_utterances, argv, msg, capsys):
    with pytest.raises(SystemExit):
        tevaluate.main(["--checkpoint", CKPT, "--test-set", two_utterances,
                        "--device", "cpu"] + argv)
    assert msg in capsys.readouterr().err
