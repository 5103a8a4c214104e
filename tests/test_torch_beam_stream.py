"""Parity of the port's chunk-carried (streaming) beam with the JAX package's.

- ``ctc_beam_resume`` then ``beam_commit``, chunk after chunk (3 chunks,
  ragged ``valid``, a ``frame_base`` per row), against the JAX functions
  leaf by leaf: integer leaves equal (the hashes as uint32 values), float
  leaves within 1e-5 + 1e-7 |x| (fp32 sums of log posteriors whose last
  bits differ between the two log-softmax implementations); with cap 64,
  and with cap 4, where every row overflows;
- the port's resume over chunks against its own one-shot search: the same
  beams; commits plus the finalized suffix give the one-shot best;
- ``StreamingBeam`` (update, commit, finalize, finalize_full with
  scorers), ``rescore_pick_best`` and ``finalize_pick`` against the JAX
  classes;
- on a small model whose weights go through the converter, fp32: the
  live ``StreamingTranscriber`` (lookahead 0 and 1, fed uneven blocks)
  and ``BatchedStreamingTranscriber`` (batch 4 over 6 utterances,
  lookahead 0 and 1, with the committed LM as a rescorer) at beam 4
  against the JAX classes: the same text after every feed, the same
  committed tokens and spans; the live session against the batched path;
  beam width 1 against greedy; a live session whose prefix buffer of 2
  overflows: the JAX class's truncated text, and a warning.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velocity_asr_tpu import beam as jbeam
from velocity_asr_tpu import lm as jlm
from velocity_asr_tpu import streaming as jstream
from velocity_asr_tpu.decode import CTCDecoder as JaxDecoder
from velocity_asr_tpu.models import config as jconfig
from velocity_asr_tpu.models import model as jmodel
from velocity_asr_tpu_torch import beam as tbeam
from velocity_asr_tpu_torch import lm as tlm
from velocity_asr_tpu_torch import streaming as tstream
from velocity_asr_tpu_torch.checkpoint import params_from_numpy
from velocity_asr_tpu_torch.decode import CTCDecoder, create_default_vocabulary
from velocity_asr_tpu_torch.models import model as tmodel
from velocity_asr_tpu_torch.models.config import VelocityASRConfig

LM_PATH = "checkpoints/synth_run/lm.json.gz"
FLOAT_TOL = dict(rtol=1e-7, atol=1e-5)
CHUNK_FRAMES = 50


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: under xdist the workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _logits(seed, batch, t_len, vocab, scale=2.0):
    return (np.random.default_rng(seed).standard_normal((batch, t_len, vocab))
            * scale).astype(np.float32)


def _assert_state_equal(ours: dict, ref: dict, what):
    assert set(ours) == set(ref), what
    for key, want in ref.items():
        got, want = ours[key].numpy(), np.asarray(want)
        if want.dtype.kind == "f":
            assert got.dtype == want.dtype, (what, key)
            np.testing.assert_allclose(got, want, err_msg=f"{what} {key}", **FLOAT_TOL)
        else:
            np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=f"{what} {key}")


@pytest.mark.parametrize("cap", [64, 4])
def test_resume_and_commit_match_jax(cap):
    """3 chunks of 15 frames, rows valid for 45, 31 and 17 frames, frame
    bases 100, 7 and 0; each chunk resumed then committed."""
    batch, vocab, k = 3, 12, 4
    logits = _logits(cap, batch, 45, vocab)
    valid_total = np.array([45, 31, 17])
    base = np.array([100, 7, 0], np.int32)
    ref = jbeam.beam_state_init(batch, k, cap)
    ours = tbeam.beam_state_init(batch, k, cap)
    _assert_state_equal(ours, ref, "init")
    committed = 0
    for c in range(3):
        lo = 15 * c
        v = np.clip(valid_total - lo, 0, 15).astype(np.int32)
        ref = jbeam.ctc_beam_resume(ref, jnp.asarray(logits[:, lo:lo + 15]), jnp.asarray(v),
                                    frame_base=jnp.asarray(base + lo))
        ours = tbeam.ctc_beam_resume(ours, torch.from_numpy(logits[:, lo:lo + 15]), v,
                                     frame_base=base + lo)
        _assert_state_equal(ours, ref, f"resume {c}")
        ref, n_ref, info_ref = jbeam.beam_commit(ref)
        ours, n_ours, info_ours = tbeam.beam_commit(ours)
        np.testing.assert_array_equal(n_ours.numpy(), np.asarray(n_ref))
        _assert_state_equal(info_ours, info_ref, f"commit info {c}")
        _assert_state_equal(ours, ref, f"commit {c}")
        committed += int(n_ours.sum())
    assert committed > 0
    assert bool(ours["overflow"].all()) == (cap == 4)
    if cap == 4:  # clean truncation: no length past the buffer
        assert int(ours["lengths"].max()) <= cap


def test_resume_leaves_rows_past_valid_untouched():
    state = tbeam.beam_state_init(2, 4, 32)
    state = tbeam.ctc_beam_resume(state, torch.from_numpy(_logits(1, 2, 10, 12)), [10, 10])
    after = tbeam.ctc_beam_resume(state, torch.from_numpy(_logits(2, 2, 10, 12)), [0, 10])
    for key in tbeam._RESUME_KEYS:
        assert torch.equal(after[key][0], state[key][0]), key
    assert not torch.equal(after["scores"][1], state["scores"][1])


@pytest.mark.parametrize("chunks", [(13, 14, 13), (40,), (1,) * 40], ids=["3", "1", "40"])
def test_resume_over_chunks_equals_one_shot(chunks):
    batch, t_len, vocab, k = 3, 40, 12, 6
    logits = _logits(3, batch, t_len, vocab)
    valid_total = np.array([40, 33, 25])
    state = tbeam.beam_state_init(batch, k, t_len)
    lo = 0
    for size in chunks:
        state = tbeam.ctc_beam_resume(state, torch.from_numpy(logits[:, lo:lo + size]),
                                      np.clip(valid_total - lo, 0, size))
        lo += size
    beams, overflow = tbeam.beam_finalize(state)
    assert not overflow.any()
    for b in range(batch):
        toks, lens, scores = tbeam.ctc_beam_search_torch(
            torch.from_numpy(logits[b:b + 1, :valid_total[b]]), k)
        want = [(t, float(s)) for t, s in zip(tbeam.beams_to_token_lists(toks, lens)[0],
                                              scores[0].tolist()) if s > -1e29]
        assert beams[b] == want


def test_commits_and_final_suffix_give_the_one_shot_best():
    """A buffer of 32 for 40 frames (random logits leave the beams
    disagreeing on a long tail, so the buffer needs ~T/2 headroom)."""
    batch, vocab, k = 2, 10, 5
    logits = _logits(1, batch, 40, vocab)
    sb = tbeam.StreamingBeam(batch, k, cap=32)
    emitted = [[] for _ in range(batch)]
    for c in range(4):
        sb.update(torch.from_numpy(logits[:, 10 * c:10 * (c + 1)]), 10, frame_base=10 * c)
        for b, info in enumerate(sb.commit()):
            emitted[b] += info["tokens"]
            assert len(info["stamps"]) == len(info["tokens"]) == len(info["lp"])
        assert sb.committed == emitted
    final = sb.finalize()
    assert not sb.overflowed
    toks, lens, _ = tbeam.ctc_beam_search_torch(torch.from_numpy(logits), k)
    best = [beams[0] for beams in tbeam.beams_to_token_lists(toks, lens)]
    assert final == best
    assert all(f[:len(e)] == e for f, e in zip(final, emitted))
    assert min(len(e) for e in emitted) > 0


def test_streaming_beam_matches_jax():
    batch, vocab, k = 2, 30, 4
    logits = _logits(5, batch, 60, vocab)
    lm_t, lm_j = tlm.CharNGramLM.load(LM_PATH), jlm.CharNGramLM.load(LM_PATH)
    ours = tbeam.StreamingBeam(batch, k, cap=16, scorers=[(lm_t, 0.5)])
    ref = jbeam.StreamingBeam(batch, k, cap=16, scorers=[(lm_j, 0.5)])
    for c in range(3):
        chunk = logits[:, 20 * c:20 * (c + 1)]
        valid = [20, 20 if c < 2 else 9]
        ours.update(torch.from_numpy(chunk), valid, frame_base=20 * c)
        ref.update(jnp.asarray(chunk), np.asarray(valid), frame_base=20 * c)
        got, want = ours.commit(), ref.commit()
        for g, w in zip(got, want):
            assert g["tokens"] == w["tokens"] and g["stamps"] == w["stamps"]
            assert (g["tail"] is None) == (w["tail"] is None)
            np.testing.assert_allclose(np.array(g["lp"]).reshape(-1),
                                       np.array(w["lp"]).reshape(-1), **FLOAT_TOL)
    assert ours.committed == ref.committed
    assert ours.finalize() == ref.finalize()
    got, want = ours.finalize_full(), ref.finalize_full()
    for g, w in zip(got, want):
        assert g["tokens"] == w["tokens"] and g["suffix_stamps"] == w["suffix_stamps"]
    assert ours.overflowed == ref.overflowed
    ours.reset()
    assert ours.committed == [[], []] and not ours.overflowed


def test_rescore_pick_best_matches_jax():
    lm_t, lm_j = tlm.CharNGramLM.load(LM_PATH), jlm.CharNGramLM.load(LM_PATH)
    beams = [([5, 6, 7], -3.0), ([5, 6], -2.5), ([20, 21, 4], -3.2)]
    for scorers_t, scorers_j in (([(lm_t, 0.5)], [(lm_j, 0.5)]), ([], []),
                                 ([(lm_t, 4.0)], [(lm_j, 4.0)])):
        assert tbeam.rescore_pick_best([3, 4], beams, scorers_t, return_index=True) == \
            jbeam.rescore_pick_best([3, 4], beams, scorers_j, return_index=True)
    assert tbeam.rescore_pick_best([3], [], []) == [3]
    full = [{"tokens": t, "score": s, "stamps": [(i, i + 1) for i in range(len(t))],
             "lp": [[-0.1, 1]] * len(t)} for t, s in beams]
    assert tbeam.finalize_pick([1], full, [(lm_t, 0.5)]) == jbeam.finalize_pick(
        [1], full, [(lm_j, 0.5)])
    assert tbeam.finalize_pick([1], [], []) == {"tokens": [1], "suffix_stamps": [],
                                                "suffix_lp": []}


# ------------------------------------------------------------ transcribers


def _small_config(**kw):
    return dict(d_model=32, ssm_layers=2, ssm_state_dim=8, global_ssm_layers=2,
                global_ssm_state_dim=4, attention_heads=4, attention_dim=16, vocab_size=30,
                dtype="float32", dropout=0.0, stream_summary_tokens=16,
                stream_memory_chunks=4, **kw)


@pytest.fixture(scope="module")
def models():
    """A small model (perturbed flax weights through the converter) in both
    packages; the JAX side runs its sequential scan, the port the kernel
    path's plain version."""
    cfg = jconfig.VelocityASRConfig(scan_mode="sequential", **_small_config())
    jm = jmodel.create_model(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(11), jnp.zeros((1, 16, 80)))["params"]
    rng = np.random.default_rng(111)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.1 * rng.standard_normal(p.shape)).astype(np.float32),
        jax.device_get(params))
    port = tmodel.create_model(VelocityASRConfig(scan_mode="pallas", **_small_config()),
                               device="cpu")
    port.load_state_dict(params_from_numpy(params), strict=True)
    vocab = create_default_vocabulary(30)
    return jm, params, JaxDecoder(vocab), port, CTCDecoder(vocab)


@pytest.fixture(scope="module")
def lms():
    return tlm.CharNGramLM.load(LM_PATH), jlm.CharNGramLM.load(LM_PATH)


def _audios():
    rng = np.random.default_rng(5)
    return [(rng.standard_normal(n) * 0.3).astype(np.float32)
            for n in (9000, 16000, 12345, 3001, 20000, 7000)]


def _feed(st, audio, blocks=(1234, 77, 4000, 1600)):
    texts, start, i = [], 0, 0
    while start < len(audio):
        piece = audio[start:start + blocks[i % len(blocks)]]
        texts.append(st.feed(piece))
        start, i = start + len(piece), i + 1
    return texts + [st.finish()]


@pytest.mark.parametrize("lookahead", [0, 1])
def test_streaming_transcriber_beam_matches_jax(models, lms, lookahead):
    jm, params, jdec, port, dec = models
    kw = dict(chunk_frames=CHUNK_FRAMES, lookahead_chunks=lookahead, beam_width=4)
    ref = jstream.StreamingTranscriber(jm, params, jdec, beam_scorers=[(lms[1], 0.5)], **kw)
    ours = tstream.StreamingTranscriber(port, dec, beam_scorers=[(lms[0], 0.5)], **kw)
    for audio in _audios()[1:5:3]:
        ref.reset(), ours.reset()
        assert _feed(ours, audio) == _feed(ref, audio)
        assert ours.text == ref.text and ours.text
        assert ours._tokens == ref._tokens
        assert ours._stamps == ref._stamps and ours._decoded_frames == ref._decoded_frames
        np.testing.assert_allclose(np.array(ours._stamp_lp, np.float64).reshape(-1),
                                   np.array(ref._stamp_lp, np.float64).reshape(-1), **FLOAT_TOL)


@pytest.mark.parametrize("lookahead", [0, 1])
def test_batched_streaming_beam_matches_jax(models, lms, lookahead):
    jm, params, jdec, port, dec = models
    kw = dict(chunk_frames=CHUNK_FRAMES, batch_size=4, lookahead_chunks=lookahead,
              beam_width=4)
    ref = jstream.BatchedStreamingTranscriber(jm, params, jdec, beam_scorers=[(lms[1], 0.5)],
                                              **kw)
    ours = tstream.BatchedStreamingTranscriber(port, dec, beam_scorers=[(lms[0], 0.5)], **kw)
    texts = ours.transcribe_batch(_audios())
    assert texts == ref.transcribe_batch(_audios())
    assert len(texts) == 6 and all(texts)


def test_batched_beam_matches_live_session(models):
    port, dec = models[3:]
    audios = _audios()[:3]
    live = tstream.StreamingTranscriber(port, dec, chunk_frames=CHUNK_FRAMES, beam_width=4)
    singles = []
    for audio in audios:
        live.reset()
        singles.append("".join(_feed(live, audio, (1600,))))
    batched = tstream.BatchedStreamingTranscriber(port, dec, chunk_frames=CHUNK_FRAMES,
                                                  batch_size=2, beam_width=4)
    assert batched.transcribe_batch(audios) == singles


def test_beam_width_1_is_greedy(models):
    port, dec = models[3:]
    audios = _audios()[:3]
    for cls, kw in ((tstream.BatchedStreamingTranscriber, dict(batch_size=2)),
                    (tstream.StreamingTranscriber, {})):
        texts = {}
        for width in (0, 1):
            st = cls(port, dec, chunk_frames=CHUNK_FRAMES, beam_width=width, **kw)
            if cls is tstream.StreamingTranscriber:
                texts[width] = []
                for audio in audios:
                    st.reset()
                    texts[width].append("".join(_feed(st, audio)))
            else:
                texts[width] = st.transcribe_batch(audios)
        assert texts[1] == texts[0] and all(texts[0])


def test_live_beam_overflow_truncates_as_jax_and_warns(models, caplog):
    """A prefix buffer of 2 uncommitted tokens overflows on random weights:
    the same truncated text as the JAX class, and finish() warns."""
    jm, params, jdec, port, dec = models
    audio = _audios()[4]
    ref = jstream.StreamingTranscriber(jm, params, jdec, chunk_frames=CHUNK_FRAMES,
                                       beam_width=4, beam_cap=2)
    ours = tstream.StreamingTranscriber(port, dec, chunk_frames=CHUNK_FRAMES, beam_width=4,
                                        beam_cap=2)
    with caplog.at_level("WARNING", logger="velocity_asr_tpu_torch.streaming"):
        assert _feed(ours, audio) == _feed(ref, audio)
    assert ours._sbeam.overflowed and ref._sbeam.overflowed
    assert "overflowed (cap=2)" in caplog.text
