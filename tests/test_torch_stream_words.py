"""Parity of the port's word timestamps and per-row time offsets with the
JAX package's.

- the timestamp helpers of ``decode.py`` (``timestamps_from_predictions``,
  ``ctc_greedy_decode_with_timestamps``, ``frame_to_seconds``,
  ``words_with_timestamps``, ``token_logprobs_from_frames``,
  ``CTCDecoder.text_to_tokens``): equal outputs on the same inputs;
- a (batch,) tensor of time offsets: ``PositionalEncoding2D`` and the
  whole model's streaming step against the JAX package's with the same
  vector (fp32, atol 1e-4 on the logits and every state leaf), and each
  row within 1e-6 of the port's own step of the same batch at that row's
  int offset, rows at offset 0 (the cached table) and past it in one
  batch; a batch mixing rows at their first chunk with rows deep into a
  session gives each row its own single-row result (1e-5: the batch size
  changes the matmuls' blocking);
- ``StreamingTranscriber.words()`` and ``take_new_words()`` at lookahead 0
  and 1, greedy and beam 4, fed uneven blocks, against the JAX package's
  transcriber on the same weights: the same text after every feed, the
  same tokens and frame spans, the same words, starts and ends, and
  confidences within 1e-4; ``_decode_logits`` on crafted logits: spans by
  the offline rule and the known confidence within 1e-5;
- the CLI's ``--timestamps``, ``--input-dir`` and ``--output`` on the
  committed checkpoint.

The JAX side runs ``scan_mode="sequential"`` (its oracle); the port runs
"pallas", whose plain version runs on CPU tensors.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velocity_asr_tpu import decode as jdecode
from velocity_asr_tpu import streaming as jstream
from velocity_asr_tpu.models import config as jconfig
from velocity_asr_tpu.models import layers as jlayers
from velocity_asr_tpu.models import model as jmodel
from velocity_asr_tpu_torch import decode as tdecode
from velocity_asr_tpu_torch import streaming as tstream
from velocity_asr_tpu_torch import synth as tsynth
from velocity_asr_tpu_torch import transcribe as ttranscribe
from velocity_asr_tpu_torch.checkpoint import (params_from_numpy, stream_state_from_numpy,
                                               stream_state_to_numpy)
from velocity_asr_tpu_torch.models import layers as tlayers
from velocity_asr_tpu_torch.models import model as tmodel
from velocity_asr_tpu_torch.models.config import VelocityASRConfig

CKPT = "checkpoints/synth_run/final_pretrained"
MODEL_ATOL = 1e-4  # fp32, other summation orders through the SSM blocks
ROW_ATOL = 1e-6  # a row at its own offset against the batch at that int offset
# a row of a batched step against the same row stepped alone: the batch
# size changes the matmuls' blocking (seen: 4e-6 at batch 5 against 1)
ALONE_ATOL = 1e-5
CONF_ATOL = 1e-4  # word confidences: exp of summed fp32 log posteriors
CHUNK_FRAMES = 50


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: under xdist the workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -------------------------------------------------------- timestamp helpers


def _preds(seed, batch=3, t_len=40, vocab=8):
    """Per-frame argmax ids with long runs, blanks and repeats."""
    rng = np.random.default_rng(seed)
    runs = rng.integers(0, vocab, size=(batch, t_len // 2))
    return np.repeat(runs, 2, axis=1)[:, :t_len] * (rng.random((batch, t_len)) > 0.2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_timestamps_from_predictions_matches_jax(seed):
    preds = _preds(seed)
    assert tdecode.timestamps_from_predictions(preds) == \
        jdecode.timestamps_from_predictions(preds)
    assert tdecode.timestamps_from_predictions(preds, blank_token=2) == \
        jdecode.timestamps_from_predictions(preds, blank_token=2)


def test_greedy_decode_with_timestamps_matches_jax():
    logits = np.random.default_rng(4).standard_normal((2, 30, 6)).astype(np.float32) * 3
    ours = tdecode.ctc_greedy_decode_with_timestamps(torch.from_numpy(logits))
    assert ours == jdecode.ctc_greedy_decode_with_timestamps(jnp.asarray(logits))
    assert ours == tdecode.ctc_greedy_decode_with_timestamps(logits)


@pytest.mark.parametrize("frame", [0, 1, 37, 50_000])
def test_frame_to_seconds_matches_jax(frame):
    assert tdecode.frame_to_seconds(frame, 160, 16000) == \
        jdecode.frame_to_seconds(frame, 160, 16000)


SUBWORD_VOCAB = ["<blank>", "<unk>", " ", "▁he", "llo", "▁wor", "ld", "a▁b", "▁", "x"]


@pytest.mark.parametrize("vocab", ["chars", "subwords"])
@pytest.mark.parametrize("with_lp", [False, True])
def test_words_with_timestamps_matches_jax(vocab, with_lp):
    vocabulary = (tdecode.create_default_vocabulary(30) if vocab == "chars" else SUBWORD_VOCAB)
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, len(vocabulary) + 2, size=40)  # some out of range
    tokens[::6] = vocabulary.index(" ")  # word boundaries
    tokens = tokens.tolist()
    starts = np.cumsum(rng.integers(1, 4, size=40))
    stamps = [(int(s), int(s + rng.integers(1, 3))) for s in starts]
    lp = (-rng.random(40)).tolist() if with_lp else None
    ours = tdecode.words_with_timestamps(tokens, stamps, vocabulary, 160, 16000,
                                         token_logprobs=lp)
    ref = jdecode.words_with_timestamps(tokens, stamps, vocabulary, 160, 16000,
                                        token_logprobs=lp)
    assert ours == ref and len(ours) > 3
    assert all(("confidence" in w) == with_lp for w in ours)


def test_token_logprobs_from_frames_matches_jax():
    frame_lp = -np.random.default_rng(6).random(50).astype(np.float32)
    stamps = [(0, 3), (5, 5), (7, 20), (49, 50)]  # an empty span counts one frame
    assert tdecode.token_logprobs_from_frames(frame_lp, stamps) == \
        jdecode.token_logprobs_from_frames(frame_lp, stamps)


@pytest.mark.parametrize("unk", [True, False])
def test_text_to_tokens_matches_jax(unk):
    vocab = tdecode.create_default_vocabulary(40)
    if not unk:
        vocab = [t for t in vocab if t != "<unk>"]
    text = "Hello, wörld 42 ÿ"
    assert tdecode.CTCDecoder(vocab).text_to_tokens(text) == \
        jdecode.CTCDecoder(vocab).text_to_tokens(text)


# ---------------------------------------------------- per-row time offsets


OFFSETS = [0, 37, 0, 1000, 5]


def test_positional_encoding_vector_offset_matches_jax():
    x = np.random.default_rng(7).standard_normal((len(OFFSETS), 12, 32)).astype(np.float32)
    module = jlayers.PositionalEncoding2D(d_model=32)
    params = jax.jit(module.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = module.apply(params, jnp.asarray(x), time_offset=jnp.asarray(OFFSETS, jnp.int32))
    ours = tlayers.PositionalEncoding2D(32)
    ours.load_state_dict(params_from_numpy(jax.device_get(params["params"])), strict=True)
    with torch.inference_mode():
        out = ours(torch.from_numpy(x), torch.tensor(OFFSETS))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
        for row, off in enumerate(OFFSETS):
            alone = ours(torch.from_numpy(x[row:row + 1]), off)
            # the same positions and the same sinusoid: bit-equal rows
            assert torch.equal(out[row:row + 1], alone), off


def _small_config(**kw):
    return dict(d_model=32, ssm_layers=2, ssm_state_dim=8, global_ssm_layers=1,
                global_ssm_state_dim=4, attention_heads=4, attention_dim=16, vocab_size=30,
                dtype="float32", dropout=0.0, stream_summary_tokens=16, stream_memory_chunks=2,
                **kw)


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.1 * rng.standard_normal(p.shape)).astype(np.float32),
        jax.device_get(tree))


@pytest.fixture(scope="module")
def models():
    """The same perturbed weights in both packages, and a jitted JAX step."""
    cfg = jconfig.VelocityASRConfig(scan_mode="sequential", **_small_config())
    jm = jmodel.create_model(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(11), jnp.zeros((1, 16, 80)))
    params = _perturb(params["params"], 111)
    port = tmodel.create_model(VelocityASRConfig(scan_mode="pallas", **_small_config()),
                               device="cpu")
    port.load_state_dict(params_from_numpy(params), strict=True)

    @jax.jit
    def step(state, mel, offset):
        return jm.apply({"params": params}, mel, stream_state=state, time_offset=offset,
                        return_state=True)

    vocab = tdecode.create_default_vocabulary(30)
    return jm, params, step, port, jdecode.CTCDecoder(vocab), tdecode.CTCDecoder(vocab)


def _mel(seed, batch, frames=CHUNK_FRAMES):
    return np.random.default_rng(seed).standard_normal((batch, frames, 80)).astype(np.float32)


def _rows(state, rows):
    return tstream._tree_map(lambda x: x[rows], state)


def _assert_state_close(port_state, jax_state, atol):
    flat_p = jax.tree_util.tree_leaves(stream_state_to_numpy(port_state))
    flat_j = jax.tree_util.tree_leaves(jax.device_get(jax_state))
    assert len(flat_p) == len(flat_j)
    for a, b in zip(flat_p, flat_j):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=atol)


@torch.inference_mode()
def test_model_step_vector_offset_matches_jax(models):
    jm, _, step, port, _, _ = models
    b = len(OFFSETS)
    # a warm state (two chunks in) for every row, then one step at a
    # (batch,) vector of offsets
    st_j = jstream.init_stream_state(jm.config, b)
    for c in range(2):
        _, st_j = step(st_j, jnp.asarray(_mel(20 + c, b)), c * CHUNK_FRAMES // 2)
    st_t = stream_state_from_numpy(jax.device_get(st_j))
    mel = _mel(30, b)
    offs = np.asarray(OFFSETS, np.int32)
    ref, ref_state = step(st_j, jnp.asarray(mel), jnp.asarray(offs))
    out, new = port(torch.from_numpy(mel), stream_state=st_t, time_offset=torch.from_numpy(offs),
                    return_state=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=MODEL_ATOL)
    _assert_state_close(new, ref_state, MODEL_ATOL)
    # each row against the same batch stepped at that row's int offset
    # (the scalar path; offset 0 reads the cached table)
    for off in sorted(set(OFFSETS)):
        rows = [r for r, o in enumerate(OFFSETS) if o == off]
        alone, alone_state = port(torch.from_numpy(mel), stream_state=st_t, time_offset=off,
                                  return_state=True)
        np.testing.assert_allclose(out[rows].numpy(), alone[rows].numpy(), rtol=0,
                                   atol=ROW_ATOL, err_msg=f"offset {off}")
        _assert_state_close(_rows(new, rows), stream_state_to_numpy(_rows(alone_state, rows)),
                            ROW_ATOL)


@torch.inference_mode()
def test_batch_mixing_first_chunks_and_deep_rows(models):
    """Rows at their first chunk (cold memory: gc_init false, offset 0)
    beside rows deep into a session give each row its own result."""
    port = models[3]
    warm = tstream.init_stream_state(port.config, 2)
    for c in range(3):
        _, warm = port(torch.from_numpy(_mel(40 + c, 2)), stream_state=warm,
                       time_offset=c * CHUNK_FRAMES // 2, return_state=True)
    cold = tstream.init_stream_state(port.config, 2)
    # rows 0 and 2 cold, rows 1 and 3 warm
    state = tstream._tree_map(lambda c, w: torch.stack([c[0], w[0], c[1], w[1]]), cold, warm)
    offsets = [0, 3 * CHUNK_FRAMES // 2, 0, 3 * CHUNK_FRAMES // 2]
    assert state["gc_init"].tolist() == [False, True, False, True]
    mel = _mel(50, 4)
    out, new = port(torch.from_numpy(mel), stream_state=state,
                    time_offset=torch.tensor(offsets), return_state=True)
    assert new["gc_init"].all()
    for row in range(4):
        alone, alone_state = port(torch.from_numpy(mel[row:row + 1]),
                                  stream_state=_rows(state, slice(row, row + 1)),
                                  time_offset=offsets[row], return_state=True)
        np.testing.assert_allclose(out[row:row + 1].numpy(), alone.numpy(), rtol=0,
                                   atol=ALONE_ATOL)
        _assert_state_close(_rows(new, slice(row, row + 1)),
                            stream_state_to_numpy(alone_state), ALONE_ATOL)


# ------------------------------------------------------- streaming words


def _audio(n, seed):
    return (np.random.default_rng(seed).standard_normal(n) * 0.3).astype(np.float32)


def _assert_words_match(ours, ref):
    assert [(w["word"], w["start"], w["end"]) for w in ours] == \
        [(w["word"], w["start"], w["end"]) for w in ref]
    for a, b in zip(ours, ref):
        assert a["confidence"] == pytest.approx(b["confidence"], abs=CONF_ATOL)


@pytest.mark.parametrize("beam", [0, 4])
@pytest.mark.parametrize("lookahead", [0, 1])
def test_streaming_words_match_jax(models, lookahead, beam):
    jm, params, _, port, jdec, dec = models
    ref = jstream.StreamingTranscriber(jm, params, jdec, chunk_frames=CHUNK_FRAMES,
                                       lookahead_chunks=lookahead, beam_width=beam)
    ours = tstream.StreamingTranscriber(port, dec, chunk_frames=CHUNK_FRAMES,
                                        lookahead_chunks=lookahead, beam_width=beam)
    blocks = [1234, 77, 4000, 1600]
    audio = _audio(26000, 9)
    start, i = 0, 0
    taken = [[], []]
    while start < len(audio):
        piece = audio[start:start + blocks[i % len(blocks)]]
        assert ours.feed(piece) == ref.feed(piece)
        new_ours, new_ref = ours.take_new_words(), ref.take_new_words()
        _assert_words_match(new_ours, new_ref)
        taken[0] += new_ours
        taken[1] += new_ref
        start, i = start + len(piece), i + 1
    assert ours.finish() == ref.finish()
    taken[0] += ours.take_new_words(flush=True)
    taken[1] += ref.take_new_words(flush=True)
    assert ours._tokens == ref._tokens and ours.text and ours.text == ref.text
    assert ours._stamps == ref._stamps
    assert ours._decoded_frames == ref._decoded_frames
    words = ours.words()
    _assert_words_match(words, ref.words())
    _assert_words_match(taken[0], words)
    assert taken[0] == words  # the increments are the final words, bit for bit
    assert " ".join(w["word"] for w in words) == " ".join(ours.text.split())
    assert all(0.0 < w["confidence"] <= 1.0 for w in words)


def test_decode_logits_spans_and_confidence(models):
    """Crafted logits: spans across the chunk seam by the offline rule,
    and a confidence of exactly the softmax's value (the JAX test's)."""
    jm, params, _, port, jdec, dec = models
    vocab = 30
    preds = np.array([0, 3, 3, 3, 3, 0, 4, 4, 5, 0, 0, 5, 5, 6, 7, 7], np.int64)
    ours = tstream.StreamingTranscriber(port, dec, chunk_frames=8)
    ref = jstream.StreamingTranscriber(jm, params, jdec, chunk_frames=8)
    for s in range(0, len(preds), 4):
        chunk = preds[s:s + 4]
        logits = np.full((1, len(chunk), vocab), -10.0, np.float32)
        logits[0, np.arange(len(chunk)), chunk] = 10.0
        ours._decode_logits(torch.from_numpy(logits), len(chunk), s)
        ref._decode_logits(jnp.asarray(logits), len(chunk), s)
    want_tokens, want_stamps = tdecode.timestamps_from_predictions(preds[None])[0]
    assert ours._tokens == want_tokens == ref._tokens
    assert [(s, e if e >= 0 else ours._decoded_frames) for s, e in ours._stamps] == want_stamps
    _assert_words_match(ours.words(), ref.words())

    mag = 5.0
    p_tok = math.exp(mag) / (math.exp(mag) + (vocab - 1))
    preds = np.array([0, 4, 4, 0, 5, 5, 5, 0], np.int64)
    logits = np.zeros((1, len(preds), vocab), np.float32)
    logits[0, np.arange(len(preds)), preds] = mag
    ours.reset()
    ours._decode_logits(torch.from_numpy(logits[:, :4]), 4, 0)
    ours._decode_logits(torch.from_numpy(logits[:, 4:]), 4, 4)
    words = ours.words()
    assert len(words) == 1 and words[0]["word"] == "ab"
    assert abs(words[0]["confidence"] - p_tok) < 1e-5


# ------------------------------------------------------------------- CLI


def test_transcribe_cli_timestamps_input_dir_output(tmp_path, capsys):
    """--input-dir takes the WAVs under a directory (a non-WAV file is not
    collected), --timestamps adds words that join to each text, --output
    writes the results; the texts are the JAX package's (eval_fp32_final
    .json), and streaming --timestamps gives the session's words."""
    corpus = tmp_path / "corpus"
    tsynth.write_corpus(str(corpus), 2, split="test", seed=1234)
    (corpus / "notes.txt").write_text("not audio")
    out = tmp_path / "out.json"
    assert ttranscribe.main(["--input-dir", str(corpus), "--checkpoint", CKPT, "--device",
                             "cpu", "--timestamps", "--json", "--output", str(out)]) == 0
    assert capsys.readouterr().out == ""
    results = json.loads(out.read_text())
    with open("checkpoints/synth_run/eval_fp32_final.json") as f:
        jax_rows = json.load(f)["results"][:2]
    assert [r["file"] for r in results] == [str(corpus / f"test_{i:05d}.wav") for i in range(2)]
    assert [r["text"] for r in results] == [r["prediction"] for r in jax_rows]
    for r in results:
        assert " ".join(w["word"] for w in r["words"]) == " ".join(r["text"].split())
        assert all(0.0 < w["confidence"] <= 1.0 for w in r["words"])

    text_out = tmp_path / "out.tsv"
    wav = str(corpus / "test_00000.wav")
    assert ttranscribe.main([wav, str(corpus / "notes.txt"), "--checkpoint", CKPT, "--device",
                             "cpu", "--streaming", "--output", str(text_out)]) == 1
    lines = text_out.read_text().splitlines()
    assert lines[0].split("\t")[0] == wav and "unsupported format" in lines[1]
    assert ttranscribe.main([wav, "--checkpoint", CKPT, "--device", "cpu", "--streaming",
                             "--timestamps", "--json"]) == 0
    result = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert result["streaming"] and " ".join(w["word"] for w in result["words"]) == \
        " ".join(result["text"].split())
    with pytest.raises(SystemExit):
        ttranscribe.main(["--checkpoint", CKPT])
    assert "provide audio file(s) or --input-dir" in capsys.readouterr().err
