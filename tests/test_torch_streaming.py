"""Parity of the port's greedy streaming path with the JAX package's.

The same numpy inputs and weights go through both packages:

- ``StreamingMel``: bit-exact for random audio fed in uneven blocks;
- streaming steps of ``TemporalBindingLayer``, ``SSMBlock``,
  ``GlobalSSM`` and ``HierarchicalGlobalContext`` (the frozen emit pass
  too) against the flax modules: fp32, d_model 32, atol 1e-5 (rtol
  1e-5), on the outputs and on every carried leaf after every chunk;
- the whole model's streaming step over 4 chunks with
  ``stream_memory_chunks=2`` (the memory tiles, then rolls), small
  perturbed weights, fp32: atol 1e-4 on the logits and on every state
  leaf after every chunk (other summation orders through 2+2 SSM blocks),
  once more from a JAX mid-stream state moved across with
  ``stream_state_from_numpy``, and for the lookahead emit pass;
- ``StreamingTranscriber`` (lookahead 0 and 1, fed in uneven blocks) and
  ``BatchedStreamingTranscriber`` (batch 4 over 6 utterances of unequal
  length, lookahead 0 and 1): the same transcripts as the JAX classes,
  on a small config in fp32 (the committed checkpoint's jitted JAX steps
  would take most of this file's time budget to compile);
- the entry points' streaming flags on the committed checkpoint.

The JAX side runs ``scan_mode="sequential"`` (its oracle); the port runs
"pallas", the kernel path, whose plain version runs on CPU tensors.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velocity_asr_tpu import streaming as jstream
from velocity_asr_tpu.decode import CTCDecoder as JaxDecoder
from velocity_asr_tpu.models import attention as jattn
from velocity_asr_tpu.models import config as jconfig
from velocity_asr_tpu.models import layers as jlayers
from velocity_asr_tpu.models import model as jmodel
from velocity_asr_tpu.models import ssm as jssm
from velocity_asr_tpu_torch import evaluate as tevaluate
from velocity_asr_tpu_torch import streaming as tstream
from velocity_asr_tpu_torch import synth as tsynth
from velocity_asr_tpu_torch import transcribe as ttranscribe
from velocity_asr_tpu_torch.checkpoint import (params_from_numpy, stream_state_from_numpy,
                                               stream_state_to_numpy)
from velocity_asr_tpu_torch.decode import CTCDecoder, create_default_vocabulary
from velocity_asr_tpu_torch.models import attention as tattn
from velocity_asr_tpu_torch.models import layers as tlayers
from velocity_asr_tpu_torch.models import model as tmodel
from velocity_asr_tpu_torch.models import ssm as tssm
from velocity_asr_tpu_torch.models.config import VelocityASRConfig
from velocity_asr_tpu_torch.ops import cuda_lib

CKPT = "checkpoints/synth_run/final_pretrained"
D_MODEL = 32
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: under xdist the workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _init(module, seed, *inputs):
    """Perturbed flax parameters (jitted init: eager flax costs seconds)."""
    params = jax.jit(module.init)(jax.random.PRNGKey(seed), *map(jnp.asarray, inputs))
    return _perturb(params["params"], seed + 100)


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.1 * rng.standard_normal(p.shape)).astype(np.float32),
        jax.device_get(tree))


def _port(module_fn, params):
    with torch.device("meta"):
        module = module_fn()
    module = module.to_empty(device="cpu")
    module.load_state_dict(params_from_numpy(params), strict=True)
    return module.eval()


def _assert_tree_close(port_tree, jax_tree, atol, what):
    flat_p = jax.tree_util.tree_leaves_with_path(stream_state_to_numpy(port_tree))
    flat_j = jax.tree_util.tree_leaves_with_path(jax.device_get(jax_tree))
    assert [p for p, _ in flat_p] == [p for p, _ in flat_j], what
    for (path, a), (_, b) in zip(flat_p, flat_j):
        assert a.dtype == np.asarray(b).dtype, (what, path)
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _t(tree):
    return stream_state_from_numpy(jax.device_get(tree))


# ------------------------------------------------------------- StreamingMel


@pytest.mark.parametrize("normalize", [False, True])
def test_streaming_mel_matches_jax(normalize):
    audio = (np.random.default_rng(3).standard_normal(37_000) * 0.1).astype(np.float32)
    blocks = [1, 150, 77, 1600, 4001, 199, 12_000]
    ours, ref = tstream.StreamingMel(normalize=normalize), jstream.StreamingMel(normalize=normalize)
    start = 0
    for i in range(64):
        size = blocks[i % len(blocks)]
        piece = audio[start:start + size]
        np.testing.assert_array_equal(ours.feed(piece), ref.feed(piece))
        start += size
        if start >= len(audio):
            break
    np.testing.assert_array_equal(ours.finish(), ref.finish())
    assert ours.frames_extracted == ref.frames_extracted == 1 + len(audio) // 160
    for upto in (1, 100, 231):
        np.testing.assert_array_equal(ours.normalize_span(50, 40, upto),
                                      ref.normalize_span(50, 40, upto))
    ours.trim_raw_mel(120), ref.trim_raw_mel(120)
    for a, b in zip(ours.stats_at(200), ref.stats_at(200)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_samples", [1, 150, 201])
def test_streaming_mel_short_audio_matches_jax(n_samples):
    audio = (np.random.default_rng(n_samples).standard_normal(n_samples) * 0.1).astype(np.float32)
    ours, ref = tstream.StreamingMel(normalize=False), jstream.StreamingMel(normalize=False)
    np.testing.assert_array_equal(ours.feed(audio), ref.feed(audio))
    np.testing.assert_array_equal(ours.finish(), ref.finish())


# ----------------------------------------------------------- module steps


def test_temporal_binding_streaming_matches_jax():
    chunks = [_x(10 + i, 2, 24, 80) for i in range(3)]
    jm = jlayers.TemporalBindingLayer(mel_bins=80, d_model=D_MODEL)
    params = _init(jm, 0, chunks[0])
    port = _port(lambda: tlayers.TemporalBindingLayer(80, D_MODEL), params)
    step = jax.jit(lambda carry, mel, offset: jm.apply(
        {"params": params}, mel, carry=carry, time_offset=offset, return_carry=True))
    carry_j = np.zeros((2, 1, 80), np.float32)
    carry_t = None  # the port's first chunk makes its own zero carry
    outs = []
    for i, chunk in enumerate(chunks):
        ref, carry_j = step(carry_j, jnp.asarray(chunk), 12 * i)
        out, carry_t = port(torch.from_numpy(chunk), carry=carry_t, time_offset=12 * i,
                            return_carry=True)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **MODULE_TOL)
        np.testing.assert_array_equal(carry_t.numpy(), np.asarray(carry_j))
        outs.append(out.detach().numpy())
    # the chunks together, offline, give the same frames
    offline = port(torch.from_numpy(np.concatenate(chunks, axis=1))).detach().numpy()
    np.testing.assert_allclose(np.concatenate(outs, axis=1), offline, **MODULE_TOL)


def test_temporal_binding_streaming_refuses_what_jax_refuses():
    port = tlayers.TemporalBindingLayer(80, D_MODEL, kernel_size=5)
    with pytest.raises(NotImplementedError, match="kernel_size // 2"):
        port(torch.zeros(1, 4, 80), return_carry=True)
    with pytest.raises(ValueError, match="multiple of 2"):
        tlayers.TemporalBindingLayer(80, D_MODEL)(torch.zeros(1, 5, 80), return_carry=True)


def _block_state(seed, batch, d_inner, state_dim):
    return {"conv": _x(seed, batch, 3, D_MODEL), "ssm": _x(seed + 1, batch, d_inner, state_dim)}


@pytest.mark.parametrize("kind", ["block", "global"])
def test_ssm_streaming_matches_jax(kind):
    """Three chunks through an SSMBlock (or a 2-block GlobalSSM) from a
    random carried conv tail and scan state, against the flax module:
    outputs and every state leaf after every chunk."""
    batch = 2
    chunks = [_x(20 + i, batch, 12, D_MODEL) for i in range(3)]
    if kind == "block":
        jm = jssm.SSMBlock(d_model=D_MODEL, state_dim=8, dropout=0.0, scan_mode="sequential")
        port_fn = lambda: tssm.SSMBlock(D_MODEL, 8, scan_mode="pallas")  # noqa: E731
        key, state = "state", _block_state(24, batch, 2 * D_MODEL, 8)
    else:
        jm = jssm.GlobalSSM(d_model=D_MODEL, num_layers=2, state_dim=4, dropout=0.0,
                            scan_mode="sequential")
        port_fn = lambda: tssm.GlobalSSM(D_MODEL, 2, 4, scan_mode="pallas")  # noqa: E731
        key, state = "states", [_block_state(24 + i, batch, 2 * D_MODEL, 4) for i in (0, 2)]
    params = _init(jm, 2, chunks[0])
    port = _port(port_fn, params)
    step = jax.jit(lambda st, x: jm.apply({"params": params}, x, False, return_state=True,
                                          **{key: st}))
    st_j, st_t = state, _t(state)
    for chunk in chunks:
        ref, st_j = step(st_j, jnp.asarray(chunk))
        out, st_t = port(torch.from_numpy(chunk), return_state=True, **{key: st_t})
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **MODULE_TOL)
        _assert_tree_close(st_t, st_j, MODULE_TOL["atol"], kind)
    # a passed state is spliced in also when no state is asked back
    out = port(torch.from_numpy(chunks[0]), **{key: st_t})
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(step(st_j, chunks[0])[0]),
                               **MODULE_TOL)


def test_hierarchical_global_context_streaming_matches_jax():
    """Advancing steps from a random carried state (row 0 cold: its memory
    tiles on the first chunk, then rolls; row 1 warm from the start), then
    a frozen emit pass, against the flax module."""
    batch, length, summary_tokens, mem_tokens = 2, 20, 8, 24
    local = [_x(30 + i, batch, length, D_MODEL) for i in range(4)]
    summaries = [_x(40 + i, batch, summary_tokens, D_MODEL) for i in range(4)]
    jm = jattn.HierarchicalGlobalContext(d_model=D_MODEL, num_heads=4, attention_dim=16,
                                         global_ssm_layers=2, global_ssm_state_dim=4,
                                         dropout=0.0, scan_mode="sequential")
    params = _init(jm, 4, local[0])
    port = _port(lambda: tattn.HierarchicalGlobalContext(
        D_MODEL, 4, 16, 2, 4, scan_mode="pallas"), params)

    def apply(gc, lf, sm, frozen=False):
        return jm.apply({"params": params}, lf, summary=sm, gc_state=gc, frozen=frozen)

    step = jax.jit(apply)
    gc_j = {"mem": _x(50, batch, mem_tokens, D_MODEL),
            "blocks": [_block_state(52 + i, batch, 2 * D_MODEL, 4) for i in (0, 2)],
            "init": np.array([False, True])}
    gc_t = _t(gc_j)
    for lf, sm in zip(local[:3], summaries[:3]):
        ref, gc_j = step(gc_j, jnp.asarray(lf), jnp.asarray(sm))
        out, gc_t = port(torch.from_numpy(lf), summary=torch.from_numpy(sm), gc_state=gc_t)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **MODULE_TOL)
        _assert_tree_close(gc_t, gc_j, MODULE_TOL["atol"], "gc_state")
    ref, _ = jax.jit(apply, static_argnums=3)(gc_j, jnp.asarray(local[3]),
                                             jnp.asarray(summaries[3]), True)
    out, frozen_t = port(torch.from_numpy(local[3]), summary=torch.from_numpy(summaries[3]),
                         gc_state=gc_t, frozen=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **MODULE_TOL)
    assert frozen_t is gc_t
    with pytest.raises(ValueError, match="requires gc_state"):
        port(torch.from_numpy(local[0]), summary=torch.from_numpy(summaries[0]))


# ----------------------------------------------------------- whole model


def _small_config(**kw):
    return dict(d_model=D_MODEL, ssm_layers=2, ssm_state_dim=8, global_ssm_layers=2,
                global_ssm_state_dim=4, attention_heads=4, attention_dim=16, vocab_size=30,
                dtype="float32", dropout=0.0, **kw)


def _small_models(seed, **kw):
    cfg = jconfig.VelocityASRConfig(scan_mode="sequential", **_small_config(**kw))
    jm = jmodel.create_model(cfg)
    params = _init(jm, seed, np.zeros((1, 16, 80), np.float32))
    port = tmodel.create_model(VelocityASRConfig(scan_mode="pallas", **_small_config(**kw)),
                               device="cpu")
    port.load_state_dict(params_from_numpy(params), strict=True)
    return jm, params, port


@pytest.fixture(scope="module")
def stream_models():
    """Small models with a 2-chunk memory of 16 summary tokens per chunk
    (level 2 pools the 32 memory tokens to 16), and a jitted JAX step."""
    jm, params, port = _small_models(7, stream_summary_tokens=16, stream_memory_chunks=2)

    @jax.jit
    def step(state, mel, offset):
        return jm.apply({"params": params}, mel, stream_state=state, time_offset=offset,
                        return_state=True)

    @jax.jit
    def emit(state, mel, offset):
        return jm.apply({"params": params}, mel, stream_state=state, time_offset=offset,
                        return_state=True, frozen_mem=True)

    return jm, port, step, emit


@torch.inference_mode()
def test_model_streaming_step_matches_jax(stream_models):
    jm, port, step, emit = stream_models
    batch, frames = 2, 64
    mels = [_x(60 + c, batch, frames, 80) for c in range(4)]
    st_j = jstream.init_stream_state(jm.config, batch)
    st_t = tstream.init_stream_state(port.config, batch)
    _assert_tree_close(st_t, st_j, 0, "init_stream_state")
    states_j = []
    for c, mel in enumerate(mels):
        states_j.append(st_j)
        ref, st_j = step(st_j, jnp.asarray(mel), c * frames // 2)
        out, st_t = port(torch.from_numpy(mel), stream_state=st_t,
                         time_offset=c * frames // 2, return_state=True)
        assert out.shape == (batch, frames // 2, 30)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=MODEL_ATOL,
                                   err_msg=f"chunk {c}")
        _assert_tree_close(st_t, st_j, MODEL_ATOL, f"state after chunk {c}")
    assert st_t["gc_init"].all()

    # both packages from the same mid-stream state (JAX's, after chunk 2)
    mid = stream_state_from_numpy(jax.device_get(states_j[3]))
    ref, _ = step(states_j[3], jnp.asarray(mels[3]), 3 * frames // 2)
    out, _ = port(torch.from_numpy(mels[3]), stream_state=mid, time_offset=3 * frames // 2,
                  return_state=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=MODEL_ATOL)

    # the lookahead emit pass: chunk 1's entry local state, the latest memory
    entry = dict(states_j[1], gc_mem=st_j["gc_mem"], gc_blocks=st_j["gc_blocks"],
                 gc_init=st_j["gc_init"])
    ref, ref_state = emit(entry, jnp.asarray(mels[1]), frames // 2)
    out, out_state = port(torch.from_numpy(mels[1]), stream_state=_t(entry),
                          time_offset=frames // 2, return_state=True, frozen_mem=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=MODEL_ATOL)
    _assert_tree_close(out_state, ref_state, MODEL_ATOL, "emit state")


def test_model_streaming_guards(stream_models):
    port = stream_models[1]
    with pytest.raises(ValueError, match="frozen_mem requires"):
        port(torch.zeros(1, 64, 80), return_state=True, frozen_mem=True)


def test_offline_forward_launches_the_stateless_scan(monkeypatch, stream_models):
    """A forward without stream state scans with h0 = 0 through scan_fwd,
    a streaming one through scan_fwd_state (8 + 2 blocks here: 2 + 2)."""
    from velocity_asr_tpu_torch.ops import scan as tscan

    port = stream_models[1]
    calls = []
    for name in ("scan_fwd", "scan_fwd_state"):
        fn = getattr(tscan, name)
        monkeypatch.setattr(tscan, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    with torch.inference_mode():
        port(torch.zeros(1, 64, 80))
        assert calls == ["scan_fwd"] * 4
        calls.clear()
        port(torch.zeros(1, 64, 80), return_state=True)
    assert calls == ["scan_fwd_state"] * 4


def test_stream_state_round_trip():
    cfg = VelocityASRConfig(**_small_config())
    state = tstream.init_stream_state(cfg, 3)
    state["blocks"][1]["ssm"] += torch.arange(state["blocks"][1]["ssm"].numel()).reshape(
        state["blocks"][1]["ssm"].shape)
    back = stream_state_from_numpy(stream_state_to_numpy(state))
    _assert_tree_close(back, stream_state_to_numpy(state), 0, "round trip")
    assert back["gc_init"].dtype == torch.bool


# ------------------------------------------------------------ transcribers


@pytest.fixture(scope="module")
def transcriber_models():
    jm, params, port = _small_models(11, stream_summary_tokens=16, stream_memory_chunks=4)
    vocab = create_default_vocabulary(30)
    return jm, params, JaxDecoder(vocab), port, CTCDecoder(vocab)


def _audios():
    rng = np.random.default_rng(5)
    return [(rng.standard_normal(n) * 0.3).astype(np.float32)
            for n in (9000, 16000, 12345, 3001, 20000, 7000)]


CHUNK_FRAMES = 50


@pytest.mark.parametrize("lookahead", [0, 1])
def test_streaming_transcriber_matches_jax(transcriber_models, lookahead):
    jm, params, jdec, port, dec = transcriber_models
    ref = jstream.StreamingTranscriber(jm, params, jdec, chunk_frames=CHUNK_FRAMES,
                                       lookahead_chunks=lookahead)
    ours = tstream.StreamingTranscriber(port, dec, chunk_frames=CHUNK_FRAMES,
                                        lookahead_chunks=lookahead)
    blocks = [1234, 77, 4000, 1600]
    for audio in _audios()[1:5:3]:
        ref.reset(), ours.reset()
        texts = [[], []]
        start, i = 0, 0
        while start < len(audio):
            piece = audio[start:start + blocks[i % len(blocks)]]
            texts[0].append(ours.feed(piece))
            texts[1].append(ref.feed(piece))
            start, i = start + len(piece), i + 1
        texts[0].append(ours.finish())
        texts[1].append(ref.finish())
        assert texts[0] == texts[1]
        assert ours.text == ref.text and ours.text
        assert ours._time_offset == ref._time_offset


@pytest.mark.parametrize("lookahead", [0, 1])
def test_batched_streaming_matches_jax(transcriber_models, lookahead):
    jm, params, jdec, port, dec = transcriber_models
    ref = jstream.BatchedStreamingTranscriber(jm, params, jdec, chunk_frames=CHUNK_FRAMES,
                                              batch_size=4, lookahead_chunks=lookahead)
    ours = tstream.BatchedStreamingTranscriber(port, dec, chunk_frames=CHUNK_FRAMES,
                                               batch_size=4, lookahead_chunks=lookahead)
    texts = ours.transcribe_batch(_audios())
    assert texts == ref.transcribe_batch(_audios())
    assert len(texts) == 6 and all(texts)


def test_batched_matches_live_session(transcriber_models):
    """The batched path gives each utterance the live session's text."""
    port, dec = transcriber_models[3:]
    audios = _audios()[:3]
    live = tstream.StreamingTranscriber(port, dec, chunk_frames=CHUNK_FRAMES)
    singles = []
    for audio in audios:
        live.reset()
        singles.append("".join(live.feed(audio[s:s + 1600])
                               for s in range(0, len(audio), 1600)) + live.finish())
    batched = tstream.BatchedStreamingTranscriber(port, dec, chunk_frames=CHUNK_FRAMES,
                                                  batch_size=2)
    assert batched.transcribe_batch(audios) == singles


def test_beam_width_is_not_ported(transcriber_models):
    """Both transcribers once refused beam_width > 1; they now carry a
    beam from 2 up (tests/test_torch_beam_stream.py holds it against the
    JAX package's) and stay greedy below."""
    port, dec = transcriber_models[3:]
    assert tstream.StreamingTranscriber(port, dec, beam_width=4)._sbeam.beam_width == 4
    assert tstream.StreamingTranscriber(port, dec, beam_width=1)._sbeam is None
    assert tstream.BatchedStreamingTranscriber(port, dec, beam_width=4).beam_width == 4
    assert tstream.BatchedStreamingTranscriber(port, dec, beam_width=1).beam_width == 0
    assert not hasattr(tstream, "BEAM_NOT_PORTED")


# ------------------------------------------------------------ entry points


def test_transcribe_streaming_cli(tmp_path, capsys):
    tsynth.write_corpus(str(tmp_path), 1, split="test", seed=1234)
    wav = str(tmp_path / "test_00000.wav")
    with pytest.raises(SystemExit):
        ttranscribe.main([wav, "--checkpoint", CKPT, "--device", "cpu", "--lookahead", "1"])
    assert "--lookahead requires --streaming" in capsys.readouterr().err
    assert ttranscribe.main([wav, "--checkpoint", CKPT, "--device", "cpu", "--streaming",
                             "--chunk-seconds", "2", "--json"]) == 0
    result = json.loads(capsys.readouterr().out)
    assert result["streaming"] is True and result["file"] == wav
    # the JAX package's streaming transcript of this utterance (2 s chunks)
    with open("checkpoints/synth_run/eval_streaming.json") as f:
        assert result["text"] == json.load(f)["results"][0]["prediction"]
    assert [ttranscribe.chunk_frames_of(s) for s in (2.0, 1.01, 0.5, 0.015)] == [200, 102, 50, 2]


def test_evaluate_streaming_cli(tmp_path, capsys):
    manifest = tsynth.write_corpus(str(tmp_path), 3, split="test", seed=1234)
    base = ["--checkpoint", CKPT, "--test-set", manifest, "--device", "cpu"]
    for extra, msg in ((["--streaming", "--int8-static"], "--int8-static is not supported"),
                       (["--lookahead", "1"], "--lookahead requires --streaming")):
        with pytest.raises(SystemExit):
            tevaluate.main(base + extra)
        assert msg in capsys.readouterr().err
    out = str(tmp_path / "eval.json")
    tevaluate.main(base + ["--streaming", "--lookahead", "1", "--batch-size", "2",
                           "--output", out])
    with open(out) as f:
        result = json.load(f)
    with open("checkpoints/synth_run/eval_streaming_la1.json") as f:
        jax_result = json.load(f)
    # the keys the JAX package's streaming evaluation writes now (its older
    # eval_streaming_la1.json predates beam_width, lm and lookahead)
    with open("checkpoints/synth_run/eval_streaming_la1_beam8_lm.json") as f:
        assert set(result) == set(json.load(f))
    assert set(result) == {"wer", "cer", "rtf", "utterances", "streaming", "beam_width", "lm",
                           "lookahead", "results"}
    assert set(result) - {"beam_width", "lm", "lookahead"} == set(jax_result)
    assert result["streaming"] is True and result["lookahead"] == 1
    assert result["beam_width"] == 0 and result["lm"] is False
    assert [r["reference"] for r in result["results"]] == [
        r["reference"] for r in jax_result["results"][:3]]
    assert [r["prediction"] for r in result["results"]] == [
        r["prediction"] for r in jax_result["results"][:3]]


def test_streaming_wrappers_count_no_launch_on_cpu(transcriber_models):
    port, dec = transcriber_models[3:]
    before = dict(cuda_lib.launch_counts)
    tstream.BatchedStreamingTranscriber(port, dec, chunk_frames=CHUNK_FRAMES,
                                        batch_size=2).transcribe_batch(_audios()[:2])
    assert dict(cuda_lib.launch_counts) == before
