"""Parity of the port's serving path with the JAX package's.

- ``StreamSessionBatcher``: three live sessions fed from threads in
  interleaved 4,000-sample blocks, of three lengths (so the rows of a
  shared step sit at different time offsets), then a slot reused after
  close() and a session reset in place, at lookahead 0, 1 and 2 and at
  beam 4 with a character n-gram LM (lookahead 0 and 2): the texts, token
  spans and words of dedicated port transcribers, confidences within
  1e-5 (a batched step's log-softmax rounds otherwise at ~1e-7), and the
  texts and words of the JAX package's batcher on the same weights,
  confidences within 1e-4; a full batcher raises StreamSlotsExhausted;
- ``Transcriber.transcribe_batch`` over utterances of two frame buckets:
  each text equal to ``transcribe_array``'s and to the JAX package's
  ``Transcriber.transcribe_batch``;
- the HTTP server in process on a small model (d_model 32): /health;
  /transcribe greedy, with timestamps, with the beam, with the beam and
  timestamps and with hot words, each against the JAX package's
  ``Transcriber.transcribe_array`` (the same text, words, starts and
  ends, confidences within 1e-4); the 400 / 404 / 500 / 503 split; a
  malformed chunked upload; /stream's increments joining to the final
  text and words, the final text a dedicated transcriber's, at the
  shared cadence (greedy, lookahead, beam with the LM) and a pooled one;
  the --max-streams budget shared across batcher shapes;
- ``PcmDecoder``, ``StreamPool`` and ``MicroBatcher`` on their own, and
  ``python -m velocity_asr_tpu_torch.serve`` on the committed checkpoint;
- threads at a 1 us switch interval: no launch count lost from 16
  threads, and the stream budget never exceeded under 12 contending
  threads.

The JAX side runs ``scan_mode="sequential"``; the port runs "pallas",
whose plain versions run on CPU tensors.
"""

import http.client
import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
import wave
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scripts.transcribe import Transcriber as JaxTranscriber
from velocity_asr_tpu import lm as jlm
from velocity_asr_tpu import streaming as jstream
from velocity_asr_tpu.decode import CTCDecoder as JaxDecoder
from velocity_asr_tpu.hotwords import HotwordBooster as JaxBooster
from velocity_asr_tpu.models import config as jconfig
from velocity_asr_tpu.models import model as jmodel
from velocity_asr_tpu_torch import lm as tlm
from velocity_asr_tpu_torch import serve as tserve
from velocity_asr_tpu_torch import streaming as tstream
from velocity_asr_tpu_torch import synth as tsynth
from velocity_asr_tpu_torch.checkpoint import params_from_numpy
from velocity_asr_tpu_torch.decode import CTCDecoder, create_default_vocabulary
from velocity_asr_tpu_torch.models import model as tmodel
from velocity_asr_tpu_torch.models.config import VelocityASRConfig
from velocity_asr_tpu_torch.transcribe import Transcriber

CKPT = "checkpoints/synth_run/final_pretrained"
CHUNK_FRAMES = 50
BATCHED_CONF_ATOL = 1e-5  # a batched step's log-softmax against a batch-1 one
JAX_CONF_ATOL = 1e-4  # word confidences against the JAX package's
LM_TEXTS = ["the cat sat on the mat", "a dog ran far", "we are here now", "cats and dogs"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: under xdist the workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.1 * rng.standard_normal(p.shape)).astype(np.float32),
        jax.device_get(tree))


@pytest.fixture(scope="module")
def models():
    """A small model in both packages (the same perturbed weights), the
    decoders, and a character 3-gram LM trained by each package."""
    kw = dict(d_model=32, ssm_layers=2, ssm_state_dim=8, global_ssm_layers=1,
              global_ssm_state_dim=4, attention_heads=4, attention_dim=16, vocab_size=30,
              dtype="float32", dropout=0.0, stream_summary_tokens=16, stream_memory_chunks=2)
    jm = jmodel.create_model(jconfig.VelocityASRConfig(scan_mode="sequential", **kw))
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.zeros((1, 16, 80)))
    params = _perturb(params["params"], 103)
    port = tmodel.create_model(VelocityASRConfig(scan_mode="pallas", **kw), device="cpu")
    port.load_state_dict(params_from_numpy(params), strict=True)
    vocab = create_default_vocabulary(30)
    jdec, dec = JaxDecoder(vocab), CTCDecoder(vocab)
    lms = (tlm.CharNGramLM.train(LM_TEXTS, dec.token_to_idx, order=3),
           jlm.CharNGramLM.train(LM_TEXTS, jdec.token_to_idx, order=3))
    return jm, params, jdec, port, dec, lms


def _audio(n, seed):
    return (np.random.default_rng(seed).standard_normal(n) * 0.3).astype(np.float32)


AUDIOS = [_audio(n, 20 + i) for i, n in enumerate((30000, 17000, 41000))]


def _assert_words(got, want, atol):
    assert [(w["word"], w["start"], w["end"]) for w in got] == \
        [(w["word"], w["start"], w["end"]) for w in want]
    for a, b in zip(got, want):
        assert a["confidence"] == pytest.approx(b["confidence"], abs=atol)


def _feed_all(st, audio, block=4000):
    text = "".join(st.feed(audio[i:i + block]) for i in range(0, len(audio), block))
    return text + st.finish()


# ------------------------------------------------------- session batcher


@pytest.mark.parametrize("lookahead,beam", [(0, 0), (1, 0), (2, 0), (0, 4), (2, 4)])
def test_session_batcher_matches_dedicated_and_jax(models, lookahead, beam):
    jm, params, jdec, port, dec, (lm, jax_lm) = models
    scorers = [(lm, 0.5)] if beam else None
    ref = tstream.StreamingTranscriber(port, dec, chunk_frames=CHUNK_FRAMES,
                                       lookahead_chunks=lookahead, beam_width=beam,
                                       beam_scorers=scorers)
    expected = []
    for audio in AUDIOS:
        ref.reset()
        _feed_all(ref, audio)
        expected.append((ref.text, list(ref._stamps), ref.words()))
    assert all(t for t, _, _ in expected)

    batcher = tstream.StreamSessionBatcher(port, dec, chunk_frames=CHUNK_FRAMES, max_slots=3,
                                           window_ms=20.0, lookahead=lookahead,
                                           beam_width=beam, beam_scorers=scorers)
    try:
        sessions = [batcher.open() for _ in AUDIOS]
        errs = []

        def run(sess, audio):
            try:
                _feed_all(sess, audio)
            except Exception as e:  # surfaced below
                errs.append(e)

        threads = [threading.Thread(target=run, args=pair) for pair in zip(sessions, AUDIOS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs, errs
        for sess, (text, stamps, words) in zip(sessions, expected):
            assert sess.text == text
            assert sess._stamps == stamps
            _assert_words(sess.words(), words, BATCHED_CONF_ATOL)
        # calls were shared: fewer than the sessions' chunks
        assert batcher.stats["step_calls"] < sum(-(-(len(a) // 160 + 1) // CHUNK_FRAMES)
                                                 for a in AUDIOS)
        assert (batcher.stats["emit_calls"] > 0) == (lookahead > 0)

        with pytest.raises(tstream.StreamSlotsExhausted, match="slots"):
            batcher.open()
        sessions[0].close()
        with pytest.raises(RuntimeError, match="closed"):
            sessions[0].feed(AUDIOS[0])
        reused = batcher.open()
        _feed_all(reused, AUDIOS[1])
        assert reused.text == expected[1][0]
        reused.reset()  # a new stream in the same slot
        _feed_all(reused, AUDIOS[2])
        assert reused.text == expected[2][0]
        _assert_words(reused.words(), expected[2][2], BATCHED_CONF_ATOL)
    finally:
        batcher.close()

    # the JAX package's batcher on the same weights (sessions one at a time)
    jb = jstream.StreamSessionBatcher(jm, params, jdec, chunk_frames=CHUNK_FRAMES, max_slots=3,
                                      window_ms=1.0, lookahead=lookahead, beam_width=beam,
                                      beam_scorers=[(jax_lm, 0.5)] if beam else None)
    for audio, (text, stamps, words) in zip(AUDIOS, expected):
        sess = jb.open()
        _feed_all(sess, audio)
        assert sess.text == text
        assert [list(s) for s in sess._stamps] == stamps
        _assert_words(words, sess.words(), JAX_CONF_ATOL)
        sess.close()


def test_session_batcher_fails_the_group_and_recovers(models, monkeypatch):
    """A failed shared call fails its sessions' requests, and the slot,
    closed and opened again, serves the next session as a dedicated
    transcriber would."""
    port, dec = models[3], models[4]
    batcher = tstream.StreamSessionBatcher(port, dec, chunk_frames=CHUNK_FRAMES, max_slots=2)
    try:
        sess = batcher.open()
        monkeypatch.setattr(port, "forward", lambda *a, **k: (_ for _ in ()).throw(
            RuntimeError("device fault")))
        with pytest.raises(RuntimeError, match="device fault"):
            _feed_all(sess, AUDIOS[0])
        monkeypatch.undo()
        sess.close()
        fresh = batcher.open()
        _feed_all(fresh, AUDIOS[1])
        ref = tstream.StreamingTranscriber(port, dec, chunk_frames=CHUNK_FRAMES)
        assert fresh.text == _feed_all(ref, AUDIOS[1])
    finally:
        batcher.close()


def test_session_batcher_failure_spares_other_sessions(models, monkeypatch):
    """A call that fails for one session leaves another session's rows
    alone: that session, halfway through its stream when the other's call
    failed, ends with a dedicated transcriber's text and words. The failed
    session raises on its next feed until it is reset, and then runs as a
    dedicated transcriber would."""
    port, dec = models[3], models[4]
    dedicated = []
    for audio in AUDIOS[:2]:
        ref = tstream.StreamingTranscriber(port, dec, chunk_frames=CHUNK_FRAMES)
        _feed_all(ref, audio)
        dedicated.append((ref.text, ref.words()))
    batcher = tstream.StreamSessionBatcher(port, dec, chunk_frames=CHUNK_FRAMES, max_slots=2,
                                           window_ms=1.0)
    try:
        live, failing = batcher.open(), batcher.open()
        starts = range(0, len(AUDIOS[0]), 4000)
        half = len(starts) // 2
        text = "".join(live.feed(AUDIOS[0][i:i + 4000]) for i in starts[:half])
        assert batcher.stats["step_calls"] > 0  # the live session's state is under way
        # requests run one at a time from this thread: the failing call's
        # group holds the failing session alone
        monkeypatch.setattr(port, "forward", lambda *a, **k: (_ for _ in ()).throw(
            RuntimeError("device fault")))
        with pytest.raises(RuntimeError, match="device fault"):
            _feed_all(failing, AUDIOS[1])
        monkeypatch.undo()
        text += "".join(live.feed(AUDIOS[0][i:i + 4000]) for i in starts[half:])
        text += live.finish()
        assert (text, live.text) == (dedicated[0][0], dedicated[0][0])
        _assert_words(live.words(), dedicated[0][1], BATCHED_CONF_ATOL)
        with pytest.raises(RuntimeError, match="earlier shared call"):
            _feed_all(failing, AUDIOS[1])
        failing.reset()
        _feed_all(failing, AUDIOS[1])
        assert failing.text == dedicated[1][0]
        _assert_words(failing.words(), dedicated[1][1], BATCHED_CONF_ATOL)
    finally:
        batcher.close()


# ------------------------------------------------------- transcribe_batch


def test_transcribe_batch_matches_single_and_jax(models):
    jm, params, jdec, port, dec, _ = models
    audios = [_audio(n, 30 + i) for i, n in enumerate((8000, 52000, 30000, 12001))]
    ours = Transcriber(port, dec)
    assert sorted({ours.frame_bucket_of(a) for a in audios}) == [200, 400]
    batched = ours.transcribe_batch(audios)
    singles = [ours.transcribe_array(a) for a in audios]
    assert [b["text"] for b in batched] == [s["text"] for s in singles]
    assert [b["duration"] for b in batched] == [len(a) / 16000 for a in audios]
    ref = JaxTranscriber(jm, params, jdec).transcribe_batch(audios)
    assert [b["text"] for b in batched] == [r["text"] for r in ref]
    assert all(b["text"] for b in batched)


# ------------------------------------------------------------------ HTTP


def _wav(audio):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(_pcm(audio))
    return buf.getvalue()


def _pcm(audio):
    return np.clip(np.round(audio * 32768), -32768, 32767).astype("<i2").tobytes()


def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _stream(port, pcm, query, block=3200):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.putrequest("POST", f"/stream?{query}")
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        for i in range(0, len(pcm), block):
            piece = pcm[i:i + block]
            conn.send(b"%x\r\n" % len(piece) + piece + b"\r\n")
        conn.send(b"0\r\n\r\n")
        resp = conn.getresponse()
        return resp.status, [json.loads(x) for x in resp.read().decode().splitlines()]
    finally:
        conn.close()


@pytest.fixture(scope="module")
def server(models):
    port_model, dec, (lm, _) = models[3], models[4], models[5]
    svc = tserve.ASRService(Transcriber(port_model, dec), max_streams=2, batch_window_ms=20.0,
                            lm=lm, lm_weight=0.5)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), tserve.make_handler(svc))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield svc, httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()
    svc.close()


def test_health(server):
    status, body = _request(server[1], "GET", "/health")
    assert status == 200
    assert json.loads(body) == {"status": "ok", "model": {
        "d_model": 32, "vocab_size": 30, "scan_mode": "pallas", "dtype": "float32",
        "device": "cpu"}}


TRANSCRIBE_QUERIES = {
    "greedy": ("", dict(timestamps=False, beam_width=0)),
    "timestamps": ("timestamps=1", dict(timestamps=True, beam_width=0)),
    "beam": ("beam=4", dict(timestamps=False, beam_width=4)),
    "beam_timestamps": ("beam=4&timestamps=true", dict(timestamps=True, beam_width=4)),
    "hotwords": ("beam=4&hotwords=cat,dog&hotword_weight=3", dict(timestamps=False,
                                                                   beam_width=4)),
}


@pytest.mark.parametrize("case", list(TRANSCRIBE_QUERIES))
def test_transcribe_matches_jax(models, server, case):
    jm, params, jdec = models[:3]
    query, kw = TRANSCRIBE_QUERIES[case]
    audio = np.frombuffer(_pcm(_audio(27000, 40)), "<i2").astype(np.float32) / 32768.0
    status, body = _request(server[1], "POST", f"/transcribe?{query}", _wav(audio))
    assert status == 200, body
    got = json.loads(body)
    booster = JaxBooster(["cat", "dog"], jdec.token_to_idx) if case == "hotwords" else None
    ref = JaxTranscriber(jm, params, jdec).transcribe_array(
        audio, lm_scorer=booster, lm_weight=3.0 if booster else None, **kw)
    assert got["text"] == ref["text"] and got["text"]
    assert got["duration"] == pytest.approx(ref["duration"]) and got["rtf"] > 0
    assert ("words" in got) == kw["timestamps"]
    if kw["timestamps"]:
        _assert_words(got["words"], ref["words"], JAX_CONF_ATOL)


def test_request_errors_are_classified(server, monkeypatch):
    svc, port = server
    wav = _wav(_audio(8000, 41))
    cases = [
        ("POST", "/transcribe", b"", 400, "empty body"),
        ("POST", "/transcribe", b"fLaC" + bytes(64), 400, "native decoder failed on request body"),
        ("POST", "/transcribe?beam=x", wav, 400, "invalid query value"),
        ("POST", "/transcribe?hotwords=cat", wav, 400, "add ?beam=N"),
        ("POST", "/transcribe?identify_language=1", wav, 400,
         "?identify_language needs a model with a LID head (trained with num_languages > 0)"),
        ("POST", "/diarize", wav, 400, "no speaker model"),
        ("GET", "/nope", None, 404, "unknown endpoint"),
        ("POST", "/nope", wav, 404, "unknown endpoint"),
        ("PUT", "/transcribe", wav, 404, "unknown endpoint"),
        ("POST", "/stream?lookahead=9", wav, 400, "lookahead must be in [0, 4]"),
        ("POST", "/stream?chunk_seconds=100", wav, 400, "chunk_seconds must be in"),
        ("POST", "/stream?beam=y", wav, 400, "invalid query value"),
    ]
    for method, path, body, code, msg in cases:
        status, out = _request(port, method, path, body)
        assert status == code and msg in json.loads(out)["error"], (path, status, out)

    def fail(*args, **kw):
        raise RuntimeError("device fault")

    monkeypatch.setattr(svc.transcriber, "transcribe_array", fail)
    monkeypatch.setattr(svc.transcriber, "transcribe_batch", fail)
    for path in ("/transcribe?timestamps=1", "/transcribe"):
        status, out = _request(port, "POST", path, wav)
        assert (status, json.loads(out)) == (500, {"error": "internal failure"})


def test_stream_malformed_chunked_upload(server):
    svc, port = server
    with socket.create_connection(("127.0.0.1", port), timeout=60) as sock:
        sock.sendall(b"POST /stream HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n\r\n"
                     b"zz\r\n")
        data = b""
        while chunk := sock.recv(65536):
            data += chunk
    head, _, body = data.partition(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 200")
    assert json.loads(body.decode().splitlines()[-1]) == {"error": "malformed chunk size"}
    for _ in range(100):  # the session is released once the handler ends
        if svc._batched_live == 0:
            break
        time.sleep(0.05)
    assert svc._batched_live == 0


@pytest.mark.parametrize("query,frames,lookahead,beam", [
    ("timestamps=1", 200, 0, 0),
    ("lookahead=1&timestamps=1", 200, 1, 0),
    ("beam=4&timestamps=1", 200, 0, 4),
    ("chunk_seconds=1.1&lookahead=1&timestamps=1", 100, 1, 0),  # a pooled session
])
def test_stream_increments_join_to_the_final(models, server, query, frames, lookahead, beam):
    port_model, dec, (lm, _) = models[3], models[4], models[5]
    audio = np.frombuffer(_pcm(_audio(70000, 42)), "<i2").astype(np.float32) / 32768.0
    status, lines = _stream(server[1], _pcm(audio), query)
    assert status == 200
    final = lines[-1]
    assert final["final"] and final["duration"] == pytest.approx(len(audio) / 16000)
    assert "".join(x.get("text", "") for x in lines[:-1]) == final["text"]
    assert [w for x in lines[:-1] for w in x.get("words", [])] == final["words"]
    assert len(lines) > 2  # increments arrived before the end
    ref = tstream.StreamingTranscriber(port_model, dec, chunk_frames=frames,
                                       lookahead_chunks=lookahead, beam_width=beam,
                                       beam_scorers=[(lm, 0.5)] if beam else None)
    _feed_all(ref, audio, block=1600)
    assert final["text"] == ref.text and final["text"]
    _assert_words(final["words"], ref.words(), BATCHED_CONF_ATOL)


def test_stream_budget_is_shared_across_shapes(server):
    svc, port = server
    held = [svc.open_stream(2.0, 0, 0), svc.open_stream(2.0, 1, 4)]
    try:
        assert {k for k in svc.stream_batchers} >= {(0, 0), (1, 4)}
        with pytest.raises(tserve.ServiceBusy, match="2 batched stream slots"):
            svc.open_stream(2.0, 2, 0)
        status, out = _request(port, "POST", "/stream", _pcm(_audio(3200, 43)))
        assert status == 503 and "retry later" in json.loads(out)["error"]
        svc.release_stream(held.pop())
        held.append(svc.open_stream(2.0, 2, 0))  # a third shape, within the budget
    finally:
        for st in held:
            svc.release_stream(st)
    assert svc._batched_live == 0


# ------------------------------------------------------------ the parts


class TestPcmDecoder:
    def test_raw_pcm_across_odd_boundaries(self):
        pcm = np.arange(-500, 500, dtype="<i2")
        raw = pcm.tobytes()
        dec = tserve.PcmDecoder(16000)
        out = [dec.feed(raw[i:i + 7]) for i in range(0, len(raw), 7)]
        np.testing.assert_array_equal(np.concatenate(out), pcm.astype(np.float32) / 32768.0)

    def test_wav_header_stripped(self):
        audio = _audio(5000, 44)
        data = _wav(audio)
        dec = tserve.PcmDecoder(16000)
        out = np.concatenate([dec.feed(data[i:i + 13]) for i in range(0, len(data), 13)])
        np.testing.assert_array_equal(out, np.frombuffer(_pcm(audio), "<i2") / 32768.0)

    def test_wav_wrong_format_rejected(self):
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(8000)
            w.writeframes(bytes(400))
        with pytest.raises(tserve.BadRequest, match="PCM16 mono 16000 Hz"):
            tserve.PcmDecoder(16000).feed(buf.getvalue())


def test_stream_pool_reuse_busy_and_eviction(models):
    port_model, dec = models[3], models[4]
    pool = tserve.StreamPool(Transcriber(port_model, dec), max_streams=1)
    st = pool.acquire(100, 0)
    with pytest.raises(tserve.ServiceBusy, match="busy"):
        pool.acquire(100, 0, timeout=0.1)
    st.feed(_audio(20000, 45))
    pool.release(st)
    again = pool.acquire(100, 0)
    assert again is st and again.text == ""  # reset on reuse
    pool.release(again)
    other = pool.acquire(50, 1)  # evicts the idle session of another shape
    assert other is not st and other.chunk_frames == 50 and other.lookahead_chunks == 1


def test_micro_batcher_coalesces_and_matches(models):
    port_model, dec = models[3], models[4]
    tr = Transcriber(port_model, dec)
    mb = tserve.MicroBatcher(tr, max_batch=8, window_ms=200.0)
    try:
        audios = [_audio(16000, 50 + i) for i in range(6)]
        results = [f.result(timeout=120) for f in [mb.submit(a) for a in audios]]
    finally:
        mb.close()
    assert [r["text"] for r in results] == [tr.transcribe_array(a)["text"] for a in audios]
    assert mb.requests == 6 and mb.calls <= 3


def test_serve_entry_point(tmp_path):
    """python -m velocity_asr_tpu_torch.serve answers /health and one
    /transcribe on the committed checkpoint with the JAX package's text."""
    tsynth.write_corpus(str(tmp_path), 1, split="test", seed=1234)
    with open(tmp_path / "test_00000.wav", "rb") as f:
        body = f.read()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen([sys.executable, "-m", "velocity_asr_tpu_torch.serve",
                             "--checkpoint", CKPT, "--device", "cpu", "--port", str(port)],
                            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                status, out = _request(port, "GET", "/health")
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.2)
        assert status == 200 and json.loads(out)["model"]["device"] == "cpu"
        status, out = _request(port, "POST", "/transcribe", body)
        with open("checkpoints/synth_run/eval_fp32_final.json") as f:
            want = json.load(f)["results"][0]["prediction"]
        assert status == 200 and json.loads(out)["text"] == want
    finally:
        proc.terminate()
        proc.wait(timeout=30)


# ------------------------------------------------------------ threads


def _stress(n_threads, fn):
    """Run fn(i) in n_threads threads with a short switch interval."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    errors = []

    def run(i):
        try:
            fn(i)
        except Exception as e:  # surfaced below
            errors.append(e)

    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors


def test_launch_counts_from_many_threads(monkeypatch):
    """The server launches from several threads at once: no count is lost."""
    from velocity_asr_tpu_torch.ops import cuda_lib

    class _Lib:
        @staticmethod
        def scan_fwd_state_f32(*args):
            return 0

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream())
    kl = object.__new__(cuda_lib.KernelLibrary)
    kl.lib = _Lib()
    before = cuda_lib.launch_counts["scan_fwd_state_f32"]
    _stress(16, lambda i: [kl.launch("scan_fwd_state_f32") for _ in range(500)])
    assert cuda_lib.launch_counts["scan_fwd_state_f32"] == before + 16 * 500
    cuda_lib.launch_counts.subtract({"scan_fwd_state_f32": 16 * 500})
    if not cuda_lib.launch_counts["scan_fwd_state_f32"]:
        del cuda_lib.launch_counts["scan_fwd_state_f32"]


def test_stream_budget_under_contention(models):
    """Many threads opening and releasing sessions of three shapes at once
    never hold more than --max-streams, and the budget returns to 0."""
    port_model, dec = models[3], models[4]
    svc = tserve.ASRService(Transcriber(port_model, dec), max_streams=2)
    lock = threading.Lock()
    held, peak, busy = [0], [0], [0]

    def churn(i):
        for j in range(20):
            try:
                st = svc.open_stream(2.0, (i + j) % 3, 0)
            except tserve.ServiceBusy:
                with lock:
                    busy[0] += 1
                continue
            with lock:
                held[0] += 1
                peak[0] = max(peak[0], held[0])
            with lock:
                held[0] -= 1
            svc.release_stream(st)

    try:
        _stress(12, churn)
    finally:
        svc.close()
    assert peak[0] <= 2 and svc._batched_live == 0
    assert busy[0] > 0  # the budget was contended
    assert set(svc.stream_batchers) == {(0, 0), (1, 0), (2, 0)}
