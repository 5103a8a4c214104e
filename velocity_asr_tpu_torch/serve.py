"""Serve the PyTorch port over HTTP (mirrors the JAX package's scripts/serve.py).

    python -m velocity_asr_tpu_torch.serve --checkpoint DIR [--port 8570] \
        [--max-batch 8] [--batch-window-ms 10] [--max-streams 8] \
        [--beam-width K] [--lm LM.json.gz --lm-weight 0.5] [--device cuda]

Endpoints:
  GET  /health       -> {"status": "ok", "model": {...}}
  POST /transcribe   -> {"text", "duration", "rtf"[, "words"]}
      body: an audio file (WAV, FLAC, mp3, Ogg Vorbis, m4a). ?timestamps=1
      adds word timings and confidences,
      ?beam=N decodes with the beam, ?hotwords=a,b&hotword_weight=W biases
      it toward the request's words (needs a beam). Greedy requests
      without timestamps from concurrent clients are micro-batched
      (MicroBatcher: one forward per frame bucket of the group); the rest
      run one at a time on the single-utterance path.
  POST|PUT /stream   -> NDJSON: {"text": increment[, "words"]}* then
                        {"final": true, "text", "duration", "rtf"[, "words"]}
      body: 16 kHz mono int16 PCM, or a WAV whose header declares it,
      sent chunked (or with a Content-Length); text increments are written
      back as the audio arrives. ?chunk_seconds=S (default 2.0, snapped to
      STREAM_CADENCES), ?lookahead=N, ?beam=N (with --lm the n-best is
      rescored at the end), ?timestamps=1 (the increments carry the words
      finalised so far, the final line all of them). Sessions at the
      default cadence share one StreamSessionBatcher per (lookahead, beam)
      shape, all drawing on one --max-streams budget (503 past it); other
      cadences run as pooled per-session transcribers, one at a time on
      the device.

A client's fault (an undecodable body, a bad query value) is a 400, the
stream budget a 503, anything else a 500. The JAX server's /diarize and
?identify_language need a speaker model and a language-ID head, which the
port has not taken yet: both answer 400, as the JAX server answers for a
checkpoint without them. /transcribe bodies are decoded by
io.decode_audio_file (WAV, FLAC, mp3, Ogg Vorbis, and m4a where the
system codecs are), sniffed from their first bytes.

    curl -s --data-binary @utt.wav 'localhost:8570/transcribe?timestamps=1'
    arecord -f S16_LE -r 16000 -c 1 -t raw | \\
        curl -sN -H 'Transfer-Encoding: chunked' -T - localhost:8570/stream
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import queue
import tempfile
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from .audio import HOP_LENGTH, SAMPLE_RATE, load_audio
from .hotwords import HotwordBooster
from .lm import CharNGramLM
from .streaming import (StreamingTranscriber, StreamSessionBatcher, StreamSlotsExhausted,
                        collect_group)
from .transcribe import Transcriber, load_transcriber

logger = logging.getLogger(__name__)


class BadRequest(Exception):
    """The client's fault (an undecodable body, a bad query value): 400."""


class ServiceBusy(Exception):
    """Every streaming session is in use: 503."""


class PcmDecoder:
    """Incremental 16 kHz mono int16 PCM decoder for the /stream body.

    An optional leading WAV header must declare exactly that format (PCM16,
    mono, the sample rate); the odd byte of a block carries to the next.
    """

    _MAX_HEADER = 65536

    def __init__(self, sample_rate: int):
        self.sample_rate = sample_rate
        self._buf = b""
        self._header_checked = False

    def _parse_wav_header(self) -> Optional[int]:
        """The offset of the 'data' chunk's payload, or None while more
        bytes are needed; BadRequest for any other format."""
        buf = self._buf
        if len(buf) < 12:
            return None
        if buf[8:12] != b"WAVE":
            raise BadRequest("RIFF body is not a WAV file")
        pos, fmt_ok = 12, False
        while True:
            if len(buf) < pos + 8:
                return None
            cid = buf[pos:pos + 4]
            size = int.from_bytes(buf[pos + 4:pos + 8], "little")
            if cid == b"data":
                if not fmt_ok:
                    raise BadRequest("WAV 'data' chunk precedes 'fmt '")
                return pos + 8
            if len(buf) < pos + 8 + size:
                return None
            if cid == b"fmt ":
                audio_format = int.from_bytes(buf[pos + 8:pos + 10], "little")
                channels = int.from_bytes(buf[pos + 10:pos + 12], "little")
                rate = int.from_bytes(buf[pos + 12:pos + 16], "little")
                bits = int.from_bytes(buf[pos + 22:pos + 24], "little")
                if (audio_format, channels, rate, bits) != (1, 1, self.sample_rate, 16):
                    raise BadRequest(
                        f"/stream WAV must be PCM16 mono {self.sample_rate} Hz; got "
                        f"format={audio_format} channels={channels} rate={rate} bits={bits}")
                fmt_ok = True
            pos += 8 + size + (size & 1)  # chunks are word-aligned

    def feed(self, block: bytes) -> np.ndarray:
        """Append body bytes; return the newly complete samples (fp32)."""
        self._buf += block
        if not self._header_checked:
            if len(self._buf) < 4:
                return np.zeros(0, np.float32)
            if self._buf[:4] == b"RIFF":
                data_ofs = self._parse_wav_header()
                if data_ofs is None:
                    if len(self._buf) > self._MAX_HEADER:
                        raise BadRequest("WAV header too large")
                    return np.zeros(0, np.float32)
                self._buf = self._buf[data_ofs:]
            self._header_checked = True
        n = len(self._buf) // 2
        if n == 0:
            return np.zeros(0, np.float32)
        pcm = np.frombuffer(self._buf[: 2 * n], "<i2")
        self._buf = self._buf[2 * n:]
        return pcm.astype(np.float32) / 32768.0


class StreamPool:
    """Reusable per-session transcribers for the non-default cadences,
    keyed by (chunk_frames, lookahead, beam), at most max_streams alive; a
    new shape may evict an idle session of another to make room."""

    def __init__(self, transcriber: Transcriber, max_streams: int = 2, beam_scorers=None):
        self.transcriber = transcriber
        self.max_streams = max_streams
        self.beam_scorers = beam_scorers  # [(scorer, weight)] for beam > 1
        self._cv = threading.Condition()
        self._idle: dict = {}  # key -> [StreamingTranscriber]
        self._live = 0  # sessions in existence, idle or taken

    def acquire(self, chunk_frames: int, lookahead: int, beam: int = 0,
                timeout: float = 10.0) -> StreamingTranscriber:
        key = (chunk_frames, lookahead, beam)
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                free = self._idle.get(key)
                if free:
                    st = free.pop()
                    st.reset()
                    return st
                if self._live >= self.max_streams:
                    for idle in self._idle.values():  # evict one of another shape
                        if idle:
                            idle.pop()
                            self._live -= 1
                            break
                if self._live < self.max_streams:
                    self._live += 1
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ServiceBusy(f"all {self.max_streams} streaming sessions are busy; "
                                      "retry later or raise --max-streams")
                self._cv.wait(remaining)
        try:
            return StreamingTranscriber(
                self.transcriber.model, self.transcriber.decoder, chunk_frames=chunk_frames,
                lookahead_chunks=lookahead, beam_width=beam,
                beam_scorers=self.beam_scorers if beam > 1 else None)
        except BaseException:
            with self._cv:
                self._live -= 1
                self._cv.notify()
            raise

    def release(self, st: StreamingTranscriber) -> None:
        beam = st._sbeam.beam_width if st._sbeam is not None else 0
        with self._cv:
            self._idle.setdefault((st.chunk_frames, st.lookahead_chunks, beam), []).append(st)
            self._cv.notify()


class MicroBatcher:
    """Coalesces concurrent greedy requests into one batched call.

    Requests that arrive within window_ms of a group's first (at most
    max_batch) run through Transcriber.transcribe_batch on one thread.
    ``calls`` and ``requests`` count the batched calls and the requests
    they served.
    """

    def __init__(self, transcriber: Transcriber, max_batch: int = 8, window_ms: float = 10.0):
        self.transcriber = transcriber
        self.max_batch = max_batch
        self.window = window_ms / 1e3
        self.calls = self.requests = 0
        self.q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="micro-batcher")
        self._thread.start()

    def submit(self, audio: np.ndarray) -> Future:
        fut: Future = Future()
        self.q.put((audio, fut))
        return fut

    def close(self) -> None:
        """Stop the thread once the queued requests are served."""
        self.q.put(None)
        self._thread.join()

    def _loop(self) -> None:
        while True:
            group, stop = collect_group(self.q, self.window, self.max_batch)
            if not group:
                return
            try:
                # grouped by frame bucket inside: a short clip is not padded
                # to a longer one's bucket
                results = self.transcriber.transcribe_batch([a for a, _ in group])
                self.calls += 1
                self.requests += len(group)
                for (_, f), r in zip(group, results):
                    f.set_result(r)
            except Exception as e:
                for _, f in group:
                    if not f.done():
                        f.set_exception(e)
            if stop:
                return


class ASRService:
    """A transcriber, its micro-batcher and its streaming sessions."""

    #: allowed /stream cadences (seconds): ?chunk_seconds snaps to the
    #: nearest, which bounds the session shapes a client can ask for
    STREAM_CADENCES = (0.5, 1.0, 2.0, 4.0, 8.0, 15.0, 30.0)
    #: the cadence whose sessions share a StreamSessionBatcher (seconds)
    STREAM_DEFAULT_CADENCE = 2.0

    def __init__(self, transcriber: Transcriber, max_batch: int = 8,
                 batch_window_ms: float = 10.0, max_streams: int = 2,
                 lm: Optional[CharNGramLM] = None, lm_weight: float = 0.5):
        self.transcriber = transcriber
        self.model = transcriber.model
        self.decoder = transcriber.decoder
        self.lock = threading.Lock()  # the single-utterance and pooled paths
        self.lm = lm  # shallow fusion on /stream ?beam requests
        self.lm_weight = lm_weight
        self.batcher = MicroBatcher(transcriber, max_batch=max_batch,
                                    window_ms=batch_window_ms)
        self.stream_pool = StreamPool(transcriber, max_streams=max_streams,
                                      beam_scorers=[(lm, lm_weight)] if lm else None)
        # default-cadence sessions: one batcher per (lookahead, beam), built
        # on first use; all of them share one budget of max_streams
        self.stream_batchers: dict = {}
        self._stream_batcher_slots = max_streams
        self._batched_live = 0
        self._batcher_lock = threading.Lock()

    @classmethod
    def from_checkpoint(cls, checkpoint: str, device="cuda", beam_width: int = 0,
                        lm_path: Optional[str] = None, lm_weight: float = 0.5,
                        **kw) -> "ASRService":
        transcriber = load_transcriber(checkpoint, device=device)
        transcriber.beam_width = beam_width
        lm = None
        if lm_path:
            lm = CharNGramLM.load(lm_path)
            logger.info("LM loaded: order-%d char n-gram, weight %.2f", lm.order, lm_weight)
        return cls(transcriber, lm=lm, lm_weight=lm_weight, **kw)

    def close(self) -> None:
        """Stop the batching threads."""
        self.batcher.close()
        for b in self.stream_batchers.values():
            b.close()

    @staticmethod
    def _decode_body(data: bytes) -> np.ndarray:
        """Decode an uploaded body; one that cannot be decoded is a 400."""
        with tempfile.NamedTemporaryFile(suffix=".audio", delete=False) as f:
            f.write(data)
            path = f.name
        try:
            return load_audio(path)
        except (ValueError, RuntimeError) as e:
            # the server's temp path stays out of the client's message
            msg = str(e).replace(repr(path), "request body")
            raise BadRequest(msg) from e
        finally:
            os.unlink(path)

    def open_stream(self, chunk_seconds: float, lookahead: int, beam: int = 0):
        """Check the /stream knobs and take a session: a slot of the shared
        batcher at the default cadence, a pooled transcriber otherwise."""
        if not 0.5 <= chunk_seconds <= 30.0:
            raise BadRequest("chunk_seconds must be in [0.5, 30]")
        if not 0 <= lookahead <= 4:
            raise BadRequest("lookahead must be in [0, 4]")
        if not 0 <= beam <= 16:
            raise BadRequest("beam must be in [0, 16]")
        beam = 0 if beam <= 1 else beam
        chunk_seconds = min(self.STREAM_CADENCES, key=lambda c: abs(c - chunk_seconds))
        frames = int(round(chunk_seconds * SAMPLE_RATE / HOP_LENGTH))
        frames += frames % 2  # chunks are an even number of frames
        if chunk_seconds != self.STREAM_DEFAULT_CADENCE:
            st = self.stream_pool.acquire(frames, lookahead, beam)
            st._pooled = True
            return st
        key = (lookahead, beam)
        with self._batcher_lock:
            if self._batched_live >= self._stream_batcher_slots:
                raise ServiceBusy(f"all {self._stream_batcher_slots} batched stream slots are "
                                  "in use; retry later or raise --max-streams")
            if key not in self.stream_batchers:
                self.stream_batchers[key] = StreamSessionBatcher(
                    self.model, self.decoder, chunk_frames=frames,
                    max_slots=self._stream_batcher_slots, lookahead=lookahead, beam_width=beam,
                    beam_scorers=[(self.lm, self.lm_weight)] if beam and self.lm else None)
            self._batched_live += 1
        try:
            st = self.stream_batchers[key].open()
        except BaseException as e:
            with self._batcher_lock:
                self._batched_live -= 1
            if isinstance(e, StreamSlotsExhausted):
                raise ServiceBusy(str(e)) from e
            raise
        st._pooled = False
        return st

    def release_stream(self, st) -> None:
        if st._pooled:
            self.stream_pool.release(st)
        else:
            st.close()
            with self._batcher_lock:
                self._batched_live -= 1

    def stream_feed(self, st, pcm: np.ndarray) -> str:
        if st._pooled:  # batched sessions synchronise inside their batcher
            with self.lock:
                return st.feed(pcm)
        return st.feed(pcm)

    def stream_finish(self, st) -> str:
        if st._pooled:
            with self.lock:
                return st.finish()
        return st.finish()

    def transcribe_bytes(self, data: bytes, timestamps: bool, beam: int, hotwords: str = "",
                         hotword_weight: float = 2.0, identify_language: bool = False) -> dict:
        if identify_language:
            raise BadRequest("?identify_language needs a model with a LID head (trained with "
                             "num_languages > 0)")
        eff_beam = beam if beam > 0 else self.transcriber.beam_width
        booster = None
        if hotwords:
            if eff_beam <= 1:
                raise BadRequest("?hotwords biases the beam search; add ?beam=N (N > 1)")
            try:
                booster = HotwordBooster(hotwords.split(","), self.decoder.token_to_idx)
            except ValueError as e:
                raise BadRequest(str(e)) from e
        audio = self._decode_body(data)
        t0 = time.perf_counter()
        if timestamps or eff_beam > 1:
            # the request's beam and booster are arguments, never written
            # into the shared transcriber
            with self.lock:
                result = self.transcriber.transcribe_array(
                    audio, timestamps=timestamps, beam_width=eff_beam, lm_scorer=booster,
                    lm_weight=hotword_weight if booster else None)
        else:
            result = self.batcher.submit(audio).result()
        result["rtf"] = (time.perf_counter() - t0) / max(result["duration"], 1e-9)
        return result


def _flag(q: dict, name: str) -> bool:
    return q.get(name, ["0"])[0] in ("1", "true")


def make_handler(service: ASRService):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1: chunked uploads and keep-alive /transcribe clients;
        # every response sets Content-Length or (/stream) Connection: close
        protocol_version = "HTTP/1.1"
        # a stalled upload times out, so its session is released
        timeout = 120

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if code != 200:
                # an error may answer before the body is read: unread bytes
                # must not parse as the next request
                self.send_header("Connection", "close")
                self.close_connection = True
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path == "/health":
                cfg = service.model.config
                self._send(200, {"status": "ok", "model": {
                    "d_model": cfg.d_model, "vocab_size": cfg.vocab_size,
                    "scan_mode": cfg.scan_mode, "dtype": cfg.dtype,
                    "device": str(service.transcriber.device)}})
            else:
                self._send(404, {"error": "unknown endpoint"})

        def _iter_body(self, max_block: int = 32768):
            """Request-body blocks as they arrive: chunked transfer encoding
            or Content-Length."""
            if "chunked" in (self.headers.get("Transfer-Encoding") or "").lower():
                while True:
                    line = self.rfile.readline(1024).strip()
                    if not line:
                        raise BadRequest("malformed chunked encoding")
                    try:
                        size = int(line.split(b";")[0], 16)
                    except ValueError as e:
                        raise BadRequest("malformed chunk size") from e
                    if size == 0:
                        while self.rfile.readline(1024).strip():
                            pass  # trailers, up to the blank line
                        return
                    remaining = size
                    while remaining:
                        block = self.rfile.read1(min(remaining, max_block))
                        if not block:
                            raise BadRequest("truncated chunk")
                        remaining -= len(block)
                        yield block
                    self.rfile.read(2)  # the chunk's CRLF
            else:
                try:
                    remaining = int(self.headers.get("Content-Length", 0))
                except ValueError as e:
                    raise BadRequest("malformed Content-Length") from e
                if remaining <= 0:
                    raise BadRequest("empty body (send Content-Length or "
                                     "Transfer-Encoding: chunked)")
                while remaining:
                    block = self.rfile.read1(min(remaining, max_block))
                    if not block:
                        raise BadRequest("truncated body")
                    remaining -= len(block)
                    yield block

        def _do_stream(self, parsed):
            q = parse_qs(parsed.query)
            try:
                try:
                    chunk_seconds = float(q.get("chunk_seconds", ["2.0"])[0])
                    lookahead = int(q.get("lookahead", ["0"])[0])
                    beam = int(q.get("beam", ["0"])[0])
                except ValueError as e:
                    raise BadRequest(f"invalid query value: {e}") from e
                timestamps = _flag(q, "timestamps")
                st = service.open_stream(chunk_seconds, lookahead, beam)
            except BadRequest as e:
                self._send(400, {"error": str(e)})
                return
            except ServiceBusy as e:
                self._send(503, {"error": str(e)})
                return
            except Exception:
                logger.exception("stream setup failed")
                self._send(500, {"error": "internal failure"})
                return

            def line(payload: dict) -> None:
                self.wfile.write((json.dumps(payload) + "\n").encode())
                self.wfile.flush()

            def emit(inc: str, flush: bool = False) -> None:
                payload = {"text": inc} if inc else {}
                if timestamps:
                    words = st.take_new_words(flush=flush)
                    if words:
                        payload["words"] = words
                if payload:
                    line(payload)

            dec = PcmDecoder(SAMPLE_RATE)
            samples = 0
            t0 = time.perf_counter()
            try:
                # past the acquire, everything is under this try: a client
                # that vanishes mid-headers must not keep the session
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Cache-Control", "no-store")
                self.send_header("Connection", "close")
                self.end_headers()
                self.close_connection = True
                for block in self._iter_body():
                    pcm = dec.feed(block)
                    if pcm.size:
                        samples += pcm.size
                        emit(service.stream_feed(st, pcm))
                emit(service.stream_finish(st), flush=True)
                duration = samples / SAMPLE_RATE
                final = {"final": True, "text": st.text, "duration": duration,
                         "rtf": (time.perf_counter() - t0) / max(duration, 1e-9)}
                if timestamps:
                    final["words"] = st.words()
                line(final)
            except BadRequest as e:
                # the headers are out: the error rides the NDJSON stream
                logger.warning("bad stream request: %s", e)
                line({"error": str(e)})
            except (BrokenPipeError, ConnectionResetError):
                logger.info("stream client disconnected")
            except Exception:
                logger.exception("stream failed")
                try:
                    line({"error": "internal failure"})
                except OSError:
                    pass
            finally:
                service.release_stream(st)

        def do_PUT(self):
            # `curl -T -` uploads with PUT; /stream takes both verbs
            parsed = urlparse(self.path)
            if parsed.path != "/stream":
                self._send(404, {"error": "unknown endpoint"})
                return
            self._do_stream(parsed)

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path not in ("/transcribe", "/diarize", "/stream"):
                self._send(404, {"error": "unknown endpoint"})
                return
            if parsed.path == "/stream":
                self._do_stream(parsed)  # incremental; never buffers the upload
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0:
                    self._send(400, {"error": "empty body"})
                    return
                data = self.rfile.read(length)
                if parsed.path == "/diarize":
                    raise BadRequest("this server has no speaker model: /diarize is not ported "
                                     "yet (ROADMAP module item 8)")
                q = parse_qs(parsed.query)
                try:
                    beam = int(q.get("beam", ["0"])[0])
                    hotword_weight = float(q.get("hotword_weight", ["2.0"])[0])
                except ValueError as e:
                    raise BadRequest(f"invalid query value: {e}") from e
                self._send(200, service.transcribe_bytes(
                    data, _flag(q, "timestamps"), beam, hotwords=q.get("hotwords", [""])[0],
                    hotword_weight=hotword_weight,
                    identify_language=_flag(q, "identify_language")))
            except BadRequest as e:
                logger.warning("bad request: %s", e)
                self._send(400, {"error": str(e)})
            except Exception:  # request isolation: the server's fault
                logger.exception("request failed")
                self._send(500, {"error": "internal failure"})

        def log_message(self, fmt, *args):
            logger.info("%s - %s", self.address_string(), fmt % args)

    return Handler


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Serve the PyTorch port over HTTP")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8570)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--beam-width", type=int, default=0)
    parser.add_argument("--max-batch", type=int, default=8,
                        help="micro-batch size cap for concurrent requests")
    parser.add_argument("--batch-window-ms", type=float, default=10.0,
                        help="how long to wait to coalesce concurrent requests")
    parser.add_argument("--max-streams", type=int, default=8,
                        help="/stream budget (503 past it): default-cadence sessions of "
                             "every shape share this many slots, and other cadences draw on a "
                             "pool of the same size (run one at a time on the device), so up "
                             "to twice this many sessions can be live at once")
    parser.add_argument("--lm", default=None,
                        help="character n-gram LM (a train_lm artifact) for shallow fusion "
                             "on /stream ?beam requests")
    parser.add_argument("--lm-weight", type=float, default=0.5)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(levelname)s | %(message)s")

    service = ASRService.from_checkpoint(
        args.checkpoint, device=args.device, beam_width=args.beam_width,
        lm_path=args.lm, lm_weight=args.lm_weight, max_batch=args.max_batch,
        batch_window_ms=args.batch_window_ms, max_streams=args.max_streams)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(service))
    logger.info("Serving on http://%s:%d (POST /transcribe, POST /stream, GET /health)",
                args.host, server.server_address[1])
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
