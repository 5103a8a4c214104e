"""Chunked streaming transcription (mirrors velocity_asr_tpu/streaming.py).

    st = StreamingTranscriber(model, decoder)
    for block in audio_blocks:
        print(st.feed(block), end="")
    print(st.finish())

- The SSM recurrence and every causal conv carry state across chunks,
  so the local acoustic path is exact chunked evaluation (the scan's
  carried-state kernel, ``ops/scan.py`` ``scan_fwd_state``).
- The global context runs its SSM incrementally over each chunk's
  summary tokens and attends over a rolling memory of the last
  ``stream_memory_chunks`` chunks (``models/attention.py``).
- The mel front end is incremental and on the host (``StreamingMel``,
  numpy, as in the JAX package). Chunk c is normalised with the
  statistics of raw frames [0, chunk c's end): the output depends only on
  the audio and the chunk length, never on how the samples were fed.
- Greedy CTC decoding carries its collapse state across chunks. With
  ``beam_width`` > 1 each chunk's logits advance a carried prefix beam on
  the device instead (``beam.StreamingBeam``); the live transcriber
  emits the beams' common prefix every chunk and picks the best suffix
  at finish, rescored by ``beam_scorers`` (LM, hot words).
- ``lookahead_chunks`` > 0 emits each chunk that many chunks late,
  re-decoded with the statistics and global memory available by then
  (the model's ``frozen_mem`` pass).

- ``words()`` and ``take_new_words()`` give word timestamps and
  confidences: the greedy collapse keeps each token's absolute frame
  span and log posteriors, the beam its in-beam span tracks.

``BatchedStreamingTranscriber`` runs a batch of utterances through the
same chunk step for evaluation, with the same results per utterance.
``StreamSessionBatcher`` runs independent live sessions (the server's
/stream) through one shared step: their carried states are the rows of
one stacked state on the device, each row at its own time offset.
``streaming_forward`` is the training graph of the same step: a whole
utterance's logits computed chunk by chunk through the carried state,
differentiable (the streaming-aware objective, ``training.Trainer``).
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional

import numpy as np
import torch

from .audio import HOP_LENGTH, N_FFT, N_MELS, SAMPLE_RATE, hann_window, mel_filterbank
from .beam import (StreamingBeam, beam_commit, beam_finalize_full, beam_state_init, commit_row,
                   ctc_beam_resume, finalize_pick)
from .decode import BLANK_TOKEN, CTCDecoder, words_with_timestamps
from .models.model import VelocityASR, init_stream_state

__all__ = ["BatchedStreamSession", "BatchedStreamingTranscriber", "StreamSessionBatcher",
           "StreamSlotsExhausted", "StreamingMel", "StreamingTranscriber", "init_stream_state",
           "streaming_forward"]

logger = logging.getLogger(__name__)


class StreamingMel:
    """Incremental log-mel extraction.

    Matches the offline front end except for the normalisation
    statistics, which are cumulative-causal rather than whole-utterance.
    The initial reflect padding is reproduced once enough samples arrive;
    the final reflect-padded frames are emitted by finish().

    Memory is bounded for arbitrarily long sessions: raw samples are kept
    only as the short head (to build the front reflect pad), the
    pad+1-sample tail (for finish()'s back pad), and the not-yet-framed
    window of the padded signal; normalisation uses running sums. The raw
    log-mel history (needed only by the lookahead re-decode) is kept
    until the consumer calls trim_raw_mel().
    """

    def __init__(self, n_fft: int = N_FFT, hop: int = HOP_LENGTH, n_mels: int = N_MELS,
                 sample_rate: int = SAMPLE_RATE, normalize: bool = True):
        self.n_fft = n_fft
        self.hop = hop
        self.pad = n_fft // 2
        self.normalize = normalize
        self.window = hann_window(n_fft)
        self.fb = mel_filterbank(n_fft, n_mels, sample_rate)
        self._raw_len = 0  # total samples fed
        self._head = np.zeros(0, np.float32)  # first <= pad+1 samples
        self._tail = np.zeros(0, np.float32)  # last <= pad+1 samples
        # rolling window of the front-padded signal; _padded_start is the
        # absolute (padded-coordinate) sample index of _padded[0]
        self._padded: Optional[np.ndarray] = None
        self._padded_start = 0
        self._next_frame = 0
        # running normalisation statistics per mel bin
        self._count = 0
        self._sum = np.zeros(n_mels, np.float64)
        self._sumsq = np.zeros(n_mels, np.float64)
        # statistics of raw frames dropped by trim_raw_mel, so stats_at()
        # stays exact after the history is trimmed
        self._trim_count = 0
        self._trim_sum = np.zeros(n_mels, np.float64)
        self._trim_sumsq = np.zeros(n_mels, np.float64)
        # un-normalised log-mel of frames [_raw_mel_start, ...), so the
        # lookahead re-decode can re-normalise an older chunk with later
        # statistics
        self._raw_mel = np.zeros((0, n_mels), np.float32)
        self._raw_mel_start = 0

    def _frames_available(self, total_padded: int) -> int:
        if total_padded < self.n_fft:
            return 0
        return 1 + (total_padded - self.n_fft) // self.hop

    def _extract(self, signal: np.ndarray, start: int, count: int) -> np.ndarray:
        """Frame and mel of `count` frames from absolute frame `start`;
        `signal` starts at padded sample _padded_start."""
        idx = (
            (start + np.arange(count))[:, None] * self.hop
            + np.arange(self.n_fft)[None, :]
            - self._padded_start
        )
        frames = signal[idx] * self.window
        spec = np.fft.rfft(frames, n=self.n_fft, axis=-1)
        power = (spec.real**2 + spec.imag**2).astype(np.float32)
        mel = np.log(power @ self.fb.T + 1e-10).astype(np.float32)
        self._raw_mel = np.concatenate([self._raw_mel, mel])
        if self.normalize:
            self._count += mel.shape[0]
            self._sum += mel.sum(axis=0, dtype=np.float64)
            self._sumsq += (mel.astype(np.float64) ** 2).sum(axis=0)
            mel = self.apply_stats(mel)
        return mel

    def current_stats(self):
        """(mean, std) of the running per-bin statistics (fp32)."""
        count = max(self._count, 1)
        mean = self._sum / count
        if self._count > 1:
            var = (self._sumsq - count * mean**2) / (count - 1)
            std = np.sqrt(np.maximum(var, 0.0))
        else:
            std = np.zeros_like(mean)
        return mean.astype(np.float32), std.astype(np.float32)

    def apply_stats(self, raw_mel: np.ndarray) -> np.ndarray:
        """Normalise raw log-mel frames with the current running statistics."""
        mean, std = self.current_stats()
        return ((raw_mel - mean) / (std + 1e-10)).astype(np.float32)

    @property
    def frames_extracted(self) -> int:
        """Mel frames extracted so far (feed and finish)."""
        return self._next_frame

    def stats_at(self, k: int):
        """(mean, std) over raw frames [0, k): unbiased std, fp32. k past the
        frames extracted is clamped; trimmed frames count through the
        running sums."""
        k = min(k, self._raw_mel_start + self._raw_mel.shape[0])
        if k < self._raw_mel_start:
            raise ValueError(f"stats_at({k}): raw frames before {self._raw_mel_start} "
                             "were trimmed")
        part = self._raw_mel[: k - self._raw_mel_start].astype(np.float64)
        count = self._trim_count + part.shape[0]
        s = self._trim_sum + part.sum(axis=0)
        s2 = self._trim_sumsq + (part**2).sum(axis=0)
        c = max(count, 1)
        mean = s / c
        if count > 1:
            var = (s2 - c * mean**2) / (c - 1)
            std = np.sqrt(np.maximum(var, 0.0))
        else:
            std = np.zeros_like(mean)
        return mean.astype(np.float32), std.astype(np.float32)

    def normalize_span(self, start: int, count: int, upto: int) -> np.ndarray:
        """Frames [start, start+count) normalised with stats_at(upto): a
        frame of chunk c uses the statistics over [0, chunk c's end)."""
        mean, std = self.stats_at(upto)
        return ((self.raw_frames(start, count) - mean) / (std + 1e-10)).astype(np.float32)

    def raw_frames(self, start: int, count: int) -> np.ndarray:
        """Un-normalised log-mel of frames [start, start+count)."""
        if start < self._raw_mel_start:
            raise ValueError(f"raw mel frames before {self._raw_mel_start} were trimmed")
        lo = start - self._raw_mel_start
        return self._raw_mel[lo : lo + count]

    def trim_raw_mel(self, before_frame: int) -> None:
        """Drop the raw log-mel history before `before_frame` (a live
        session only re-decodes its lookahead window)."""
        drop = before_frame - self._raw_mel_start
        if drop > 0:
            dropped = self._raw_mel[:drop].astype(np.float64)
            self._trim_count += dropped.shape[0]
            self._trim_sum += dropped.sum(axis=0)
            self._trim_sumsq += (dropped**2).sum(axis=0)
            self._raw_mel = self._raw_mel[drop:]
            self._raw_mel_start = before_frame

    def _drop_consumed(self) -> None:
        """Drop padded-signal samples before the next frame's window."""
        keep_from = self._next_frame * self.hop - self._padded_start
        if keep_from > 0:
            self._padded = self._padded[keep_from:]
            self._padded_start += keep_from

    def feed(self, samples: np.ndarray) -> np.ndarray:
        """Append samples; return the newly available mel frames (m, n_mels)."""
        samples = np.asarray(samples, np.float32)
        self._raw_len += len(samples)
        if len(samples) >= self.pad + 1:
            self._tail = samples[-(self.pad + 1) :]
        else:
            self._tail = np.concatenate([self._tail, samples])[-(self.pad + 1) :]
        if self._padded is None:
            self._head = np.concatenate([self._head, samples])
            if self._raw_len <= self.pad:
                return np.zeros((0, self.fb.shape[0]), np.float32)
            front = self._head[1 : self.pad + 1][::-1]  # reflect
            self._padded = np.concatenate([front, self._head])
            self._head = self._head[: self.pad + 1]
        else:
            self._padded = np.concatenate([self._padded, samples])
        total = self._frames_available(self.pad + self._raw_len)
        count = total - self._next_frame
        if count <= 0:
            return np.zeros((0, self.fb.shape[0]), np.float32)
        mel = self._extract(self._padded, self._next_frame, count)
        self._next_frame = total
        self._drop_consumed()
        return mel

    def finish(self) -> np.ndarray:
        """Emit the trailing frames that need the right reflect padding."""
        if self._raw_len == 0:
            return np.zeros((0, self.fb.shape[0]), np.float32)
        if self._padded is None:
            # Short utterance (no frame yet): the offline reflect padding,
            # repeated reflection included.
            self._padded = np.pad(self._head, (self.pad, 0), mode="reflect")
        if self._raw_len < 2:
            # repeated reflection of a single sample is that sample
            back = np.full(self.pad, self._tail[-1], np.float32)
        elif self._raw_len > self.pad:
            back = self._tail[-(self.pad + 1) : -1][::-1]  # single reflection
        else:
            back = np.pad(self._tail, (0, self.pad), mode="reflect")[-self.pad :]
        signal = np.concatenate([self._padded, back.astype(np.float32)])
        total = 1 + self._raw_len // self.hop  # the offline frame count
        count = total - self._next_frame
        if count <= 0:
            return np.zeros((0, self.fb.shape[0]), np.float32)
        mel = self._extract(signal, self._next_frame, count)
        self._next_frame = total
        return mel


def _model_device(model: VelocityASR) -> torch.device:
    return next(model.parameters()).device


def streaming_forward(model: VelocityASR, mel: torch.Tensor, chunk_frames: int,
                      rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """Full-utterance logits computed by the streaming path: the model's
    chunk step over mel's time axis, from ``init_stream_state``, chunk c
    at time offset c * chunk_frames // 2, the carried state handed on.

    The training-side counterpart of the transcribers (the JAX package's
    ``streaming.streaming_forward``, a lax.scan there, a Python loop
    here): under autograd the gradient flows through every carried leaf,
    so CTC on these logits trains the model under the conditions the
    streaming runtime evaluates under. In training mode the dropout masks
    of every chunk come from `rng`. mel (batch, t, mel_bins) with t a
    multiple of chunk_frames (the collator's frame bucket makes it one);
    returns fp32 (batch, t // 2, vocab).
    """
    b, t, _ = mel.shape
    assert t % chunk_frames == 0, (t, chunk_frames)
    state = init_stream_state(model.config, b, mel.device)
    logits = []
    for c in range(t // chunk_frames):
        out, state = model(mel[:, c * chunk_frames:(c + 1) * chunk_frames], stream_state=state,
                           time_offset=c * chunk_frames // 2, return_state=True, rng=rng)
        logits.append(out)
    return torch.cat(logits, dim=1)


class StreamingTranscriber:
    """Live chunked transcription with carried model state.

    feed(samples) returns the newly finalised text; finish() flushes the
    trailing audio. Chunks are ``chunk_frames`` mel frames (even; 200 =
    2 s); the final partial chunk is zero-padded and only its valid
    output frames are decoded.

    lookahead_chunks (default 0): delay each chunk's emission by N chunks
    and re-decode it with its mel re-normalised by the statistics
    available N chunks later and the global memory that by then holds
    the N later chunks' summaries (the model's frozen_mem pass), from the
    chunk's own entry local state. The advancing steps, and so the
    carried state, are those of lookahead 0.

    beam_width > 1: each chunk's logits (the emit pass's under lookahead)
    advance a carried beam on the model's device, and the beams' common
    prefix is committed as final text after every chunk; finish() picks
    the best suffix among the live beams, rescored over the full n-best
    by beam_scorers [(scorer, weight)]. beam_cap is the prefix buffer's
    capacity in uncommitted tokens; past it the transcript is truncated
    and finish() warns.

    words() gives the word timestamps and confidences of everything
    decoded so far, take_new_words() the words finalised since its last
    call: the greedy collapse keeps each token's absolute frame span and
    summed log posterior, the beam its in-beam span tracks.
    """

    def __init__(self, model: VelocityASR, decoder: CTCDecoder, chunk_frames: int = 200,
                 lookahead_chunks: int = 0, beam_width: int = 0, beam_scorers=None,
                 beam_cap: int = 256):
        if chunk_frames % 2:
            raise ValueError(f"chunk_frames must be even, got {chunk_frames}")
        self.model = model.eval()
        self.decoder = decoder
        self.chunk_frames = chunk_frames
        self.lookahead_chunks = lookahead_chunks
        self.device = _model_device(model)
        self._sbeam = None
        if beam_width and beam_width > 1:
            self._sbeam = StreamingBeam(1, beam_width, cap=beam_cap,
                                        blank_token=decoder.blank_token,
                                        scorers=beam_scorers, device=self.device)
        self.reset()

    def reset(self) -> None:
        """Start a new session."""
        # normalize=False: chunks are normalised at decode time with the
        # chunk-quantised statistics (normalize_span)
        self.mel = StreamingMel(normalize=False)
        self._state: Optional[dict] = None
        self._time_offset = 0
        self._frame_cursor = 0  # absolute mel frame of the next chunk
        self._pending: List[dict] = []
        self._prev_token = BLANK_TOKEN
        self._tokens: List[int] = []
        # (start, end) absolute output frames of every emitted token (the
        # rule of decode.timestamps_from_predictions: end is the first
        # frame whose prediction changes; -1 while the greedy token's run
        # is open at the newest decoded frame), and [lp_sum, n_frames] of
        # its log posteriors
        self._stamps: List[List[int]] = []
        self._stamp_lp: List[list] = []
        self._decoded_frames = 0  # absolute output frames decoded so far
        self._words_emitted = 0
        self._emitted_text = ""
        self._beam_finalized = False
        if self._sbeam is not None:
            self._sbeam.reset()

    def _init_state(self) -> dict:
        return init_stream_state(self.model.config, 1, self.device)

    @torch.inference_mode()
    def _forward(self, chunk: np.ndarray, state: dict, offset: int, frozen: bool = False):
        """One chunk step: ((preds, frame_lp, logits), new state). Greedy:
        the per-frame argmax and its log posterior on the host, logits
        None; beam: (None, None, the (1, frames, vocab) logits left on the
        device for the beam)."""
        mel = torch.from_numpy(np.ascontiguousarray(chunk[None])).to(self.device)
        logits, new_state = self.model(mel, stream_state=state, time_offset=offset,
                                       return_state=True, frozen_mem=frozen)
        if self._sbeam is not None:
            return (None, None, logits), new_state
        return _frame_preds(logits[0]), new_state

    def _advance_chunk(self, chunk: np.ndarray, offset: int, valid: Optional[int] = None):
        """Run one (chunk_frames, mels) chunk through the advancing step,
        replacing the carried state; returns (preds, frame_lp, logits) as
        _forward. `valid` is the chunk's real frames (fewer than
        chunk_frames only on the final flush): a shared batched step
        needs it inside its device call, this one does not."""
        if self._state is None:
            self._state = self._init_state()
        out, self._state = self._forward(chunk, self._state, offset)
        return out

    def _consume(self, out, out_valid: int, base: int) -> None:
        """Decode one chunk's first out_valid output frames; `out` is
        (preds, frame_lp, logits) and `base` its first absolute output
        frame."""
        preds, frame_lp, logits = out
        if self._sbeam is not None:
            self._consume_beam(logits, out_valid, base)
        else:
            self._decode_tokens(preds[:out_valid], frame_lp[:out_valid], base)

    @torch.inference_mode()
    def _decode_logits(self, logits: torch.Tensor, out_valid: int, base: int) -> None:
        """Decode one chunk's (1, frames, vocab) logits, as _consume."""
        if self._sbeam is not None:
            self._consume_beam(logits, out_valid, base)
        else:
            self._decode_tokens(*_frame_preds(logits[0, :out_valid])[:2], base)

    def _consume_beam(self, logits: torch.Tensor, out_valid: int, base: int) -> None:
        """Advance the carried beam over one chunk's logits and commit the
        beams' common prefix as final tokens; `base` makes the in-beam
        spans absolute."""
        self._sbeam.update(logits, out_valid, frame_base=base)
        self._apply_beam_commit(self._sbeam.commit()[0])

    def _apply_beam_commit(self, info: dict) -> None:
        """Fold one commit's tokens, frame spans and posteriors into the
        transcriber's tracks."""
        tail = info.get("tail")
        if tail and self._stamps:
            # frames that extended the previously committed token's run
            end, lp, n = tail
            self._stamps[-1][1] = max(self._stamps[-1][1], end)
            self._stamp_lp[-1][0] += lp
            self._stamp_lp[-1][1] += n
            self._decoded_frames = max(self._decoded_frames, end)
        self._tokens.extend(info["tokens"])
        for (s, e), lp in zip(info["stamps"], info["lp"]):
            self._stamps.append([s, e])
            self._stamp_lp.append(list(lp))
            self._decoded_frames = max(self._decoded_frames, e)

    def _finalize_beam(self) -> None:
        """The best suffix among the live beams (rescored by beam_scorers
        over the full n-best) completes the transcript; its spans extend
        the committed ones."""
        fin = self._sbeam.finalize_full()[0]
        self._tokens = fin["tokens"]
        for (s, e), lp in zip(fin["suffix_stamps"], fin["suffix_lp"]):
            self._stamps.append([s, e])
            self._stamp_lp.append(list(lp))
            self._decoded_frames = max(self._decoded_frames, e)
        self._beam_finalized = True
        if self._sbeam.overflowed:
            logger.warning("streaming beam prefix buffer overflowed (cap=%d); the "
                           "transcript may be truncated: raise beam_cap", self._sbeam.cap)

    def _decode_tokens(self, preds: np.ndarray, frame_lp: np.ndarray, base: int) -> None:
        """Greedy collapse of one chunk's argmax into tokens and absolute
        frame spans (`base`: the chunk's first absolute output frame). The
        previous token carries across chunks, so a run crossing a boundary
        extends its open span instead of emitting again: frame-exact with
        decode.timestamps_from_predictions over the concatenated
        predictions."""
        for i, tok in enumerate(preds):
            tok = int(tok)
            if tok != self._prev_token:
                if self._stamps and self._stamps[-1][1] < 0:
                    self._stamps[-1][1] = base + i
                if tok != BLANK_TOKEN:
                    self._tokens.append(tok)
                    self._stamps.append([base + i, -1])
                    self._stamp_lp.append([0.0, 0])
            if tok != BLANK_TOKEN and self._stamps and self._stamps[-1][1] < 0:
                # the frame belongs to the open token's span
                self._stamp_lp[-1][0] += float(frame_lp[i])
                self._stamp_lp[-1][1] += 1
            self._prev_token = tok
        self._decoded_frames = max(self._decoded_frames, base + len(preds))

    def _pending_entry(self, valid: int) -> dict:
        """The entry (pre-advance) local state of a lookahead chunk."""
        return {
            "mel_carry": self._state["mel_carry"],
            "blocks": self._state["blocks"],
            "offset": self._time_offset,
            "valid": valid,
            "frame_start": self._frame_cursor,
        }

    def _emit_forward(self, chunk: np.ndarray, p: dict):
        """The frozen-memory re-decode of a pending chunk from its entry
        local state and the current memory; returns (preds, frame_lp,
        logits) as _advance_chunk."""
        state = {
            "mel_carry": p["mel_carry"],
            "blocks": p["blocks"],
            "gc_mem": self._state["gc_mem"],
            "gc_blocks": self._state["gc_blocks"],
            "gc_init": self._state["gc_init"],
        }
        return self._forward(chunk, state, p["offset"], frozen=True)[0]

    def _emit(self, p: dict) -> None:
        """Lookahead emission of a pending chunk: its mel re-normalised
        with the statistics at emission time (the end of the chunk whose
        advance triggered it, or the utterance's end in the flush), then a
        frozen-memory pass from its entry local state."""
        chunk = self.mel.normalize_span(p["frame_start"], p["valid"], self._frame_cursor)
        if chunk.shape[0] < self.chunk_frames:
            chunk = np.pad(chunk, ((0, self.chunk_frames - chunk.shape[0]), (0, 0)))
        self._consume(self._emit_forward(chunk, p), (p["valid"] + 1) // 2, p["offset"])

    def _run_chunks(self, flush: bool = False) -> str:
        while True:
            avail = self.mel.frames_extracted - self._frame_cursor
            if avail >= self.chunk_frames:
                valid = self.chunk_frames
            elif flush and avail > 0:
                valid = avail
            else:
                break
            chunk = self.mel.normalize_span(self._frame_cursor, valid,
                                            self._frame_cursor + valid)
            if valid < self.chunk_frames:
                # final partial chunk: zero frames pad it to the chunk length
                chunk = np.pad(chunk, ((0, self.chunk_frames - valid), (0, 0)))
            if self.lookahead_chunks > 0:
                if self._state is None:
                    self._state = self._init_state()
                self._pending.append(self._pending_entry(valid))
            out = self._advance_chunk(chunk, self._time_offset, valid)
            out_valid = (valid + 1) // 2  # odd valid only on the final flush
            self._time_offset += out_valid
            self._frame_cursor += valid
            if self.lookahead_chunks == 0:
                self._consume(out, out_valid, self._time_offset - out_valid)
            else:
                while len(self._pending) > self.lookahead_chunks:
                    self._emit(self._pending.pop(0))
        if flush:
            while self._pending:
                self._emit(self._pending.pop(0))
            if self._sbeam is not None and not self._beam_finalized:
                self._finalize_beam()
        # raw mel is only re-read for pending chunks: trim the rest
        oldest = self._pending[0]["frame_start"] if self._pending else self._frame_cursor
        self.mel.trim_raw_mel(oldest)
        text = self.decoder.tokens_to_text(self._tokens)
        new = text[len(self._emitted_text):]
        self._emitted_text = text
        return new

    def feed(self, samples: np.ndarray) -> str:
        """Feed raw audio samples; returns the newly finalised text."""
        self.mel.feed(samples)
        return self._run_chunks()

    def finish(self) -> str:
        """Flush the trailing audio and return the remaining text."""
        self.mel.finish()
        return self._run_chunks(flush=True)

    @property
    def text(self) -> str:
        return self._emitted_text

    def words(self) -> List[dict]:
        """Word timestamps and confidences of everything decoded so far,
        assembled as the offline --timestamps path assembles them
        (decode.words_with_timestamps). The last word may still grow: its
        last token's run can extend into the next chunk."""
        stamps = [(s, e if e >= 0 else self._decoded_frames) for s, e in self._stamps]
        token_lp = [lp / max(n, 1) for lp, n in self._stamp_lp]
        return words_with_timestamps(self._tokens, stamps, self.decoder.vocabulary,
                                     HOP_LENGTH, SAMPLE_RATE, token_logprobs=token_lp)

    def take_new_words(self, flush: bool = False) -> List[dict]:
        """The words finalised since the last call. A word is final once a
        later word has started; flush=True (after finish()) also releases
        the last one."""
        w = self.words()
        cut = len(w) if flush else max(len(w) - 1, self._words_emitted)
        new = w[self._words_emitted:cut]
        self._words_emitted = cut
        return new


def _frame_preds(logits: torch.Tensor):
    """(argmax, max log posterior, None) per frame of (..., frames,
    vocab) logits, on the host."""
    lsm = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return lsm.argmax(dim=-1).cpu().numpy(), lsm.amax(dim=-1).cpu().numpy(), None


class BatchedStreamingTranscriber:
    """Streaming evaluation batched across utterances.

    Runs ``batch_size`` independent streams through one chunk step (the
    carried state gains a batch axis) with the per-utterance semantics of
    StreamingTranscriber: each utterance's mel is normalised chunk by
    chunk with the statistics over raw frames [0, chunk c's end), chunks
    are zero-padded to the chunk length, and the greedy collapse is per
    stream. A group smaller than the batch runs padded with silent rows,
    and frames past an utterance's own output length are dropped, so
    neither padding changes a transcript.

    lookahead_chunks: chunk c is re-decoded (frozen-memory emit pass)
    with the memory after chunk min(c + L, last) and its mel re-normalised
    with the statistics over [0, (c + 1 + L) * chunk_frames), clamped to
    the utterance: the live transcriber's emission-time statistics.

    beam_width > 1: each chunk's logits (the emit pass's under lookahead)
    advance one carried beam per stream on the device, frames past an
    utterance's output length masked out, and each utterance's best full
    hypothesis is picked at the end, rescored by beam_scorers [(scorer,
    weight)]. Nothing is committed along the way: the prefix buffer holds
    the whole utterance.
    """

    def __init__(self, model: VelocityASR, decoder: CTCDecoder, chunk_frames: int = 200,
                 batch_size: int = 8, lookahead_chunks: int = 0, beam_width: int = 0,
                 beam_scorers=None):
        if chunk_frames % 2:
            raise ValueError(f"chunk_frames must be even, got {chunk_frames}")
        self.model = model.eval()
        self.decoder = decoder
        self.chunk_frames = chunk_frames
        self.batch_size = batch_size
        self.lookahead_chunks = lookahead_chunks
        self.beam_width = beam_width if beam_width and beam_width > 1 else 0
        self.beam_scorers = beam_scorers
        self.device = _model_device(model)

    def _causal_mel_raw(self, audio: np.ndarray):
        """(chunk-quantised causally normalised mel, raw log-mel), frame
        aligned."""
        sm = StreamingMel(normalize=False)
        raw = np.concatenate([sm.feed(audio), sm.finish()])
        F = self.chunk_frames
        if raw.shape[0] == 0:
            return raw, raw
        normed = np.concatenate([
            self._renormalize(raw, (c + 1) * F, c * F, (c + 1) * F)
            for c in range(-(-raw.shape[0] // F))
        ])
        return normed, raw

    @staticmethod
    def _renormalize(raw: np.ndarray, upto: int, lo: int = 0,
                     hi: Optional[int] = None) -> np.ndarray:
        """raw[lo:hi] normalised with the statistics over raw's first
        `upto` frames (a live stream's running statistics at emission)."""
        k = max(min(upto, raw.shape[0]), 1)
        x = raw[:k].astype(np.float64)
        mean = x.mean(axis=0)
        std = x.std(axis=0, ddof=1) if k > 1 else np.zeros_like(mean)
        seg = raw[lo:hi]
        return ((seg - mean.astype(np.float32))
                / (std.astype(np.float32) + 1e-10)).astype(np.float32)

    def transcribe_batch(self, audios: List[np.ndarray]) -> List[str]:
        """Transcribe a list of utterances; one text per input."""
        texts: List[str] = []
        for s in range(0, len(audios), self.batch_size):
            texts.extend(self._run_group(audios[s : s + self.batch_size]))
        return texts

    @torch.inference_mode()
    def _run_group(self, audios: List[np.ndarray]) -> List[str]:
        n, b, F = len(audios), self.batch_size, self.chunk_frames
        mel_raw = [self._causal_mel_raw(a) for a in audios]
        mels = [m for m, _ in mel_raw]
        out_frames = [(m.shape[0] + 1) // 2 for m in mels]
        num_chunks = -(-max(m.shape[0] for m in mels) // F)
        padded = np.zeros((b, num_chunks * F, mels[0].shape[1]), np.float32)
        for i, m in enumerate(mels):
            padded[i, : m.shape[0]] = m

        L = self.lookahead_chunks
        model, device = self.model, self.device
        state = init_stream_state(model.config, b, device)
        chunk_out = F // 2
        pending = []  # (chunk index, entry mel_carry, entry blocks)
        chunk_preds = []  # per chunk, (b, chunk_out) argmax token ids on the device
        sbeam = None
        if self.beam_width:
            # no commits: the prefix buffer holds each whole utterance (at
            # most its output frames), rounded up to a multiple of 256
            cap = -(-max(out_frames + [1]) // 256) * 256
            sbeam = StreamingBeam(b, self.beam_width, cap=cap,
                                  blank_token=self.decoder.blank_token,
                                  scorers=self.beam_scorers, device=device)
            valid_frames = np.zeros(b, np.int32)
            valid_frames[:n] = out_frames

        def step(chunk: np.ndarray, st: dict, offset: int, frozen: bool = False):
            mel = torch.from_numpy(np.ascontiguousarray(chunk)).to(device)
            logits, new_state = model(mel, stream_state=st, time_offset=offset,
                                      return_state=True, frozen_mem=frozen)
            return (logits if sbeam is not None else logits.argmax(dim=-1)), new_state

        def consume(out, c):
            if sbeam is None:
                chunk_preds.append(out)
            else:
                # frames of chunk c past an utterance's own output length
                # are padding: the valid mask keeps them out of its beam
                sbeam.update(out, np.clip(valid_frames - c * chunk_out, 0, chunk_out))

        def emit(c, mel_carry, blocks, stats_upto_chunk):
            # chunk c from its entry local state, with the current memory
            # and the statistics available at this point
            buf = np.zeros((b, F, padded.shape[2]), np.float32)
            for i, (_, raw) in enumerate(mel_raw):
                seg = self._renormalize(raw, (stats_upto_chunk + 1) * F, c * F, (c + 1) * F)
                buf[i, : seg.shape[0]] = seg
            st = {"mel_carry": mel_carry, "blocks": blocks, "gc_mem": state["gc_mem"],
                  "gc_blocks": state["gc_blocks"], "gc_init": state["gc_init"]}
            consume(step(buf, st, c * chunk_out, frozen=True)[0], c)

        for c in range(num_chunks):
            if L > 0:
                pending.append((c, state["mel_carry"], state["blocks"]))
            out_c, state = step(padded[:, c * F : (c + 1) * F], state, c * chunk_out)
            if L == 0:
                consume(out_c, c)
            elif len(pending) > L:
                emit(*pending.pop(0), stats_upto_chunk=c)
        while pending:
            emit(*pending.pop(0), stats_upto_chunk=num_chunks - 1)

        if sbeam is not None:
            best = sbeam.finalize()
            if sbeam.overflowed:
                logger.warning("streaming beam prefix buffer overflowed (cap=%d)", sbeam.cap)
            return [self.decoder.tokens_to_text(t) for t in best[:n]]

        preds = torch.cat(chunk_preds, dim=1).cpu().numpy()  # (b, num_chunks * chunk_out)
        texts = []
        for i in range(n):
            tokens, prev = [], BLANK_TOKEN
            for tok in preds[i, : out_frames[i]]:
                tok = int(tok)
                if tok != BLANK_TOKEN and tok != prev:
                    tokens.append(tok)
                prev = tok
            texts.append(self.decoder.tokens_to_text(tokens))
        return texts


class StreamSlotsExhausted(RuntimeError):
    """All StreamSessionBatcher slots are in use (capacity, not a fault)."""


def _tree_map(fn, tree, *rest):
    """fn over the tensors of a carried-state tree (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def collect_group(q: "queue.Queue", window: float, cap: int):
    """Block for q's next item, then take more until `window` seconds after
    it or `cap` items: (group, stop). A None item is the stop signal: the
    group ends there (empty if None came first) and stop is True."""
    first = q.get()
    if first is None:
        return [], True
    group = [first]
    deadline = time.perf_counter() + window
    while len(group) < cap:
        t = deadline - time.perf_counter()
        if t <= 0:
            break
        try:
            item = q.get(timeout=t)
        except queue.Empty:
            break
        if item is None:
            return group, True
        group.append(item)
    return group, False


def _keep_active(active: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """new in the active rows, old elsewhere."""
    return torch.where(active.reshape((-1,) + (1,) * (new.dim() - 1)), new.to(old.dtype), old)


class StreamSessionBatcher:
    """Independent live sessions batched through one shared chunk step.

    Every session's carried state is a row of one stacked (max_slots,
    ...) state on the model's device, owned by one dispatcher thread.
    Chunks that arrive within ``window_ms`` of each other run as one
    call, with a (max_slots,) vector of per-row absolute time offsets
    and an active mask: inactive rows' state leaves pass through by
    torch.where. Each row is independent in the step, and the host mel
    and decode are the StreamingTranscriber's, so a session's text and
    words are a dedicated transcriber's.

    lookahead > 0: the advancing call also writes each active row's entry
    (pre-advance) local state into a device ring (max_slots, lookahead +
    1, ...), and the frozen-memory re-decodes run as a second shared
    "emit" call that reads its rows back.

    beam_width > 1: the sessions' carried beams are the rows of one
    beam_state_init(max_slots, k, cap); the beam's resume (valid = 0 on
    inactive rows, each row's offset as its frame base) and commit run
    inside the shared call (the emit call under lookahead), and only the
    committed tokens go to the host. LM and hot-word rescoring stay on
    the host per session at finish.

    open() returns a BatchedStreamSession (the StreamingTranscriber API);
    its close() frees the slot. ``stats`` counts the shared calls and the
    rows they served, by kind ("step", "emit"). Every device operation
    runs in the dispatcher thread under torch.inference_mode (autograd
    state is per thread).
    """

    def __init__(self, model: VelocityASR, decoder: CTCDecoder, chunk_frames: int = 200,
                 max_slots: int = 8, window_ms: float = 5.0, lookahead: int = 0,
                 beam_width: int = 0, beam_cap: int = 256, beam_scorers=None):
        if chunk_frames % 2:
            raise ValueError(f"chunk_frames must be even, got {chunk_frames}")
        self.model = model.eval()
        self.decoder = decoder
        self.chunk_frames = chunk_frames
        self.max_slots = max_slots
        self.window = window_ms / 1e3
        self.lookahead = lookahead
        self.beam_width = beam_width if beam_width and beam_width > 1 else 0
        self.beam_cap = beam_cap
        self.beam_scorers = beam_scorers
        self.device = _model_device(model)
        self.stats = collections.Counter()
        self._init_stacked_state()
        self._failed: set = set()  # slots whose last shared call failed (dispatcher only)
        self._free = list(range(max_slots))
        self._lock = threading.Lock()
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="stream-session-batcher")
        self._thread.start()

    @torch.inference_mode()
    def _init_stacked_state(self) -> None:
        """Build the stacked carried state, the entry ring and the stacked
        beams."""
        self._states = init_stream_state(self.model.config, self.max_slots, self.device)
        self._pend = None
        if self.lookahead > 0:
            depth = self.lookahead + 1
            self._pend = _tree_map(
                lambda x: x.new_zeros((x.shape[0], depth) + x.shape[1:]),
                {"mel_carry": self._states["mel_carry"], "blocks": self._states["blocks"]})
        self._beam = self._beam_init1 = None
        if self.beam_width:
            self._beam = beam_state_init(self.max_slots, self.beam_width, self.beam_cap,
                                         self.device)
            self._beam_init1 = beam_state_init(1, self.beam_width, self.beam_cap, self.device)

    def open(self) -> "BatchedStreamSession":
        """Take a free slot, reset its rows and return its session."""
        with self._lock:
            if not self._free:
                raise StreamSlotsExhausted(f"all {self.max_slots} batched stream slots are in use")
            slot = self._free.pop()
        try:
            self._request(("reset", slot))
        except BaseException:
            self._release(slot)  # a device fault must not leak the slot
            raise
        return BatchedStreamSession(self, slot)

    def close(self) -> None:
        """Stop the dispatcher thread once the queued requests are served."""
        self._q.put(None)
        self._thread.join()

    def _release(self, slot: int) -> None:
        with self._lock:
            self._free.append(slot)

    def _request(self, item: tuple):
        """Queue (kind, slot, ...) for the dispatcher; wait for its result."""
        fut: Future = Future()
        self._q.put(item + (fut,))
        return fut.result()

    def _loop(self) -> None:
        while True:
            group, stop = collect_group(self._q, self.window, self.max_slots)
            # a slot whose earlier shared call failed answers with an error
            # until its session is reset (or the slot reopened)
            for g in group:
                if g[0] != "reset" and g[1] in self._failed:
                    g[-1].set_exception(RuntimeError(
                        "the stream session failed in an earlier shared call; reset or close it"))
            group = [g for g in group if not g[-1].done()]
            try:
                if group:
                    with torch.inference_mode():
                        self._run_group(group)
            except Exception as e:
                # Only the group's sessions fail. The other rows are intact:
                # the stacked state and beams are replaced only by a call's
                # finished result, and the in-place writes (a reset, the
                # ring) touch the group's own rows.
                logger.exception("shared stream step failed")
                for g in group:
                    if not g[-1].done():
                        self._failed.add(g[1])
                        g[-1].set_exception(e)
            if stop:
                return

    def _gather(self, reqs):
        """The group's chunks, offsets, active mask, ring slots and valid
        output frames, stacked over every slot."""
        s = self.max_slots
        chunks = np.zeros((s, self.chunk_frames, self.model.config.mel_bins), np.float32)
        offsets = np.zeros(s, np.int32)
        active = np.zeros(s, bool)
        ring = np.zeros(s, np.int64)
        out_valid = np.zeros(s, np.int32)
        for _, slot, chunk, offset, r, valid, _ in reqs:
            chunks[slot], offsets[slot], active[slot] = chunk, offset, True
            ring[slot], out_valid[slot] = r, (valid + 1) // 2
        return chunks, offsets, active, ring, out_valid

    def _run_group(self, group) -> None:
        # A session waits on each request, so a slot appears at most once
        # in a group (a step and its emit are never queued together).
        dev = self.device
        for _, slot, fut in (g for g in group if g[0] == "reset"):
            _tree_map(lambda x: x[slot].zero_(), self._states)
            if self.beam_width:
                for key, v in self._beam.items():
                    v[slot] = self._beam_init1[key][0]
            self._failed.discard(slot)
            fut.set_result(None)

        for kind in ("step", "emit"):
            reqs = [g for g in group if g[0] == kind]
            if not reqs:
                continue
            chunks, offsets, active, ring, out_valid = self._gather(reqs)
            mel = torch.from_numpy(chunks).to(dev)
            offs = torch.from_numpy(offsets).to(dev)
            act = torch.from_numpy(active).to(dev)
            ring_dev = torch.from_numpy(ring).to(dev)
            states = self._states
            if kind == "step":
                if self.lookahead > 0:
                    # each active row's entry local state into its ring slot
                    rows = act.nonzero().squeeze(1)
                    _tree_map(lambda p, leaf: p.index_put_((rows, ring_dev[rows]), leaf[rows]),
                              self._pend, {"mel_carry": states["mel_carry"],
                                           "blocks": states["blocks"]})
                logits, new = self.model(mel, stream_state=states, time_offset=offs,
                                         return_state=True)
                self._states = _tree_map(lambda n, o: _keep_active(act, n, o), new, states)
                decode = self.lookahead == 0  # under lookahead the emits decode
            else:
                entry = _tree_map(lambda p: p[torch.arange(self.max_slots, device=dev), ring_dev],
                                  self._pend)
                st = {"mel_carry": entry["mel_carry"], "blocks": entry["blocks"],
                      "gc_mem": states["gc_mem"], "gc_blocks": states["gc_blocks"],
                      "gc_init": states["gc_init"]}
                logits, _ = self.model(mel, stream_state=st, time_offset=offs,
                                       return_state=True, frozen_mem=True)
                decode = True
            self.stats[f"{kind}_calls"] += 1
            self.stats[f"{kind}_rows"] += len(reqs)
            if not decode:
                results = [None] * len(reqs)
            elif self.beam_width:
                self._beam = ctc_beam_resume(self._beam, logits, np.where(active, out_valid, 0),
                                             self.decoder.blank_token, frame_base=offsets)
                self._beam, nc, info = beam_commit(self._beam)
                nc = nc.cpu().numpy()
                info = {key: v.cpu().numpy() for key, v in info.items()}
                results = [commit_row(nc, info, g[1]) for g in reqs]
            else:
                preds, lps, _ = _frame_preds(logits)
                results = [(preds[g[1]], lps[g[1]], None) for g in reqs]
            for g, res in zip(reqs, results):
                g[-1].set_result(res)

        # after the emits: another session's emit in this group must not
        # see a row finalised under it
        for _, slot, fut in (g for g in group if g[0] == "bfinal"):
            beams, overflow = beam_finalize_full({k: v[slot:slot + 1]
                                                  for k, v in self._beam.items()})
            fut.set_result((beams[0], bool(overflow[0])))


class _SharedBeamRow:
    """The StreamingBeam face of a BatchedStreamSession's beam: its device
    state is row `slot` of the batcher's stacked beams, advanced and
    committed inside the shared call; the committed tokens, the finish's
    n-best rescoring (beam.finalize_pick) and the overflow flag live
    here."""

    def __init__(self, batcher: StreamSessionBatcher, session: "BatchedStreamSession"):
        self._session = session
        self.beam_width = batcher.beam_width
        self.cap = batcher.beam_cap
        self.scorers = batcher.beam_scorers or []
        self.reset()

    def reset(self) -> None:
        # the device row is reset by the session's reset request
        self.committed: List[List[int]] = [[]]
        self.overflowed = False

    def finalize_full(self) -> List[dict]:
        beams_full, overflow = self._session._request("bfinal")
        self.overflowed |= overflow
        return [finalize_pick(self.committed[0], beams_full, self.scorers)]


class BatchedStreamSession(StreamingTranscriber):
    """One live session whose chunk steps run in its batcher's shared
    call; the text and words of a dedicated StreamingTranscriber. close()
    frees the slot when the stream ends; reset() starts a new stream in
    it."""

    def __init__(self, batcher: StreamSessionBatcher, slot: int):
        self._batcher = batcher
        self._slot = None  # the slot's rows were reset by open()
        super().__init__(batcher.model, batcher.decoder, chunk_frames=batcher.chunk_frames,
                         lookahead_chunks=batcher.lookahead)
        self._slot = slot
        if batcher.beam_width:
            self._sbeam = _SharedBeamRow(batcher, self)

    def reset(self) -> None:
        """Start a new stream in this slot (its rows are reset)."""
        super().reset()
        # ring slot of the next pending entry, and of the step being sent
        self._ring_next = self._step_widx = 0
        if self._slot is not None:
            self._request("reset")

    def close(self) -> None:
        if self._slot is not None:
            self._batcher._release(self._slot)
            self._slot = None

    def _request(self, kind: str, *payload):
        if self._slot is None:
            raise RuntimeError("the stream session is closed")
        return self._batcher._request((kind, self._slot) + payload)

    def _init_state(self) -> dict:
        return {}  # the carried state is a row of the batcher's

    def _pending_entry(self, valid: int) -> dict:
        # the advancing call records the entry state in ring slot idx
        idx = self._step_widx = self._ring_next
        self._ring_next = (idx + 1) % (self._batcher.lookahead + 1)
        return {"ring": idx, "offset": self._time_offset, "valid": valid,
                "frame_start": self._frame_cursor}

    def _advance_chunk(self, chunk: np.ndarray, offset: int, valid: Optional[int] = None):
        valid = self.chunk_frames if valid is None else valid
        res = self._request("step", chunk, offset, self._step_widx, valid)
        if res is None:  # lookahead: the emits decode
            return None, None, None
        return (None, None, res) if self._batcher.beam_width else res

    def _emit_forward(self, chunk: np.ndarray, p: dict):
        res = self._request("emit", chunk, p["offset"], p["ring"], p["valid"])
        return (None, None, res) if self._batcher.beam_width else res

    def _consume_beam(self, payload: dict, out_valid: int, base: int) -> None:
        # the shared call advanced and committed this row's beam already:
        # `payload` is its commit (beam.commit_row)
        self._sbeam.committed[0].extend(payload["tokens"])
        self._apply_beam_commit(payload)
