#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (velocity_asr_tpu_torch).

    python3 chip_smoke.py [--utterances N]

Needs one CUDA card; exits non-zero without one. Phases, each printing
its seconds:

  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build the CUDA kernels (an nvcc per source, in parallel, and a link),
     with ptxas registers/spills,
     and, as the card reports them, the registers, spill bytes, shared
     bytes and resident blocks per SM (clusters of 8 for the backward) of
     every instantiation of the log-mel, the scan forward (1, 2 and 4
     states a thread, with and without a state and bounds), the scan
     backward and the int8
     dense kernels (fp32 and bf16 x), the backward's workspace and grid,
     in waves of resident clusters, at the training shapes (16, 300, 384,
     64) and (8, 100, 384, 64), and the int8 grid (blocks, shared bytes,
     stages of K, waves) at every shape of the batched path's 600-frame
     bucket and at K = 1,536;
  3. regenerate the first N held-out synthetic utterances (split "test",
     seed 1234) as WAVs in a temporary directory, and work out the shapes
     phases 4, 5 and 7 will run on them (each utterance's frame bucket,
     each batch's size and padded frames, each streaming group's chunks);
     then each kernel against its plain PyTorch version, from a numpy
     seed, with the stated tolerance: the scan at every (batch, length, N)
     of the offline and batched paths and of phase 11's micro-batches (8
     rows of every offline bucket), and for N in {4, 8, 16, 24, 32, 64,
     128, 200, 300} at batch 1 and 4; the carried-state scan from a random
     h0 at every shape of the streaming path (batch 16, 8 and 1: the
     batched path, the server's shared step at 16 and at its default 8,
     the live session), for N in {4, 8, 16, 32, 64,
     200, 300} at batch 1 and 4, and across a seam (L = 200 as two
     launches of 100: against the plain version and against one launch);
     all four forward entries at D = 383, a width no block's channels
     divide, at batch 1, 8 and 16 with N = 64 and 32 (1, 2 and 4 states a
     thread), L = 100 (a ragged last tile), with the same tolerances and
     bit-equalities as at D = 384, and the carried-state scan across a
     50 + 50 seam there; the log-mel (from the reflect-padded signal, as the kernel frames it)
     on single utterances of 200 and 600 frames, at 8 x every offline
     bucket (the server's micro-batches at their largest), at every batch of the
     device-mel training path (4 x 600 for 9a, 8 x every 600-frame bucket
     up to 3,600 for 9b) and on signals of 1, 150 and 200 samples, no
     longer than the pad, against the plain version run in fp64 (every
     band within 1e-3 + 4 * 2^-24 / sqrt(its share of its frame's largest
     band power): the fp32 rounding noise of a transform, which the log
     magnifies in a band far below its frame's power); and both int8 dense
     kernels, x in fp32 and in bf16, at every shape of the batched int8
     path plus the 400-frame shapes at batch 1 and 16, one 128-aligned
     shape, one off every tile, K = 1012, and K = 1,024, 1,536 and 1,537
     at (37, K, 70) and (4800, K, 192), and rows whose every quotient
     v / s lies within an ulp of a half-integer (identical codes, output
     within 1e-5 of max|out|); the
     training scans at every training shape (batch 16, L = 100-400 at
     N=64 and L = 64 at N=32, and phase 8a's batch 4 at L = 200): the
     bounds-saving forward (y bit-equal to the no-bounds kernel's, bounds
     within 1e-6 of the plain chunk-entry states) and the backward (dx,
     ddt, dB, dC within 1e-5 of each output's max|ref|, dA within 1e-4,
     two calls bit-identical, each one launch),
     the backward also for N in {4, 8, 16,
     32, 64, 200, 300} at batch 1 and 4 with L = 37 and 100, and both at
     phase 9's offline shapes (batch 8, every 600-frame bucket up to 3,600
     frames; 9a's batch 4 at 600); the carried-state training scans
     (rows 4s, 5s) from a random h0 and gh at every shape of phase 9's
     streaming term ((8, 100, 384, 64), (8, 64, 384, 32), 9a's batch 4,
     and L = 200) and for N in {4, 8, 16, 32, 64, 200, 300} at batch 1 and
     4 with L = 37 and 100: y and h_final bit-equal to the carried-state
     kernel's, bounds[:, 0] equal to h0 and the bounds within 1e-6 of the
     plain chunk-entry states, dx, ddt, dB, dC and dh0 within 1e-5 of each
     output's max|ref|, dA within 1e-4, two calls bit-identical, and
     with h0 = gh = 0 the bits of the no-state bounds forward and
     backward; then the gradient of a loss on y and h_final through two
     carried launches of 50 steps against one launch of 100 (1e-5); for
     phase 12b, the 40 long-form utterances (40-72 s, written here) and
     their shapes: the scan at their batches (frame buckets of 200), at
     their longest at batch 1, and at 72 s (L = 3,600, K1 = 450) at batch
     1 and 16, the log-mel at 1 x 7,200 frames, at the longest's bucket
     and at the long-form batches, and on an 8 x 600 device-mel batch
     speed-warped and noised as phase 12c's trainer does it;
  4. offline path: load checkpoints/synth_run/final_pretrained, transcribe
     every WAV through
     the port's Transcriber, and hold the WER against the JAX package's
     WER over the same utterances (checkpoints/synth_run/eval_fp32_final.json);
     the launch counters must show 10 scan launches per forward and one
     log-mel launch per utterance; one utterance's logits on the card are
     held against the same model on the CPU in fp32;
  5. batched path: the same utterances through velocity_asr_tpu_torch.evaluate
     at batch 16 and frame bucket 200, three times: the checkpoint as it
     is (bf16), --int8 and --int8-static (calibrated first); each WER
     within 1.0 point of the JAX package's over the same utterances
     (eval_fp32_final.json, eval_int8_dynamic.json, eval_int8_static.json);
     per batched forward exactly 10 scan launches and 11 launches of the
     mode's int8 kernel (none without int8); int8-dynamic logits at fp32
     on one 400-frame batch of 4, card against CPU;
  7. streaming path: the same utterances through the port's
     BatchedStreamingTranscriber at batch 16 with 2 s chunks, lookahead 0,
     1 and 2, each WER within 1.0 point of the JAX package's over the same
     utterances (eval_streaming.json, eval_streaming_la1.json,
     eval_streaming_la2.json); the 40 long-form utterances (40-72 s,
     regenerated with write_corpus(split="longform", seed=1234, 90-110
     words)) at lookahead 0, within 1.0 point of
     eval_longform_streaming.json over all 40; exactly the planned
     carried-state scan launches (10 per advancing step, 8 more per emit
     under lookahead) and no other kernel; the live
     StreamingTranscriber on the first 16, fed 0.1 s blocks, against the
     batched lookahead-0 transcripts (at least 15 of 16 identical), with
     its per-chunk step latency; two chunks of one utterance at fp32,
     card against CPU (logits and every state leaf);
 10. (after 7) beam search, k = 8: (a) the first batch of 16 utterances'
     masked fp32 logits on the card, beamed on the card and on the CPU
     (identical tokens and lengths in every slot, scores within 1e-4),
     through the host backend (the same best hypotheses) and through
     ctc_beam_resume over phase 7's 100-frame chunks (equal to the
     one-shot search); (b) the batched evaluation (batch 16, bf16) with
     the beam, the beam + the committed LM at weight 0.5, and the beam +
     the hot-word oracle at weight 2 and 4: each WER within 1.0 point of
     the JAX package's over the same utterances (eval_beam8.json,
     eval_beam8_lm.json, eval_hotwords_oracle.json,
     eval_hotwords_oracle_w4.json), exactly 10 scan launches per batched
     forward and no other kernel; (c) the batched streaming path (batch
     16, 2 s chunks) with the beam, the beam + LM, and lookahead 1 with
     the beam + LM, and lookahead 2 with the beam + LM: each WER within
     1.0 point of eval_streaming_beam8.json, eval_streaming_beam8_lm.json,
     eval_streaming_la1_beam8_lm.json, eval_streaming_la2_beam8_lm.json,
     the carried-state scan launches as planned; (d) the live
     StreamingTranscriber at beam 8 on the first 16, fed 0.1 s blocks: at
     least 15 of 16 transcripts identical to (c)'s beam transcripts, no
     prefix-buffer overflow at beam_cap 256; (e) recorded, with no limit:
     the beam decode alone of (a)'s batch (ms per batch, per frame, the
     device operations per frame and their device time from a
     torch.profiler window) and, the same way, the live path's beam work
     alone at batch 1 (a StreamingBeam's update and commit over its
     first row in 100-frame chunks), the beam's share of (b)'s wall
     time, and the live step (advance and decode, to a synchronise) p50
     and p95 at beam 8 against greedy;
 11. (after 10) serving: (a) ASRService on the checkpoint with the
     committed LM at 0.5 and --max-streams 16, a ThreadingHTTPServer on
     127.0.0.1 in a thread, GET /health ok on cuda; (b) the N WAVs POSTed
     to /transcribe from 8 client threads: WER within 1.0 point of
     eval_fp32_final.json, at least 98% of the texts identical to phase
     4's, fewer micro-batched calls than requests, exactly 10 scan and 1
     log-mel launches per batched forward and no other kernel; 16
     requests with ?timestamps=1 and 16 with ?beam=8&timestamps=1: words
     join to the text, starts monotone, confidences in (0, 1]; (c) /stream
     from 16 sessions at once (the first 16 as int16 PCM in 0.1 s chunked
     blocks, 2 s chunks, ?timestamps=1), greedy at lookahead 0 and 1 and
     at beam 8 with the LM: at least 15 of 16 final texts identical to
     phase 7's / 10c's, increments and their words joining to the final
     line's, fewer shared advancing calls than chunks, exactly 10
     carried-state scans per shared advancing call and 8 per shared emit,
     no other kernel; then once more at lookahead 0 in real time (a block
     every 0.1 s, starts staggered over 2 s by a seeded draw) with the
     same checks but the sharing, its fill recorded; a 17th session past
     the budget gets a 503; (d) python -m velocity_asr_tpu_torch.serve as
     a subprocess on a free port answers /health and one /transcribe as
     the in-process server did, and is stopped; (e) recorded, with no
     limit, beside the card's name and power limit: the shared step's
     submit-to-result p50 and p95 at 16 sessions (as fast as they go and
     in real time) against 1, and /transcribe p50 and requests/s at 8
     clients against 1;
  8. training: (a) one update of the checkpoint's full-width model at
     fp32, dropout and SpecAugment off, on one batch of 4 x 400 frames,
     card against CPU (loss within 1e-5 relative, every parameter's
     gradient within 1e-3 of its max|grad|, but the key projection's bias,
     whose exact gradient is 0: below 1e-5 of the largest); (b) the CLI
     (velocity_asr_tpu_torch.train) from scratch on configs/train_synth.yaml
     and model_synth.yaml, --synthetic 3200 --max-steps 200, bf16 with
     SpecAugment and dropout on: every logged loss finite, the mean loss of
     micro-steps 151-200 at most 4.5 and at most half the mean of the
     first 10, exactly 10 bounds-forward and 10 backward launches per
     micro-step and no other kernel, ms per
     micro-step (p50, p95) per frame bucket, the host's data-wait share,
     and the card's busy share from a torch.profiler trace of micro-steps
     101-105 (device time by kernel); (c) the CLI fine-tunes the checkpoint for 20 micro-steps
     (--init-from), its final_pretrained/params.msgpack reads back equal to
     the trained weights bit for bit, and its bf16 WER over the same
     utterances is within 0.5 point of phase 5's;
  9. streaming-aware fine-tuning: (a) the loss and every gradient of the
     checkpoint at fp32, dropout and SpecAugment off, on a device-mel
     batch of 4 x 600 frames of the train split with streaming_chunks 200
     (the offline and the streaming term), card against CPU, as 8a; then,
     reported only, the raw log-mel's card-vs-CPU gap on that batch and
     the gradient gap with the CPU's mel fed to both sides, for the mixed
     objective, the offline term alone and the streaming term alone; (b)
     the CLI on configs/train_synth_stream.yaml + model_synth.yaml with
     --init-from the checkpoint, --synthetic 1600 --max-steps 100 (25
     updates inside the recipe's warmup; bf16, device mel, SpecAugment,
     dropout): every loss finite, the mean of the 100 micro-steps in
     [0.2, 0.5] (the JAX run's interval means: 0.279-0.369), per
     micro-step exactly 1 log-mel, 10 bounds-forward and 10 backward
     launches, and 10 C carried-state bounds forwards and 10 C
     carried-state backward launches for a batch of C 200-frame chunks,
     no other kernel; ms per micro-step per frame bucket, the data-wait
     share and the card's busy share from a torch.profiler window over
     micro-steps 61-65; (c) its final_pretrained/params.msgpack reads
     back bit-equal, and its streaming WER (batched, lookahead 0) over
     the same utterances is within 0.5 point of phase 7's;
  12. data sources, formats and the rest of training (after 9): (a) the
     native decoder library built from native/*.cc (a failed build
     fails), supported_audio_exts() printed, the first 50 held-out
     utterances as FLAC (tests/flac_encoder.py: transcripts identical to
     phase 4's) and, where this host's encoders load, as mp3, Ogg Vorbis
     and m4a (WER within 1.0 point of phase 4's over the same 50), each
     set through `transcribe --input-dir` (10 scans and 1 log-mel a
     file) and as /transcribe bodies; (b) the long-form corpus batched at
     16 in bf16 at frame buckets of 200 (WER within 1.0 point of
     eval_longform_offline.json over all 40, 10 scans a forward), its
     longest at batch 1 through the transcriber (10 scans, 1 log-mel),
     that one's fp32 logits card vs CPU, and rows 1 and 2 timed at these
     lengths; (c) 256 train-split utterances (and 16 dev) written as a
     LibriSpeech-layout FLAC tree, 40 micro-steps of
     configs/train_synth.yaml + model_synth.yaml through the CLI reading
     it as raw audio with speed and noise augmentation, gradient
     checkpointing and a profiler window (loss finite and falling; per
     micro-step exactly 1 log-mel, 8 no-bounds forwards, 10 bounds
     forwards and 10 backwards), 5 from a manifest over the same files,
     one fp32 checkpointed micro-step bit-equal to the plain one (dropout
     0.1), peak memory with and without checkpointing at 16 x 600 host
     mel and 8 x 3,600 device mel; (d) the window's Chrome trace: micro-
     steps 10-14 exactly, naming the log-mel, scan forward and backward
     kernels;
  6. (after 7, 10, 11, 8, 9 and 12, whose launch counts it reports) kernel timings beside
     their bounds and a library call: device time from CUDA graphs of many
     calls (what the JSON line reports), and CUDA events around eager
     calls, which include the host's launch; each scan forward's bound
     beside its exp floor (one expf per (b, t, d, n) at 16 a clock per SM)
     and the launcher's plan at that shape (states a thread, channels a
     block, grid, waves of resident blocks); the forward's per-phase
     timeline of block (0, 0) (clock64 stamps of the timeline entry, which
     no path calls) at (1, 200, 384, 64) and (16, 300, 384, 64), offline
     and with bounds; rows 4s and 5s at (8, 100,
     384, 64) and (8, 64, 384, 32), row 5 also at phase 9b's offline term
     (batch 8 at the frame bucket 9b ran most often: L = 1,200 at 2,400
     frames), the log-mel also at batch 8 at that bucket, the whole
     front end (compute_mel_spectrogram: pad, kernel, normalise) eagerly
     beside the kernel alone at 400 frames and at that batch, and both
     int8 kernels at every distinct shape of the batched path and at K =
     1,536, x in fp32 and in bf16, beside torch._int_mm and the bound.

The line before the last is a JSON object listing the kernels; the last
line is {"ok": true, "device": {...}} and is printed only when every
phase passed.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(ROOT, "checkpoints", "synth_run")
CHECKPOINT = os.path.join(RUN_DIR, "final_pretrained")
JAX_EVAL = os.path.join(RUN_DIR, "eval_fp32_final.json")
# The JAX package's batched streaming evaluations (2 s chunks, batch 16), by lookahead.
JAX_STREAM_EVALS = {0: os.path.join(RUN_DIR, "eval_streaming.json"),
                    1: os.path.join(RUN_DIR, "eval_streaming_la1.json"),
                    2: os.path.join(RUN_DIR, "eval_streaming_la2.json")}
# The long-form corpus (40 utterances of 90-110 words, 40-72 s each) and
# the JAX package's batched streaming evaluation of it (2 s chunks,
# lookahead 0)
LONGFORM_UTTS = 40
LONGFORM_WORDS = (90, 110)
JAX_LONGFORM_EVAL = os.path.join(RUN_DIR, "eval_longform_streaming.json")
# ... and its batched offline evaluation (phase 12b), here at batch 16 and
# frame buckets of LONGFORM_BUCKET frames. The JAX file does not record its
# bucket; 200, the JAX CLI's default, reproduces 34 of its 40 transcripts
# in bf16 (buckets of 400-1,000 reproduce 16-22, of 1,600 and up 8: the
# global context pools over the padded length). 72 s is LONG_FRAMES frames
# (L = 3,600 after the stride-2 binding, K1 = max(64, L // 8) = 450 in
# the global context)
JAX_LONGFORM_OFFLINE = os.path.join(RUN_DIR, "eval_longform_offline.json")
LONGFORM_BUCKET = 200
LONG_FRAMES = 7200
# The JAX package's batched evaluations of the same checkpoint, by mode.
JAX_BATCH_EVALS = {
    "bf16": JAX_EVAL,
    "int8": os.path.join(RUN_DIR, "eval_int8_dynamic.json"),
    "int8_static": os.path.join(RUN_DIR, "eval_int8_static.json"),
}
BUDGET_S = 900.0  # fail, rather than run on, past this
BATCH = 16
FRAME_BUCKET = 200
CHUNK_FRAMES = 200  # streaming: 2 s chunks
LIVE_UTTS = 16  # live StreamingTranscriber sessions
LIVE_BLOCK = 1600  # samples per feed (0.1 s)
LIVE_MIN_AGREE = 15  # of LIVE_UTTS transcripts equal to the batched path's

# Beam search (phase 10): width, the committed LM and its weight, the JAX
# package's batched beam evaluations by mode, and its streaming ones by
# (lookahead, LM).
BEAM_WIDTH = 8
LM_PATH = os.path.join(RUN_DIR, "lm.json.gz")
LM_WEIGHT = 0.5
JAX_BEAM_EVALS = {
    "beam8": os.path.join(RUN_DIR, "eval_beam8.json"),
    "beam8_lm": os.path.join(RUN_DIR, "eval_beam8_lm.json"),
    "oracle_w2": os.path.join(RUN_DIR, "eval_hotwords_oracle.json"),
    "oracle_w4": os.path.join(RUN_DIR, "eval_hotwords_oracle_w4.json"),
}
JAX_STREAM_BEAM_EVALS = {
    (0, False): os.path.join(RUN_DIR, "eval_streaming_beam8.json"),
    (0, True): os.path.join(RUN_DIR, "eval_streaming_beam8_lm.json"),
    (1, True): os.path.join(RUN_DIR, "eval_streaming_la1_beam8_lm.json"),
    (2, True): os.path.join(RUN_DIR, "eval_streaming_la2_beam8_lm.json"),
}
# card against CPU, the same fp32 logits: sums of a few hundred log
# posteriors whose last bits differ between the two devices' log-softmax
BEAM_SCORE_MAX_ABS = 1e-4
BEAM_TIMING_REPS = 5

# Serving (phase 11): the server's stream budget and micro-batch, the
# concurrent clients, the requests with timestamps (greedy, then beam),
# and the share of /transcribe texts that must equal phase 4's
SERVE_MAX_STREAMS = 16
SERVE_DEFAULT_STREAMS = 8  # the CLI server's --max-streams and --max-batch
SERVE_CLIENTS = 8
SERVE_RICH_REQUESTS = 16
SERVE_SOLO_REQUESTS = 50  # /transcribe from one client, for the latency at 1
SERVE_MIN_AGREE = 0.98
SERVE_START_S = 180.0  # the CLI server must answer /health within this
# the real-time /stream run: each client sends a 0.1 s block every 0.1 s,
# its start drawn uniformly over one 2 s chunk (a seeded draw)
SERVE_PACE_S = 0.1
SERVE_STAGGER_S = 2.0

# Data sources, formats and the rest of training (phase 12): the held-out
# utterances re-encoded per format; the LibriSpeech-layout FLAC tree the
# trainer reads (train and dev splits), its micro-steps from the tree and
# from a manifest over the same files; the profiler window; the scans a
# checkpointed micro-step launches (the local blocks' first pass without
# autograd runs the no-bounds forward; each block's recompute and the
# global blocks run the bounds forward; every block its backward) and the
# device-mel log-mel; the peak-memory shapes
FORMAT_UTTS = 50
FORMAT_WER_MAX_DIFF = 0.01  # lossy formats: within 1.0 WER point of phase 4's over the same
DISK_SPLITS = {"train-clean-100": ("train", 256, 2, 2), "dev-clean": ("dev", 16, 1, 1)}
DISK_STEPS = 40
DISK_MANIFEST_STEPS = 5
DISK_PROFILE = (10, 5)  # training.profile_start, profile_steps
CHECKPOINTED_STEP = {"scan_fwd_f32": 8, "scan_fwd_bounds_f32": 10, "scan_bwd_f32": 10,
                     "log_mel_f32": 1}
MEMORY_SHAPES = ((16, 600, "host mel"), (8, 3600, "device mel"))
AUG_MEL_BATCH, AUG_MEL_FRAMES = 8, 600  # phase 3: the log-mel on an augmented batch

# Tolerances (kernel against its plain version on the same inputs).
SCAN_MAX_REL = 1e-4  # max|kernel - plain| / max|plain|; fp32, other summation order
# a chunk scanned as two launches with the carried state against one
# launch: the same arithmetic in the same order, the state stored and
# read back in fp32
SEAM_MAX_REL = 1e-6
# on log-mel, the kernel (fp32 FFT) against the plain version run in fp64.
# An fp32 transform's rounding leaves in every bin an amplitude error of
# a few fp32 units (2^-24) of its frame's amplitude, whatever the bin's
# own, and the log divides it by the band's own amplitude: a band at
# `share` of its frame's largest band power is held within MEL_MAX_ABS +
# MEL_FP32_NOISE / sqrt(share) (1e-3 at the frame's largest band, 1.24e-3
# at 1e-6 of it, 8.5e-3 at 1e-9)
MEL_MAX_ABS = 1e-3
MEL_FP32_NOISE = 4 * 2.0 ** -24
MEL_SHORT_SAMPLES = (1, 150, 200)  # signals no longer than the reflect pad
WER_MAX_DIFF = 0.01  # port WER within 1.0 point of the JAX WER
LOGITS_FP32_MAX_ABS = 1e-2  # card against CPU, fp32 model, one utterance
# card against CPU, fp32 model, two streaming chunks: every carried leaf
# (conv tails, scan states, global memory) after each chunk
STATE_FP32_MAX_ABS = 1e-2
INT8_MAX_REL = 1e-5  # max|kernel - plain| / max|plain|, with identical codes
# the training scans against their plain versions: the bounds are the
# forward's own states, stored (fp32, the same recurrence); the backward
# sums in another order than the plain version (dA over every (b, t, d))
BOUNDS_MAX_REL = 1e-6
BWD_MAX_REL = 1e-5  # dx, ddt, dB, dC: max|kernel - plain| / max|plain|
BWD_DA_MAX_REL = 1e-4
# phase 8a, card against CPU, fp32: the loss, and each parameter's
# gradient relative to its max|grad|
TRAIN_LOSS_MAX_REL = 1e-5
TRAIN_GRAD_MAX_REL = 1e-3
# The key projection's bias has an exact gradient of 0 (softmax ignores a
# shift of every key), so its computed gradient is round-off on both
# devices and has no scale of its own to compare at: it is held below
# this fraction of the model's largest gradient instead.
ZERO_GRAD_PARAMS = ("global_context.cross_attention.k_proj.bias",)
ZERO_GRAD_MAX_REL = 1e-5
TRAIN_LOSS_BOUND = 4.5  # phase 8b: mean loss of micro-steps 151-200 at most this
FINETUNE_WER_MAX_DIFF = 0.005  # phase 8c: within 0.5 point of phase 5's bf16 WER
# Card against CPU, int8-dynamic model at fp32: an fp32 difference of a
# few ulps upstream can move an activation across a rounding boundary,
# and that code then differs by one, shifting its row's outputs by one
# quantization step; such flips reach the logits (on the CPU, a 1e-7
# relative change of the mel moves them by 0.05). The bound is one
# model-level quantization error: the same batch's int8-vs-fp32 logit
# gap on the CPU (0.14 there).
LOGITS_INT8_MIN_AGREE = 0.99  # argmax agreement, same comparison

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
PEAK_INT8_OPS_PER_S = 1979e12
# the SFU's exp2 results per clock per SM (one per IEEE expf) and the SMs
# of an H100 SXM, at its boost clock of 1,980 MHz
SFU_PER_CLOCK_PER_SM = 16
H100_SMS = 132
H100_BOOST_HZ = 1.98e9

SCAN_SOURCE = "velocity_asr_tpu_torch/csrc/scan_fwd.cu"
SCAN_BWD_SOURCE = "velocity_asr_tpu_torch/csrc/scan_bwd.cu"
SCAN_BWD_REPLACES = "velocity_asr_tpu/ops/scan_pallas.py:288"
# row 4s: _make_fwd_kernel(save_bounds=True, with_state=True), launched by
# _pallas_scan_fwd_state(save_bounds=True); row 5s: _make_bwd_kernel(
# with_state=True), launched by _pallas_scan_bwd with gh
SCAN_BOUNDS_STATE_REPLACES = "velocity_asr_tpu/ops/scan_pallas.py:267"
SCAN_BWD_STATE_REPLACES = "velocity_asr_tpu/ops/scan_pallas.py:452"
MEL_SOURCE = "velocity_asr_tpu_torch/csrc/log_mel.cu"
INT8_SOURCE = "velocity_asr_tpu_torch/csrc/int8_dense.cu"
SCAN_REPLACES = "velocity_asr_tpu/ops/scan_pallas.py:79"
MEL_REPLACES = "velocity_asr_tpu/ops/mel_pallas.py:74"
INT8_DYNAMIC_REPLACES = "velocity_asr_tpu/ops/int8_matmul.py:88"
INT8_STATIC_REPLACES = "velocity_asr_tpu/ops/int8_matmul.py:70"

# the batched int8 path's most common frame bucket (16 x 300 rows), and a K
# past what a block keeps in shared memory at 192 channels (7 stages of 224)
INT8_MAIN_FRAMES = 600
INT8_STAGED_K = 1536
# the widest K's held in phase 3 (at 192 channels: 5, 7 and 7 stages, the
# last off every tile, without 16-byte loads)
INT8_WIDE_K = (1024, 1536, 1537)

# widths for the forward's lanes (N = 4 to 32 at batch 1: 1 state a
# thread on 4 to 32 lanes; 24 fills 3/4 of its lanes; 64 and 128: 2 and 4
# states a thread; 200 and 300: passes of 128 states)
SCAN_STATE_DIMS = (4, 8, 16, 24, 32, 64, 128, 200, 300)
# a d_inner no block's channel count divides (prime): the forward's last
# block of channels is partly empty at every plan
ODD_D_INNER = 383
STATE_SCAN_DIMS = (4, 8, 16, 32, 64, 200, 300)  # the carried-state scan's widths
BWD_SCAN_DIMS = (4, 8, 16, 32, 64, 200, 300)  # the backward's widths (64 a pass)

# Training (phase 8): the recipe, its run and the scans it launches.
TRAIN_CONFIG = os.path.join(ROOT, "configs", "train_synth.yaml")
TRAIN_MODEL_CONFIG = os.path.join(ROOT, "configs", "model_synth.yaml")
TRAIN_SYNTH = 3200  # train utterances
TRAIN_STEPS = 200  # micro-steps from scratch (batch 16, accumulation 2)
FINETUNE_STEPS = 20
TRAIN_BATCH = 16
CHECK_BATCH = 4  # phase 8a: 4 x 400 frames
CHECK_FRAMES = 400
# (batch, L, N) of the training scans: frame buckets of 200 give local
# blocks L = 100..400 (a clip past 6 s pads to 800 frames) at N=64; the
# global blocks pool to K1 = max(64, L // 8) = 64 at N=32; phase 8a's
# batch 4 at 400 frames
TRAIN_SCAN_SHAPES = sorted({(TRAIN_BATCH, f // 2, 64) for f in (200, 400, 600, 800)}
                           | {(TRAIN_BATCH, 64, 32), (CHECK_BATCH, CHECK_FRAMES // 2, 64),
                              (CHECK_BATCH, 64, 32)})
SCANS_PER_STEP = 10  # 8 local + 2 global blocks
TRAIN_TRACED = (100, 5)  # phase 8b: micro-steps 101-105 under torch.profiler

# Streaming-aware fine-tuning (phase 9): the recipe, its run and the scans
# it launches.
STREAM_CONFIG = os.path.join(ROOT, "configs", "train_synth_stream.yaml")
STREAM_SYNTH = 1600  # train utterances
STREAM_STEPS = 100  # micro-steps: 25 updates at accumulation 4, inside the 100-update warmup
STREAM_BATCH = 8
STREAM_CHUNK = 200  # training.streaming_chunks: 2 s chunks
STREAM_BUCKET = 600  # data.frame_bucket
# phase 3 holds the training scans at every bucket up to this many frames;
# phase 9b fails on a batch padded past it (up to 28 s utterances at the
# recipe's 40 words: buckets of 1,800-3,000 frames)
STREAM_MAX_FRAMES = 3600
STREAM_LOSS_RANGE = (0.2, 0.5)  # 9b: mean loss of the 100 micro-steps
STREAM_TRACED = (60, 5)  # 9b: micro-steps 61-65 under torch.profiler
STREAM_CHECK_FRAMES = 600  # 9a: 4 x 600 frames
STREAM_WER_MAX_DIFF = 0.005  # 9c: within 0.5 point of phase 7's lookahead-0 WER
# the gradient of a loss on y and h_final through two carried launches of
# 50 steps against one launch of 100, relative to each gradient's max|ref|
# (the same arithmetic; the backward's dA and dB/dC sums split at the seam)
GRAD_SEAM_MAX_REL = 1e-5
# phase 9's offline term: batch 8 at every bucket up to STREAM_MAX_FRAMES
# (local L = frames / 2 at N=64, global K1 = max(64, L // 8) at N=32), and
# 9a's batch 4 at 600 frames
STREAM_BUCKETS = range(STREAM_BUCKET, STREAM_MAX_FRAMES + 1, STREAM_BUCKET)
TRAIN_SCAN_SHAPES = sorted(
    set(TRAIN_SCAN_SHAPES)
    | {(STREAM_BATCH, f // 2, 64) for f in STREAM_BUCKETS}
    | {(STREAM_BATCH, max(64, f // 16), 32) for f in STREAM_BUCKETS}
    | {(CHECK_BATCH, STREAM_CHECK_FRAMES // 2, 64)})
# the streaming term: each 200-frame chunk's local blocks (L = 100, N=64)
# and global blocks (the 64 summary tokens, N=32) at batch 8 and 9a's 4;
# L = 200 besides
STATE_TRAIN_SHAPES = sorted({(b, STREAM_CHUNK // 2, 64) for b in (STREAM_BATCH, CHECK_BATCH)}
                            | {(b, 64, 32) for b in (STREAM_BATCH, CHECK_BATCH)}
                            | {(STREAM_BATCH, STREAM_CHUNK, 64)})


def int8_shapes(batch: int, frames: int = 400):
    """(name, M, K, N) of the 11 int8 projections of one batched forward
    of the synth checkpoint at a `frames`-frame bucket (L = frames / 2
    output frames, pooled to K1 then K2 frames)."""
    from velocity_asr_tpu_torch.ops.pooling import pool_size_level1, pool_size_level2

    length = frames // 2
    k1 = pool_size_level1(length)
    k2 = pool_size_level2(k1)
    return [
        ("pool1", k1 * batch, 192, 192), ("pool2", k2 * batch, 192, 192),
        ("q", length * batch, 192, 48), ("k", k2 * batch, 192, 48),
        ("v", k2 * batch, 192, 48), ("attn_out", length * batch, 48, 192),
        ("gate", length * batch, 384, 192), ("local", length * batch, 192, 192),
        ("global", length * batch, 192, 192), ("fusion_out", length * batch, 192, 192),
        ("ctc", length * batch, 192, 30),
    ]


class PhaseFailed(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def run_phase(name, fn, t_start):
    t0 = time.perf_counter()
    try:
        out = fn()
    except Exception:
        traceback.print_exc()
        log(f"[phase] {name}: FAILED after {time.perf_counter() - t0:.3f} s")
        raise PhaseFailed(name)
    log(f"[phase] {name}: ok in {time.perf_counter() - t0:.3f} s")
    if time.perf_counter() - t_start > BUDGET_S:
        log(f"[phase] over the {BUDGET_S:.0f} s budget")
        raise PhaseFailed(name)
    return out


# ---------------------------------------------------------------- timing


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, iters: int) -> float:
    """Device time of one call of fn: `iters` calls captured in a CUDA
    graph and replayed between two events, so the host's launch cost
    (Python, ctypes) is not counted, as it is in cuda_time_ms."""
    import torch

    fn()  # warm up outside the capture (library build, allocator)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_cost(batch, length, d_inner, state_dim):
    """Bytes (each input read once, y written once) and operations
    (per (t, d, n): dt*A, exp, decay*h, B*u + ., C*h + . = 7)."""
    n_bytes = 4 * (3 * batch * length * d_inner + 2 * batch * length * state_dim + state_dim)
    n_ops = 7 * batch * length * d_inner * state_dim + batch * length * d_inner
    return n_bytes, n_ops


def n_chunks(length):
    return -(-length // 16)


def carried_bytes(batch, d_inner, state_dim):
    """A carried state read once and one written once: h0 and h_final in
    the forward, gh and dh0 in the backward, (batch, D, N) fp32 each."""
    return 2 * 4 * batch * d_inner * state_dim


def scan_bounds_cost(batch, length, d_inner, state_dim, with_state=False):
    """The bounds-saving forward: the forward's bytes and operations plus
    the bounds written once, (batch, ceil(L/16), D, N) fp32; with_state
    adds h0 read and h_final written once."""
    n_bytes, n_ops = scan_cost(batch, length, d_inner, state_dim)
    n_bytes += 4 * batch * n_chunks(length) * d_inner * state_dim
    if with_state:
        n_bytes += carried_bytes(batch, d_inner, state_dim)
    return n_bytes, n_ops


def scan_bwd_cost(batch, length, d_inner, state_dim, with_state=False):
    """The backward: bytes of x, dt, g (batch, L, D), B, C (batch, L, N),
    A and the bounds read once, and dx, ddt, dB, dC, dA written once; 20
    operations per (b, t, d, n): the decay (dt*A, exp), the state (decay*h,
    B*u, +), the adjoint (C*g, +; lam *= decay), the decay's cotangent
    (lam*h*decay: 2) and its sums into dA (*dt, +) and ddt (*A, +), and
    the sums into ds (B*lam, +), dB (u*lam, +) and dC (g*h, +). with_state
    adds gh read and dh0 written once."""
    seq_d, seq_n = batch * length * d_inner, batch * length * state_dim
    bounds = batch * n_chunks(length) * d_inner * state_dim
    n_bytes = 4 * (5 * seq_d + 4 * seq_n + bounds + 2 * state_dim)
    if with_state:
        n_bytes += carried_bytes(batch, d_inner, state_dim)
    return n_bytes, 20 * batch * length * d_inner * state_dim


def int8_cost(m, k, n, x_bytes=4):
    """Bytes (x read once at the width the call reads, x_bytes = 4 for
    fp32 and 2 for bf16; codes and channel scales read once, out fp32
    written once) and operations per type: 2*M*N*K int8 (products and
    sums) and 5*M*K + 2*M*N fp32 (|x| max, divide, round, clamp;
    dequantize)."""
    n_bytes = x_bytes * m * k + n * k + 4 * n + 4 * m * n + 4
    return n_bytes, 2 * m * n * k, 5 * m * k + 2 * m * n


def int8_bound_ms(m, k, n, x_bytes=4):
    n_bytes, int8_ops, fp32_ops = int8_cost(m, k, n, x_bytes)
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (int8_ops / PEAK_INT8_OPS_PER_S + fp32_ops / PEAK_FP32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mel_cost(padded, n_frames, n_mels=80, n_fft=400):
    """The log-mel's least work: bytes of the padded signal (batch,
    samples + n_fft) read once, the (batch * n_frames, n_mels) output
    written once and the tables (window, twiddles, band table) read once;
    per frame 2.5 n log2(n) operations for a real FFT of n = n_fft points,
    3 per bin for the power, 2 per filterbank nonzero and one log per mel
    (a dense DFT product, 4 * n_fft * n_freq per frame, is not the
    function's least work)."""
    from velocity_asr_tpu_torch.ops.mel import band_table

    first, offset, weight = band_table(n_fft, n_mels)
    n_freq = n_fft // 2 + 1
    tables = 4 * (3 * n_fft + weight.size) + 4 * (first.size + offset.size)
    n_bytes = 4 * padded.numel() + 4 * n_frames * n_mels + tables
    per_frame = 2.5 * n_fft * math.log2(n_fft) + 3 * n_freq + 2 * weight.size + n_mels
    return n_bytes, n_frames * per_frame


# ---------------------------------------------------------------- inputs


def scan_inputs(rng, length, state_dim, d_inner=384, batch=1, with_state=False):
    """x, dt, A, B, C (and a random non-zero h0 (batch, d_inner, N)) on the card."""
    import torch

    x = rng.standard_normal((batch, length, d_inner)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((batch, length, d_inner)) - 1.0)).astype(np.float32)
    A = -np.arange(1, state_dim + 1, dtype=np.float32)
    B = rng.standard_normal((batch, length, state_dim)).astype(np.float32)
    C = rng.standard_normal((batch, length, state_dim)).astype(np.float32)
    out = [x, dt, A, B, C]
    if with_state:
        out.append(rng.standard_normal((batch, d_inner, state_dim)).astype(np.float32))
    return [torch.tensor(a, device="cuda") for a in out]


def rel_err(ker, ref):
    """(max abs, max abs / max|ref|) of two tensors."""
    max_abs = (ker - ref).abs().max().item()
    return max_abs, max_abs / ref.abs().max().item()


def compare_state_scan(rng, state_dim, batch, length):
    """The carried-state kernel against its plain version from a random h0;
    returns the worst (max_abs, max_rel) over y and h_final."""
    import torch

    from velocity_asr_tpu_torch.ops.scan import scan_fwd_plain, scan_fwd_state

    x, dt, A, B, C, h0 = scan_inputs(rng, length, state_dim, batch=batch, with_state=True)
    y, h = scan_fwd_state(x, dt, A, B, C, h0)
    torch.cuda.synchronize()
    ref_y, ref_h = scan_fwd_plain(x, dt, A, B, C, h0, return_state=True)
    return max(rel_err(y, ref_y), rel_err(h, ref_h), key=lambda e: e[1])


def compare_seam(rng, state_dim, batch, length=200):
    """[0, L) as two launches with the carried state, against the plain
    version and against one launch: (max_abs, max_rel vs plain, max_rel
    vs one launch), over y and h_final."""
    import torch

    from velocity_asr_tpu_torch.ops.scan import scan_fwd_plain, scan_fwd_state

    x, dt, A, B, C, h0 = scan_inputs(rng, length, state_dim, batch=batch, with_state=True)
    half = length // 2
    parts = [[t[:, sl].contiguous() for t in (x, dt)] + [A]
             + [t[:, sl].contiguous() for t in (B, C)]
             for sl in (slice(0, half), slice(half, length))]
    y1, h1 = scan_fwd_state(*parts[0], h0)
    y2, h2 = scan_fwd_state(*parts[1], h1)
    y_one, h_one = scan_fwd_state(x, dt, A, B, C, h0)
    torch.cuda.synchronize()
    y_seam = torch.cat([y1, y2], dim=1)
    ref_y, ref_h = scan_fwd_plain(x, dt, A, B, C, h0, return_state=True)
    vs_plain = max(rel_err(y_seam, ref_y), rel_err(h2, ref_h), key=lambda e: e[1])
    vs_one = max(rel_err(y_seam, y_one)[1], rel_err(h2, h_one)[1])
    return vs_plain[0], vs_plain[1], vs_one


def compare_odd_width(rng, batch, state_dim, length=100, d_inner=ODD_D_INNER):
    """All four forward entries at a d_inner no block's channel count
    divides, from one seed: the worst max_rel of y and h_final (the
    no-bounds entries) against the plain version, the bounds' max_rel and
    max_abs against the plain chunk-entry states, whether the bounds
    entries' y (and h_final) are bit-equal to the no-bounds entries' and
    bounds[:, 0] is h0, and the carried-state scan across a seam at L / 2
    against one launch (max_rel)."""
    import torch

    from velocity_asr_tpu_torch.ops.scan import (scan_fwd, scan_fwd_bounds,
                                                 scan_fwd_bounds_plain, scan_fwd_bounds_state,
                                                 scan_fwd_plain, scan_fwd_state)

    x, dt, A, B, C, h0 = scan_inputs(rng, length, state_dim, d_inner=d_inner, batch=batch,
                                     with_state=True)
    y = scan_fwd(x, dt, A, B, C)
    ys, hs = scan_fwd_state(x, dt, A, B, C, h0)
    yb, bounds = scan_fwd_bounds(x, dt, A, B, C)
    ybs, bounds_s, hbs = scan_fwd_bounds_state(x, dt, A, B, C, h0)
    half = length // 2
    y1, h1 = scan_fwd_state(*[t[:, :half].contiguous() for t in (x, dt)], A,
                            *[t[:, :half].contiguous() for t in (B, C)], h0)
    y2, h2 = scan_fwd_state(*[t[:, half:].contiguous() for t in (x, dt)], A,
                            *[t[:, half:].contiguous() for t in (B, C)], h1)
    torch.cuda.synchronize()
    ref_y, ref_bounds = scan_fwd_bounds_plain(x, dt, A, B, C)
    ref_ys, ref_bounds_s, ref_hs = scan_fwd_bounds_plain(x, dt, A, B, C, h0, return_state=True)
    b_abs, b_rel = max(rel_err(bounds, ref_bounds), rel_err(bounds_s, ref_bounds_s),
                       key=lambda e: e[1])
    return {
        "y": max(rel_err(y, ref_y)[1], rel_err(ys, ref_ys)[1], rel_err(hs, ref_hs)[1]),
        "y_abs": max(rel_err(y, ref_y)[0], rel_err(ys, ref_ys)[0], rel_err(hs, ref_hs)[0]),
        "bounds": (b_abs, b_rel),
        "same": (torch.equal(yb, y) and torch.equal(ybs, ys) and torch.equal(hbs, hs)
                 and torch.equal(bounds_s[:, 0], h0)),
        "seam": max(rel_err(torch.cat([y1, y2], dim=1), ys)[1], rel_err(h2, hs)[1]),
    }


def launched_once_each(name, call):
    """Run `call` (two backward calls) and say whether the C entry `name`
    was launched once per call."""
    from velocity_asr_tpu_torch.ops.cuda_lib import launch_counts

    before = launch_counts[name]
    out = call()
    return out, launch_counts[name] - before == 2


def compare_train_scans(rng, state_dim, batch, length, forward=True):
    """The training kernels against their plain versions on one shape:
    (bounds forward's y bit-equal to scan_fwd's, bounds max_rel, bounds
    max_abs) and the backward's per-output (max_abs, max_rel) and whether
    two launches gave the same bits (and each call was one launch).
    forward=False checks the backward only (from the plain bounds)."""
    import torch

    from velocity_asr_tpu_torch.ops.scan import (scan_bwd, scan_bwd_plain, scan_fwd,
                                                 scan_fwd_bounds, scan_fwd_bounds_plain)

    x, dt, A, B, C = scan_inputs(rng, length, state_dim, batch=batch)
    g = torch.tensor(rng.standard_normal((batch, length, 384)).astype(np.float32),
                     device="cuda")
    fwd = None
    ref_y, ref_bounds = scan_fwd_bounds_plain(x, dt, A, B, C)
    if forward:
        y, bounds = scan_fwd_bounds(x, dt, A, B, C)
        y0 = scan_fwd(x, dt, A, B, C)
        torch.cuda.synchronize()
        b_abs, b_rel = rel_err(bounds, ref_bounds)
        fwd = (torch.equal(y, y0), b_rel, b_abs)
    (outs, again), booked = launched_once_each(
        "scan_bwd_f32", lambda: (scan_bwd(x, dt, A, B, C, ref_bounds, g),
                                 scan_bwd(x, dt, A, B, C, ref_bounds, g)))
    torch.cuda.synchronize()
    refs = scan_bwd_plain(x, dt, A, B, C, ref_bounds, g)
    errs = {name: rel_err(o, r) for name, o, r in zip(("dx", "ddt", "dA", "dB", "dC"), outs, refs)}
    same = booked and all(torch.equal(a, b) for a, b in zip(outs, again))
    return fwd, errs, same


def compare_train_state_scans(rng, state_dim, batch, length):
    """The carried-state training kernels (rows 4s, 5s) against their plain
    versions on one shape, from a random h0 and gh. Returns a dict:
    'fwd_same' (y and h_final bit-equal to scan_fwd_state's, bounds[:, 0]
    equal to h0), 'bounds' (max_abs, max_rel), 'bwd' per output (max_abs,
    max_rel), 'same' (two backward launches bit-identical), 'zero_same'
    (h0 = 0 and gh = 0: bounds bit-equal to scan_fwd_bounds_f32's and every
    gradient to scan_bwd_f32's)."""
    import torch

    from velocity_asr_tpu_torch.ops.scan import (scan_bwd, scan_bwd_plain, scan_bwd_state,
                                                 scan_fwd_bounds, scan_fwd_bounds_plain,
                                                 scan_fwd_bounds_state, scan_fwd_state)

    x, dt, A, B, C, h0 = scan_inputs(rng, length, state_dim, batch=batch, with_state=True)
    g = torch.tensor(rng.standard_normal((batch, length, 384)).astype(np.float32),
                     device="cuda")
    gh = torch.tensor(rng.standard_normal((batch, 384, state_dim)).astype(np.float32),
                      device="cuda")
    y, bounds, h_final = scan_fwd_bounds_state(x, dt, A, B, C, h0)
    y0, h0_final = scan_fwd_state(x, dt, A, B, C, h0)
    torch.cuda.synchronize()
    ref_y, ref_bounds, _ = scan_fwd_bounds_plain(x, dt, A, B, C, h0, return_state=True)
    out = {"fwd_same": (torch.equal(y, y0) and torch.equal(h_final, h0_final)
                        and torch.equal(bounds[:, 0], h0)),
           "bounds": rel_err(bounds, ref_bounds)}
    (outs, again), booked = launched_once_each(
        "scan_bwd_state_f32", lambda: (scan_bwd_state(x, dt, A, B, C, ref_bounds, g, gh),
                                       scan_bwd_state(x, dt, A, B, C, ref_bounds, g, gh)))
    torch.cuda.synchronize()
    refs = scan_bwd_plain(x, dt, A, B, C, ref_bounds, g, gh)
    out["bwd"] = {name: rel_err(o, r) for name, o, r in
                  zip(("dx", "ddt", "dA", "dB", "dC", "dh0"), outs, refs)}
    out["same"] = booked and all(torch.equal(a, b) for a, b in zip(outs, again))
    zero = torch.zeros_like(h0)
    _, z_bounds, _ = scan_fwd_bounds_state(x, dt, A, B, C, zero)
    _, nz_bounds = scan_fwd_bounds(x, dt, A, B, C)
    z_outs = scan_bwd_state(x, dt, A, B, C, nz_bounds, g, zero)
    nz_outs = scan_bwd(x, dt, A, B, C, nz_bounds, g)
    torch.cuda.synchronize()
    out["zero_same"] = (torch.equal(z_bounds, nz_bounds)
                        and all(torch.equal(a, b) for a, b in zip(z_outs, nz_outs)))
    return out


def compare_grad_seam(rng, state_dim, batch, length=100):
    """The gradient of sum(wy * y) + sum(wh * h_final) with respect to x,
    dt, A, B, C and h0 through CarriedStateScanFn on the card: [0, L) as
    two carried launches of L / 2 against one launch of L. Returns the
    worst max_abs / max|grad of one launch| over the six gradients."""
    import torch

    from velocity_asr_tpu_torch.ops.scan import CarriedStateScanFn

    leaves = [t.requires_grad_() for t in
              scan_inputs(rng, length, state_dim, batch=batch, with_state=True)]
    x, dt, A, B, C, h0 = leaves
    wy = torch.tensor(rng.standard_normal((batch, length, 384)).astype(np.float32),
                      device="cuda")
    wh = torch.tensor(rng.standard_normal((batch, 384, state_dim)).astype(np.float32),
                      device="cuda")
    half = length // 2

    def part(t, sl):
        return t[:, sl].contiguous()

    y1, h1 = CarriedStateScanFn.apply(*(part(t, slice(0, half)) for t in (x, dt)), A,
                                      *(part(t, slice(0, half)) for t in (B, C)), h0)
    y2, h2 = CarriedStateScanFn.apply(*(part(t, slice(half, length)) for t in (x, dt)), A,
                                      *(part(t, slice(half, length)) for t in (B, C)), h1)
    loss = (wy * torch.cat([y1, y2], dim=1)).sum() + (wh * h2).sum()
    seam = torch.autograd.grad(loss, leaves)
    y, h = CarriedStateScanFn.apply(x, dt, A, B, C, h0)
    one = torch.autograd.grad((wy * y).sum() + (wh * h).sum(), leaves)
    torch.cuda.synchronize()
    return max(rel_err(a, b)[1] for a, b in zip(seam, one))


def mel_inputs(rng, n_frames, batch=1):
    """`batch` seeded waveforms of `n_frames` frames each on the card, and
    the same reflect-padded as `compute_mel_spectrogram` pads a batch:
    (batch, samples), (batch, samples + n_fft)."""
    import torch

    from velocity_asr_tpu_torch.audio import HOP_LENGTH, N_FFT, reflect_pad

    audio = (rng.standard_normal((batch, (n_frames - 1) * HOP_LENGTH)) * 0.1).astype(np.float32)
    audio_t = torch.tensor(audio, device="cuda")
    return audio_t, reflect_pad(audio_t, N_FFT // 2)


def mel_errors(ker, padded, log_mel_plain):
    """The log-mel kernel's output `ker` on `padded` against the plain
    version run in fp64, band by band: the largest |error| over every
    band, the largest share of its tolerance a band used, that band's
    share of its frame's largest band power, and the plain version in
    fp32's largest share of the same tolerance."""
    import torch

    ref = log_mel_plain(padded.double())
    rel = ref - ref.amax(dim=-1, keepdim=True)  # log of each band's share
    tol = MEL_MAX_ABS + MEL_FP32_NOISE * torch.exp(-0.5 * rel)
    err = (ker.double() - ref).abs()
    used = (err / tol).flatten()
    worst = int(used.argmax())
    plain = ((log_mel_plain(padded).double() - ref).abs() / tol).max().item()
    return {"max_abs": err.max().item(), "used": used[worst].item(),
            "share": rel.flatten()[worst].exp().item(), "plain_used": plain}


def compare_augmented_mel(rng):
    """The log-mel kernel on a batch of AUG_MEL_BATCH x AUG_MEL_FRAMES
    frames of speech-like rows of several lengths, speed-warped and then
    noised as the trainer does it (augment.speed_perturb_audio,
    noise_inject), against its plain version in fp64 (mel_errors)."""
    import torch

    from velocity_asr_tpu_torch.audio import HOP_LENGTH, N_FFT, reflect_pad
    from velocity_asr_tpu_torch.augment import (SpecAugmentConfig, noise_inject,
                                                speed_perturb_audio)
    from velocity_asr_tpu_torch.ops.mel import log_mel, log_mel_plain

    aug = SpecAugmentConfig(enabled=True, noise_injection=True, speed_perturb=True)
    width = (AUG_MEL_FRAMES - 1) * HOP_LENGTH
    audio, _ = mel_inputs(rng, AUG_MEL_FRAMES, AUG_MEL_BATCH)
    frames = torch.tensor([AUG_MEL_FRAMES - 75 * i for i in range(AUG_MEL_BATCH)],
                          dtype=torch.int32, device="cuda")
    valid = torch.arange(width, device="cuda")[None] < ((frames - 1) * HOP_LENGTH)[:, None]
    audio = torch.where(valid, audio, 0.0)
    gen = torch.Generator(device="cuda").manual_seed(12)
    audio, frames = speed_perturb_audio(audio, gen, aug, frames, HOP_LENGTH)
    audio = noise_inject(audio, gen, aug, (frames - 1) * HOP_LENGTH)
    padded = reflect_pad(audio, N_FFT // 2)
    ker = log_mel(padded)
    torch.cuda.synchronize()
    if ker.shape != (AUG_MEL_BATCH, AUG_MEL_FRAMES, 80):
        raise AssertionError(f"log-mel kernel returned {tuple(ker.shape)}")
    return mel_errors(ker, padded, log_mel_plain)


def mel_report(r) -> str:
    return (f"against the plain version in fp64 max_abs {r['max_abs']:.3e} over every band; "
            f"at most {r['used']:.3f} of a band's tolerance used (at a band of "
            f"{r['share']:.2e} of its frame's largest; tol {MEL_MAX_ABS:g} + "
            f"{MEL_FP32_NOISE:.3g} / sqrt(share)); the plain version in fp32 used at most "
            f"{r['plain_used']:.3f}")


# ---------------------------------------------------------------- phases


def phase_card():
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    log(out[0])  # name, power limit: exactly as nvidia-smi prints them
    log(f"torch: {torch.__version__} cuda {torch.version.cuda}; "
        f"device 0: {torch.cuda.get_device_name(0)}; count {torch.cuda.device_count()}")
    return out[0]


def phase_build():
    import torch

    from velocity_asr_tpu_torch.ops import cuda_lib
    from velocity_asr_tpu_torch.ops.mel import band_table

    lib = cuda_lib.library()
    log(f"kernel build: {lib.build_seconds:.3f} s (an nvcc per source in parallel, then a link) -> {os.path.relpath(lib.path, ROOT)}")
    for line in lib.build_log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    # what the card makes of the redesigned kernels
    first, _, weight = band_table()
    occ = lib.occupancy("log_mel_occupancy", first.size, weight.size)
    log(f"  occupancy log_mel_kernel: {occ}")
    # the forward's instantiations by states a thread, at a shape of the
    # paths that the launcher gives each: (1, 384, 32), (1, 384, 64) and
    # (16, 384, 64)
    for batch, state_dim in ((1, 32), (1, 64), (BATCH, 64)):
        for with_state in (False, True):
            for save_bounds in (False, True):
                occ = lib.occupancy("scan_fwd_occupancy", batch, 384, state_dim, int(with_state),
                                    int(save_bounds))
                log(f"  occupancy scan_fwd_kernel<S={occ['states_per_thread']}, "
                    f"kWithState={with_state}, kSaveBounds={save_bounds}> at (batch, D, N) = "
                    f"({batch}, 384, {state_dim}): {occ}")
    for lanes in (1, 2, 4, 8, 16):
        for with_state in (False, True):
            occ = lib.occupancy("scan_bwd_occupancy", lanes, int(with_state))
            log(f"  occupancy scan_bwd_kernel<G={lanes}, kWithState={with_state}> "
                f"({4 * lanes} states a pass): {occ}; one wave {occ['clusters']} clusters of 8 "
                f"= {8 * occ['clusters']} blocks on {torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    # the int8 kernels: each instantiation at the batched path's main shape,
    # then the grid at every distinct shape of its most common bucket and
    # at a K that runs in stages
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    main = (BATCH * INT8_MAIN_FRAMES // 2, 192, 192)
    for static in (False, True):
        for dtype, code in (("fp32", 0), ("bf16", 1)):
            occ = lib.occupancy("int8_dense_occupancy", int(static), code, *main)
            log(f"  occupancy int8_dense_kernel<kStatic={static}, x {dtype}> at (M, K, N) = "
                f"{main}: {occ}")
    shapes = sorted({(m, k, n) for _, m, k, n in int8_shapes(BATCH, INT8_MAIN_FRAMES)})
    for m, k, n in shapes + [(main[0], INT8_STAGED_K, 192)]:
        occ = lib.occupancy("int8_dense_occupancy", 0, 0, m, k, n)
        log(f"  int8 grid at (M, K, N) = {(m, k, n)}: {occ['blocks']} blocks of "
            f"{occ['threads']} threads, {occ['shared_bytes']} shared bytes, {occ['stages']} "
            f"stage(s) of K, {occ['blocks'] / (occ['blocks_per_sm'] * sms):.2f} waves of "
            f"{occ['blocks_per_sm']} x {sms} resident")
    occ = lib.occupancy("scan_bwd_occupancy", 16, 0)  # N = 64: 16 lanes of 4 states
    per_cluster = 8 * occ["threads"] // 16  # channels
    for shape in ((TRAIN_BATCH, 300, 384, 64), (STREAM_BATCH, 100, 384, 64)):
        grid = shape[0] * -(-shape[2] // per_cluster)
        log(f"  scan backward (batch, L, D, N) = {shape}: workspace "
            f"{4 * lib.lib.scan_bwd_workspace_floats(*shape) / 1e6:.3f} MB (cluster partials and "
            f"arrival counters); grid {grid} clusters of 8, {grid / occ['clusters']:.2f} waves of "
            f"the {occ['clusters']} resident")


def int8_inputs(rng, m, k, n, dtype="float32"):
    """x (M, K) with rows of differing loudness, in `dtype` (float32 or
    bfloat16: the batched path's model hands its projections bf16), and
    the codes and scales of a (N, K) weight, on the card."""
    import torch

    from velocity_asr_tpu_torch.ops.int8_matmul import quantize_weight

    loud = rng.uniform(0.25, 4.0, (m, 1))
    x = (rng.standard_normal((m, k)) * loud).astype(np.float32)
    w = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)
    w_q, w_scale = quantize_weight(torch.tensor(w, device="cuda"))
    return torch.tensor(x, device="cuda").to(getattr(torch, dtype)), w_q, w_scale


# a row's |x| max whose scale s = INT8_TIE_AMAX / 127 has a reciprocal
# that moves v * (1 / s) across a half-integer from v / s for about a third
# of the values near s (j + 1/2)
INT8_TIE_AMAX = 124.58155059814453
INT8_TIE_K = 768


def int8_tie_inputs(rng, m, n):
    """x (M, 768) fp32 whose every row holds INT8_TIE_AMAX and, for j =
    -127..126, s (j + 1/2) rounded to fp32 and its two neighbours (zeros
    for the rest), shuffled, times 1 or 2: every quotient v / s lies
    within an ulp of a half-integer, where the kernel's product by the
    scale's reciprocal gives way to the division. Returns x, the weights
    as int8_inputs does, and s (the static scale of the same grid)."""
    import torch

    from velocity_asr_tpu_torch.ops.int8_matmul import quantize_weight

    amax = np.float32(INT8_TIE_AMAX)
    s = amax / np.float32(127.0)
    near = (s * (np.arange(-127, 127) + 0.5)).astype(np.float32)
    vals = np.concatenate([np.nextafter(near, -np.inf), near, np.nextafter(near, np.inf)])
    vals = vals[np.abs(vals) <= amax].astype(np.float32)
    row = np.zeros(INT8_TIE_K, np.float32)
    row[:vals.size + 1] = np.concatenate([[amax], vals])
    x = np.stack([rng.permutation(row) * np.float32(1 + i % 2) for i in range(m)])
    w = (rng.standard_normal((n, INT8_TIE_K)) * 0.1).astype(np.float32)
    w_q, w_scale = quantize_weight(torch.tensor(w, device="cuda"))
    return torch.tensor(x, device="cuda"), w_q, w_scale, float(s)


def compare_int8(rng, m, k, n, static: bool, dtype="float32", ties=False):
    """Kernel against plain on one shape, x in `dtype` (or, with ties, the
    near-half-integer quotients of int8_tie_inputs at K = 768 and its
    static scale): (max_abs, max_rel, code diffs)."""
    import torch

    from velocity_asr_tpu_torch.ops.int8_matmul import (
        dynamic_scale, int8_dot, int8_dot_plain, quantize_activation, scale_of)

    if ties:
        x, w_q, w_scale, tie_scale = int8_tie_inputs(rng, m, n)
        k = x.shape[1]
        x_scale = torch.full((), tie_scale, device="cuda") if static else None
    else:
        x, w_q, w_scale = int8_inputs(rng, m, k, n, dtype)
        # a static scale that clips the loudest rows, as a calibrated one may
        x_scale = scale_of(x.abs().amax() * 0.8) if static else None
    codes = torch.empty(m, k, dtype=torch.int8, device="cuda")
    ker = int8_dot(x, w_q, w_scale, x_scale, codes_out=codes)
    torch.cuda.synchronize()
    ref = int8_dot_plain(x, w_q, w_scale, x_scale)
    ref_codes = quantize_activation(x, x_scale if static else dynamic_scale(x))
    code_diffs = int((codes != ref_codes).sum().item())
    max_abs = (ker - ref).abs().max().item()
    return max_abs, max_abs / ref.abs().max().item(), code_diffs


def scan_cases(plan):
    """(N, batch, length) of every scan that phases 4 and 5 launch (local
    blocks N=64 at L = frames / 2, global blocks N=32 at the level-1 pool
    size), phase 11's micro-batches at their largest (the server's
    --max-batch rows of one offline bucket) and phase 12b's long form (its
    batches at LONGFORM_BUCKET, its longest utterance at batch 1, and 72 s,
    LONG_FRAMES, at batch 1 and 16: L = 3,600, K1 = 450), then every width
    at batch 1 (the offline path) and 4."""
    from velocity_asr_tpu_torch.ops.pooling import pool_size_level1

    shapes = ([(b, f) for f in plan["offline"] for b in (1, SERVE_DEFAULT_STREAMS)]
              + list(plan["batched"]))
    shapes += list(plan["longform"]["batched"]) + [(1, plan["longform"]["longest_bucket"])]
    shapes += [(b, LONG_FRAMES) for b in (1, BATCH)]
    path = {(n, b, length) for b, f in shapes
            for n, length in ((64, f // 2), (32, pool_size_level1(f // 2)))}
    widths = {(n, b, 100) for n in SCAN_STATE_DIMS for b in (1, 4)}
    return sorted(path) + sorted(widths - path)


def phase_compare(plan):
    import torch

    from velocity_asr_tpu_torch.audio import N_FFT, frame_count, reflect_pad
    from velocity_asr_tpu_torch.ops.mel import log_mel, log_mel_plain
    from velocity_asr_tpu_torch.ops.scan import scan_fwd, scan_fwd_plain

    rng = np.random.default_rng(20261017)
    errs = dict.fromkeys(("scan_fwd_f32", "scan_fwd_state_f32", "log_mel_f32",
                          "int8_dense_dynamic_f32", "int8_dense_static_f32",
                          "scan_fwd_bounds_f32", "scan_bwd_f32", "scan_fwd_bounds_state_f32",
                          "scan_bwd_state_f32"), 0.0)
    for state_dim, batch, length in scan_cases(plan):
        args = scan_inputs(rng, length, state_dim, batch=batch)
        ker = scan_fwd(*args)
        torch.cuda.synchronize()
        ref = scan_fwd_plain(*args)
        max_abs = (ker - ref).abs().max().item()
        max_rel = max_abs / ref.abs().max().item()
        ok = math.isfinite(max_rel) and max_rel <= SCAN_MAX_REL
        log(f"scan N={state_dim} B={batch} L={length} D=384: max_abs {max_abs:.3e} "
            f"max_rel {max_rel:.3e} (tol rel {SCAN_MAX_REL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("scan kernel disagrees with its plain version")
        errs["scan_fwd_f32"] = max(errs["scan_fwd_f32"], max_abs)
    # the carried-state scan: every shape of the streaming path, the widths
    # at batch 1 and 4, then the seam
    path = set(plan["stream"]["shapes"])
    widths = {(b, 100, n) for n in STATE_SCAN_DIMS for b in (1, 4)}
    for batch, length, state_dim in sorted(path) + sorted(widths - path):
        max_abs, max_rel = compare_state_scan(rng, state_dim, batch, length)
        ok = math.isfinite(max_rel) and max_rel <= SCAN_MAX_REL
        log(f"state scan N={state_dim} B={batch} L={length} D=384{' (streaming path)' if (batch, length, state_dim) in path else ''}: "
            f"max_abs {max_abs:.3e} max_rel {max_rel:.3e} over y and h_final "
            f"(tol rel {SCAN_MAX_REL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("carried-state scan kernel disagrees with its plain version")
        errs["scan_fwd_state_f32"] = max(errs["scan_fwd_state_f32"], max_abs)
    for state_dim in sorted({n for _, _, n in path}):
        for batch in (1, 4):
            max_abs, max_rel, vs_one = compare_seam(rng, state_dim, batch)
            ok = max_rel <= SCAN_MAX_REL and vs_one <= SEAM_MAX_REL
            log(f"state scan seam N={state_dim} B={batch} L=100+100: vs plain max_abs "
                f"{max_abs:.3e} max_rel {max_rel:.3e} (tol {SCAN_MAX_REL:g}); vs one launch "
                f"max_rel {vs_one:.3e} (tol {SEAM_MAX_REL:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("carried-state scan breaks across a seam")
            errs["scan_fwd_state_f32"] = max(errs["scan_fwd_state_f32"], max_abs)
    # every forward entry where the last block of channels is partly empty,
    # at the three states-a-thread plans the paths use
    for batch in (1, STREAM_BATCH, BATCH):
        for state_dim in (64, 32):
            r = compare_odd_width(rng, batch, state_dim)
            ok = (math.isfinite(r["y"]) and r["y"] <= SCAN_MAX_REL and r["bounds"][1] <= BOUNDS_MAX_REL
                  and r["same"] and r["seam"] <= SEAM_MAX_REL)
            log(f"forward entries N={state_dim} B={batch} L=100 D={ODD_D_INNER}: y, h_final "
                f"max_rel {r['y']:.3e} (tol {SCAN_MAX_REL:g}); bounds max_rel {r['bounds'][1]:.3e} "
                f"(tol {BOUNDS_MAX_REL:g}); bounds entries' y, h_final "
                f"{'bit-equal to' if r['same'] else 'DIFFER from'} the no-bounds entries', "
                f"bounds[:, 0] = h0; seam 50+50 vs one launch max_rel {r['seam']:.3e} (tol "
                f"{SEAM_MAX_REL:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"the forward disagrees at d_inner {ODD_D_INNER}")
            for name in ("scan_fwd_f32", "scan_fwd_state_f32"):
                errs[name] = max(errs[name], r["y_abs"])
            for name in ("scan_fwd_bounds_f32", "scan_fwd_bounds_state_f32"):
                errs[name] = max(errs[name], r["bounds"][0])
    # the training scans: every training shape (forward and backward),
    # then the backward's widths at batch 1 and 4, L off the 16-step chunk
    bwd_widths = {(b, length, n) for n in BWD_SCAN_DIMS for b in (1, 4) for length in (37, 100)}
    for batch, length, state_dim in TRAIN_SCAN_SHAPES + sorted(bwd_widths):
        training = (batch, length, state_dim) in TRAIN_SCAN_SHAPES
        fwd, bwd, same = compare_train_scans(rng, state_dim, batch, length, forward=training)
        worst = max(e[1] for name, e in bwd.items() if name != "dA")
        ok = (same and math.isfinite(worst) and worst <= BWD_MAX_REL
              and bwd["dA"][1] <= BWD_DA_MAX_REL)
        line = (f"train scan N={state_dim} B={batch} L={length} D=384"
                f"{' (training path)' if training else ''}: ")
        if fwd is not None:
            y_same, b_rel, b_abs = fwd
            ok = ok and y_same and b_rel <= BOUNDS_MAX_REL
            line += (f"bounds fwd y {'bit-equal to' if y_same else 'DIFFERS from'} scan_fwd, "
                     f"bounds max_rel {b_rel:.3e} (tol {BOUNDS_MAX_REL:g}); ")
            errs["scan_fwd_bounds_f32"] = max(errs["scan_fwd_bounds_f32"], b_abs)
        line += ("bwd max_rel " + " ".join(f"{k} {e[1]:.2e}" for k, e in bwd.items())
                 + f" (tol {BWD_MAX_REL:g}, dA {BWD_DA_MAX_REL:g}), two calls of one launch "
                 f"each {'bit-identical' if same else 'DIFFER (or miscounted)'} "
                 f"{'ok' if ok else 'FAIL'}")
        log(line)
        if not ok:
            raise AssertionError("a training scan kernel disagrees with its plain version")
        errs["scan_bwd_f32"] = max([errs["scan_bwd_f32"]] + [e[0] for e in bwd.values()])
    # the carried-state training scans (rows 4s, 5s): every shape of the
    # streaming term, then the widths at batch 1 and 4, L off the 16-step
    # chunk, from a random h0 and gh
    state_widths = {(b, length, n) for n in STATE_SCAN_DIMS for b in (1, 4)
                    for length in (37, 100)}
    for batch, length, state_dim in STATE_TRAIN_SHAPES + sorted(state_widths):
        r = compare_train_state_scans(rng, state_dim, batch, length)
        bwd = r["bwd"]
        worst = max(e[1] for name, e in bwd.items() if name != "dA")
        ok = (r["fwd_same"] and r["bounds"][1] <= BOUNDS_MAX_REL and r["same"]
              and r["zero_same"] and math.isfinite(worst) and worst <= BWD_MAX_REL
              and bwd["dA"][1] <= BWD_DA_MAX_REL)
        path = " (streaming term)" if (batch, length, state_dim) in STATE_TRAIN_SHAPES else ""
        log(f"train state scan N={state_dim} B={batch} L={length} D=384{path}: y, h_final "
            f"{'bit-equal to' if r['fwd_same'] else 'DIFFER from'} scan_fwd_state, bounds[:, 0] "
            f"= h0, bounds max_rel {r['bounds'][1]:.3e} (tol {BOUNDS_MAX_REL:g}); bwd max_rel "
            + " ".join(f"{k} {e[1]:.2e}" for k, e in bwd.items())
            + f" (tol {BWD_MAX_REL:g}, dA {BWD_DA_MAX_REL:g}), two calls of one launch each "
            f"{'bit-identical' if r['same'] else 'DIFFER (or miscounted)'}; h0 = gh = 0 "
            f"{'bit-equal to' if r['zero_same'] else 'DIFFERS from'} the no-state kernels "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("a carried-state training kernel disagrees with its plain "
                                 "version or with the no-state kernels")
        errs["scan_fwd_bounds_state_f32"] = max(errs["scan_fwd_bounds_state_f32"],
                                                r["bounds"][0])
        errs["scan_bwd_state_f32"] = max([errs["scan_bwd_state_f32"]]
                                         + [e[0] for e in bwd.values()])
    for state_dim in (64, 32):
        for batch in (1, CHECK_BATCH):
            seam = compare_grad_seam(rng, state_dim, batch)
            ok = math.isfinite(seam) and seam <= GRAD_SEAM_MAX_REL
            log(f"train state scan gradient seam N={state_dim} B={batch} L=50+50 against one "
                f"launch of 100: max_rel {seam:.3e} over dx, ddt, dA, dB, dC, dh0 (tol "
                f"{GRAD_SEAM_MAX_REL:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("the carried-state gradient breaks across a seam")
    # the log-mel: the offline path's single utterances, the server's
    # micro-batches at their largest at every offline bucket, then every
    # batch of the device-mel training path (9a's, and 9b's at every bucket up
    # to STREAM_MAX_FRAMES), each one launch over batch x frames rows
    mel_shapes = ([(1, 200, ""), (1, 600, "")]
                  + [(SERVE_DEFAULT_STREAMS, f, " (serve micro-batch)")
                     for f in sorted(plan["offline"])]
                  + [(CHECK_BATCH, STREAM_CHECK_FRAMES, " (training path, 9a)")]
                  + [(STREAM_BATCH, f, " (training path, 9b)") for f in STREAM_BUCKETS]
                  + [(1, LONG_FRAMES, " (72 s)"),
                     (1, plan["longform"]["longest_bucket"], " (long form, batch 1, 12b)")]
                  + [(b, f, " (long form, batched)")
                     for b, f in sorted(plan["longform"]["batched"])])
    # held against the plain version run in fp64, each band within its
    # tolerance (MEL_MAX_ABS, widened by MEL_FP32_NOISE in bands far below
    # their frame's power); the plain version in fp32, held to the same
    # tolerance, is the reading of what fp32 rounding alone takes of it
    for batch, n_frames, path in mel_shapes:
        _, padded = mel_inputs(rng, n_frames, batch)
        ker = log_mel(padded)
        torch.cuda.synchronize()
        if ker.shape != (batch, n_frames, 80):
            raise AssertionError(f"log-mel kernel returned {tuple(ker.shape)}")
        r = mel_errors(ker, padded, log_mel_plain)
        ok = math.isfinite(r["max_abs"]) and r["used"] <= 1.0
        log(f"log_mel B={batch} T={n_frames} ({batch * n_frames} rows){path}: "
            + mel_report(r) + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("log-mel kernel disagrees with its plain version")
        errs["log_mel_f32"] = max(errs["log_mel_f32"], r["max_abs"])
    # a device-mel training batch as phase 12c's augmentation leaves it:
    # speed-warped, then noised over its valid samples
    r = compare_augmented_mel(rng)
    ok = math.isfinite(r["max_abs"]) and r["used"] <= 1.0
    log(f"log_mel B={AUG_MEL_BATCH} T={AUG_MEL_FRAMES} speed-warped and noised (training "
        f"path, 12c): " + mel_report(r) + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("log-mel kernel disagrees with its plain version on an augmented "
                             "batch")
    errs["log_mel_f32"] = max(errs["log_mel_f32"], r["max_abs"])
    # signals no longer than the 200-sample reflect pad (padded by the
    # repeated reflection). A 1-sample signal pads to a constant frame,
    # whose spectrum is zero in exact arithmetic past the window's lowest
    # bins: there the kernel's bands hold fp32 rounding noise, and the
    # tolerance's noise term covers them
    for n_samples in MEL_SHORT_SAMPLES:
        audio = torch.tensor((rng.standard_normal((1, n_samples)) * 0.1).astype(np.float32),
                             device="cuda")
        padded = reflect_pad(audio, N_FFT // 2)
        ker = log_mel(padded)
        torch.cuda.synchronize()
        r = mel_errors(ker, padded, log_mel_plain)
        ok = (ker.shape == (1, frame_count(n_samples), 80) and math.isfinite(r["max_abs"])
              and r["used"] <= 1.0)
        log(f"log_mel of {n_samples} samples ({ker.shape[1]} frames): " + mel_report(r)
            + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("log-mel kernel disagrees with its plain version on a short "
                                 "signal")
        errs["log_mel_f32"] = max(errs["log_mel_f32"], r["max_abs"])
    # every shape of the batched int8 path (each batch's size and padded
    # frames), the 400-frame shapes at batch 1 and 16, one 128-aligned
    # shape, one with K, M and N off every tile (K % 4 != 0: the byte-wise
    # weight path), and K past a block's shared memory (in stages), at a
    # ragged M and N and at the main shape's; x in fp32 and in bf16
    groups = {f"batch {b}, {f} frames (batched path)": int8_shapes(b, f)
              for b, f in sorted(plan["batched"])}
    for b in (1, BATCH):
        groups.setdefault(f"batch {b}, 400 frames", int8_shapes(b, 400))
    groups["aligned, ragged and widest K"] = (
        [("aligned", 256, 256, 256), ("ragged", 37, 50, 70), ("widest", 37, 1012, 70)]
        + [("wide", m, k, n) for k in INT8_WIDE_K
           for m, n in ((37, 70), (BATCH * INT8_MAIN_FRAMES // 2, 192))])
    for static, name in ((False, "int8_dense_dynamic_f32"), (True, "int8_dense_static_f32")):
        for dtype in ("float32", "bfloat16"):
            for group, projections in groups.items():
                shapes = sorted({(m, k, n) for _, m, k, n in projections})
                worst = (0.0, 0.0)
                for m, k, n in shapes:
                    max_abs, max_rel, code_diffs = compare_int8(rng, m, k, n, static, dtype)
                    ok = code_diffs == 0 and math.isfinite(max_rel) and max_rel <= INT8_MAX_REL
                    if not ok:
                        log(f"{name} x {dtype} M={m} K={k} N={n}: code diffs {code_diffs}, "
                            f"max_abs {max_abs:.3e} max_rel {max_rel:.3e} FAIL")
                        raise AssertionError(f"{name} disagrees with its plain version")
                    worst = max(worst, (max_rel, max_abs))
                    errs[name] = max(errs[name], max_abs)
                log(f"{name}, x {dtype}, {group}: {len(shapes)} shapes (M "
                    f"{min(s[0] for s in shapes)}-{max(s[0] for s in shapes)}, K "
                    f"{min(s[1] for s in shapes)}-{max(s[1] for s in shapes)}), codes identical, "
                    f"worst max_rel {worst[0]:.3e} (max_abs {worst[1]:.3e}; tol rel "
                    f"{INT8_MAX_REL:g}) ok")
        # quotients exactly at half-integers, where the kernel's product by
        # the scale's reciprocal gives way to the division
        for m, n in ((37, 70), (256, 192)):
            max_abs, max_rel, code_diffs = compare_int8(rng, m, INT8_TIE_K, n, static, ties=True)
            ok = code_diffs == 0 and math.isfinite(max_rel) and max_rel <= INT8_MAX_REL
            log(f"{name}, x float32, near ties (every v / s within an ulp of a half-integer) "
                f"M={m} K={INT8_TIE_K} N={n}: code diffs {code_diffs}, max_rel {max_rel:.3e} "
                f"(tol rel {INT8_MAX_REL:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} rounds a half-integer quotient otherwise")
            errs[name] = max(errs[name], max_abs)
    torch.cuda.synchronize()
    return errs


def read_jax_eval(path: str, refs):
    """The JAX package's predictions for the first len(refs) utterances of
    one of its eval files, checked against the regenerated references."""
    with open(path) as f:
        jax_rows = json.load(f)["results"][:len(refs)]
    if [r["reference"] for r in jax_rows] != list(refs):
        raise AssertionError(f"regenerated references differ from {os.path.basename(path)}'s")
    return [r["prediction"] for r in jax_rows]


def checkpoint_config():
    from velocity_asr_tpu_torch.models.config import VelocityASRConfig

    with open(os.path.join(CHECKPOINT, "config.json")) as f:
        return VelocityASRConfig.from_dict(json.load(f)["config"])


def streaming_plan(n_samples):
    """What the streaming path will launch on utterances of these lengths:
    each utterance's chunks (StreamingMel gives 1 + samples // 160 frames),
    each batched group's advancing steps (its longest utterance's chunks;
    a short group runs padded to the batch size, as in the JAX package),
    the carried-state scan shapes, and the exact launch counts: one scan
    per SSM block and advancing step, one more per local block and emit
    under lookahead 1 or 2 (every chunk is emitted once; the frozen global
    SSM does not run)."""
    cfg = checkpoint_config()
    chunks = [-(-(1 + n // 160) // CHUNK_FRAMES) for n in n_samples]
    steps = sum(max(chunks[s:s + BATCH]) for s in range(0, len(chunks), BATCH))
    per_step = cfg.ssm_layers + cfg.global_ssm_layers
    live_chunks = sum(chunks[:LIVE_UTTS])
    # batch 16 (the batched path, and the shared session step of phase 11
    # at --max-streams 16), 8 (the server's default --max-streams) and 1
    shapes = {(b, length, n) for b in (BATCH, SERVE_DEFAULT_STREAMS, 1)
              for length, n in ((CHUNK_FRAMES // 2, cfg.ssm_state_dim),
                                (cfg.stream_summary_tokens, cfg.global_ssm_state_dim))}
    with_emits = (per_step + cfg.ssm_layers) * steps
    return {"chunks": chunks, "steps": steps, "live_chunks": live_chunks,
            "shapes": sorted(shapes),
            "launches": {0: per_step * steps, 1: with_emits, 2: with_emits,
                         "live": per_step * live_chunks}}


def phase_corpus(tmp: str, n_utts: int):
    """Write the corpus and work out the shapes the paths will run on it:
    each utterance's frame bucket on the offline path, each batch's
    (size, padded frames) on the batched path, and the streaming plan."""
    from velocity_asr_tpu_torch import evaluate as ev
    from velocity_asr_tpu_torch import synth
    from velocity_asr_tpu_torch.audio import load_audio
    from velocity_asr_tpu_torch.transcribe import padded_frames

    t0 = time.perf_counter()
    manifest = synth.write_corpus(tmp, n_utts, split="test", seed=1234)
    log(f"corpus: {n_utts} utterances in {time.perf_counter() - t0:.3f} s")
    with open(manifest) as f:
        paths = [json.loads(line)["audio_path"] for line in f]
    n_samples = [len(load_audio(p)) for p in paths]
    offline = collections.Counter(padded_frames(n, FRAME_BUCKET) for n in n_samples)
    ds, n = ev.load_test_set(manifest)
    mel_lens = [int(ds[i]["input_lengths"]) for i in range(n)]
    batched = collections.Counter(
        (len(chunk), -(-max(chunk) // FRAME_BUCKET) * FRAME_BUCKET)
        for chunk in (mel_lens[s:s + BATCH] for s in range(0, n, BATCH)))
    stream = streaming_plan(n_samples)
    longform = longform_plan(tmp)
    log(f"offline frame buckets {dict(sorted(offline.items()))}; batched (size, padded "
        f"frames) {dict(sorted(batched.items()))}")
    log(f"streaming: chunks per utterance {dict(sorted(collections.Counter(stream['chunks']).items()))}; "
        f"{stream['steps']} advancing steps at batch {BATCH}, {stream['live_chunks']} live "
        f"chunks at batch 1; carried-state scan shapes (batch, L, N) {stream['shapes']}; "
        f"planned launches {stream['launches']}")
    return manifest, {"offline": offline, "batched": batched, "mel_lens": mel_lens,
                      "stream": stream, "longform": longform}


def longform_plan(tmp: str):
    """Write the 40-utterance long-form corpus (40-72 s each) and work out
    what phases 7 and 12b run on it: its streaming plan, the batched
    evaluation's (size, padded frames) at LONGFORM_BUCKET, and its longest
    utterance's frame bucket at batch 1 (the transcriber's buckets of
    FRAME_BUCKET frames)."""
    from velocity_asr_tpu_torch import synth
    from velocity_asr_tpu_torch.audio import load_audio
    from velocity_asr_tpu_torch.transcribe import padded_frames

    t0 = time.perf_counter()
    manifest = synth.write_corpus(os.path.join(tmp, "longform"), LONGFORM_UTTS, split="longform",
                                  seed=1234, min_words=LONGFORM_WORDS[0],
                                  max_words=LONGFORM_WORDS[1])
    with open(manifest) as f:
        paths = [json.loads(line)["audio_path"] for line in f]
    n_samples = [len(load_audio(p)) for p in paths]
    frames = [1 + n // 160 for n in n_samples]  # the host mel's frames
    batched = collections.Counter(
        (len(chunk), -(-max(chunk) // LONGFORM_BUCKET) * LONGFORM_BUCKET)
        for chunk in (frames[s:s + BATCH] for s in range(0, len(frames), BATCH)))
    longest = int(np.argmax(n_samples))
    out = {"manifest": manifest, "n_samples": n_samples, "stream": streaming_plan(n_samples),
           "batched": batched, "longest": longest,
           "longest_bucket": padded_frames(n_samples[longest], FRAME_BUCKET)}
    log(f"long form: {len(paths)} utterances of {min(n_samples) / 16000:.1f}-"
        f"{max(n_samples) / 16000:.1f} s written in {time.perf_counter() - t0:.3f} s; batched "
        f"at bucket {LONGFORM_BUCKET} (size, padded frames) {dict(sorted(batched.items()))}; the "
        f"longest ({n_samples[longest]} samples) at batch 1 pads to {out['longest_bucket']} frames")
    return out


def phase_main_path(manifest: str, plan):
    import torch

    from velocity_asr_tpu_torch.audio import load_audio
    from velocity_asr_tpu_torch.ops.cuda_lib import launch_counts, reset_launch_counts
    from velocity_asr_tpu_torch.training import compute_cer, compute_wer
    from velocity_asr_tpu_torch.transcribe import load_transcriber

    with open(manifest) as f:
        rows = [json.loads(line) for line in f]
    n_utts = len(rows)
    t0 = time.perf_counter()
    tr = load_transcriber(CHECKPOINT, device="cuda")
    cfg = tr.model.config
    log(f"checkpoint: {os.path.relpath(CHECKPOINT, ROOT)} d_model {cfg.d_model} "
        f"layers {cfg.ssm_layers}+{cfg.global_ssm_layers} dtype {cfg.dtype} "
        f"scan_mode {cfg.scan_mode} in {time.perf_counter() - t0:.3f} s")

    # Warm up outside the counted run (allocator, cuBLAS handles).
    tr.transcribe_file(rows[0]["audio_path"])
    torch.cuda.synchronize()

    reset_launch_counts()
    t0 = time.perf_counter()
    preds = [tr.transcribe_file(r["audio_path"])["text"] for r in rows]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(launch_counts)
    buckets = plan["offline"]

    refs = [r["text"] for r in rows]
    wer, cer = compute_wer(preds, refs), compute_cer(preds, refs)
    jax_preds = read_jax_eval(JAX_EVAL, refs)
    jax_wer, jax_cer = compute_wer(jax_preds, refs), compute_cer(jax_preds, refs)
    same = sum(p == q for p, q in zip(preds, jax_preds))
    log(f"main path: {n_utts} utterances in {seconds:.3f} s "
        f"({seconds / n_utts * 1e3:.3f} ms/utterance); buckets {dict(sorted(buckets.items()))}")
    log(f"WER {wer * 100:.4f}% CER {cer * 100:.4f}% | JAX (eval_fp32_final.json, same "
        f"{n_utts}) WER {jax_wer * 100:.4f}% CER {jax_cer * 100:.4f}% | "
        f"identical transcripts {same}/{n_utts}")
    log(f"launches: {counts}; per forward: scan {counts.get('scan_fwd_f32', 0) / n_utts:g}, "
        f"log_mel {counts.get('log_mel_f32', 0) / n_utts:g}")
    if counts.get("scan_fwd_f32", 0) != 10 * n_utts:
        raise AssertionError("expected 10 scan launches per forward")
    if counts.get("log_mel_f32", 0) != n_utts:
        raise AssertionError("expected 1 log-mel launch per utterance")
    if abs(wer - jax_wer) > WER_MAX_DIFF:
        raise AssertionError(f"WER {wer:.4f} is more than {WER_MAX_DIFF} from JAX {jax_wer:.4f}")

    # One utterance's logits: finite, of the expected shape, and the
    # card's fp32 model against the same model on the CPU.
    audio = load_audio(rows[0]["audio_path"])
    padded, n_frames = tr._pad_audio(audio)
    wire = torch.from_numpy(tr._to_wire(padded))
    logits = tr.masked_logits(wire.cuda(), n_frames)
    want = (1, (1 + padded.shape[1] // 160 + 1) // 2, cfg.vocab_size)
    if tuple(logits.shape) != want or not torch.isfinite(logits).all():
        raise AssertionError(f"logits {tuple(logits.shape)} (want {want}) or not finite")
    out_len = (n_frames + 1) // 2
    f32 = [load_transcriber(CHECKPOINT, device=d, dtype="float32") for d in ("cuda", "cpu")]
    lg = [t.masked_logits(wire.to(t.device), n_frames)[:, :out_len].cpu() for t in f32]
    max_abs = (lg[0] - lg[1]).abs().max().item()
    agree = (lg[0].argmax(-1) == lg[1].argmax(-1)).float().mean().item()
    log(f"fp32 logits card vs CPU (utterance 0, {out_len} frames): max_abs {max_abs:.3e} "
        f"(tol {LOGITS_FP32_MAX_ABS:g}), argmax agreement {agree:.4f}")
    if not max_abs <= LOGITS_FP32_MAX_ABS:
        raise AssertionError("card logits disagree with the CPU")
    return counts, buckets.most_common(1)[0][0], preds


def phase_batched(manifest: str, plan):
    """The batched evaluation in its three modes; returns each mode's
    launch counts, batch count and most common padded length."""
    import torch

    from velocity_asr_tpu_torch import evaluate as ev
    from velocity_asr_tpu_torch.data import ASRCollator
    from velocity_asr_tpu_torch.models.model import from_pretrained
    from velocity_asr_tpu_torch.ops.cuda_lib import launch_counts, reset_launch_counts
    from velocity_asr_tpu_torch.training import compute_cer, compute_wer
    from velocity_asr_tpu_torch.transcribe import checkpoint_decoder

    ds, n = ev.load_test_set(manifest)
    collator = ASRCollator(frame_bucket=FRAME_BUCKET, target_bucket=1)
    n_batches = -(-n // BATCH)
    mel_lens = plan["mel_lens"]
    buckets = collections.Counter()
    for (_, frames), count in plan["batched"].items():
        buckets[frames] += count
    log(f"batched path: {n} utterances in {n_batches} batches of up to {BATCH}; padded frames "
        f"per batch {dict(sorted(buckets.items()))}")
    modes = {"bf16": {}, "int8": {"int8_inference": True},
             "int8_static": {"int8_inference": True, "int8_static": True}}
    int8_kernel = {"bf16": None, "int8": "int8_dense_dynamic_f32",
                   "int8_static": "int8_dense_static_f32"}
    out = {}
    for mode, overrides in modes.items():
        model = from_pretrained(CHECKPOINT, device="cuda", **overrides)
        decoder = checkpoint_decoder(CHECKPOINT, model.config.vocab_size)
        if mode == "int8_static":
            t0 = time.perf_counter()
            n_calib = ev.calibrate(model, ds, n, collator, BATCH, calib_batches=8)
            log(f"[{mode}] calibrated on {n_calib} utterances in {time.perf_counter() - t0:.3f} s")
        ev.evaluate(model, decoder, ds, min(n, BATCH), collator, BATCH)  # warm-up, not counted
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = ev.evaluate(model, decoder, ds, n, collator, BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launch_counts)
        preds = [r["prediction"] for r in res["results"]]
        refs = [r["reference"] for r in res["results"]]
        jax_preds = read_jax_eval(JAX_BATCH_EVALS[mode], refs)
        jax_wer, jax_cer = compute_wer(jax_preds, refs), compute_cer(jax_preds, refs)
        same = sum(p == q for p, q in zip(preds, jax_preds))
        log(f"[{mode}] batch {BATCH}, bucket {FRAME_BUCKET}: WER {res['wer'] * 100:.4f}% "
            f"CER {res['cer'] * 100:.4f}% | JAX ({os.path.basename(JAX_BATCH_EVALS[mode])}, "
            f"same {n}) WER {jax_wer * 100:.4f}% CER {jax_cer * 100:.4f}% | identical "
            f"transcripts {same}/{n} | {wall / n * 1e3:.3f} ms/utterance with host mel, "
            f"{res['seconds'] / n * 1e3:.3f} ms/utterance model and decode")
        log(f"[{mode}] launches over {n_batches} batches: {counts}")
        want = {"scan_fwd_f32": 10 * n_batches}
        if int8_kernel[mode]:
            want[int8_kernel[mode]] = 11 * n_batches
        if counts != want:
            raise AssertionError(f"[{mode}] launches {counts}, expected {want}")
        if abs(res["wer"] - jax_wer) > WER_MAX_DIFF:
            raise AssertionError(f"[{mode}] WER {res['wer']:.4f} is more than {WER_MAX_DIFF} "
                                 f"from JAX {jax_wer:.4f}")
        out[mode] = {"counts": counts, "batches": n_batches,
                     "bucket": buckets.most_common(1)[0][0], "wer": res["wer"]}

    # int8-dynamic logits at fp32, one 400-frame batch of 4: card vs CPU
    items = [ds[i] for i in range(n) if mel_lens[i] <= 400][:4]
    batch = ASRCollator(frame_bucket=400, target_bucket=1)(items)
    if batch["mel_spectrogram"].shape != (4, 400, 80):
        raise AssertionError(f"batch shape {batch['mel_spectrogram'].shape}")
    mel, lens = (torch.from_numpy(batch[k]) for k in ("mel_spectrogram", "input_lengths"))
    lg = [ev.masked_logits(from_pretrained(CHECKPOINT, device=device, dtype="float32", **q),
                           mel.to(device), lens.to(device)).cpu()
          for device, q in (("cuda", modes["int8"]), ("cpu", modes["int8"]), ("cpu", {}))]
    if not torch.isfinite(lg[0]).all():
        raise AssertionError("int8 logits on the card are not finite")
    max_abs = (lg[0] - lg[1]).abs().max().item()
    step = (lg[2] - lg[1]).abs().max().item()
    agree = (lg[0].argmax(-1) == lg[1].argmax(-1)).float().mean().item()
    log(f"int8-dynamic fp32 logits card vs CPU (4 x 400 frames): max_abs {max_abs:.3e} "
        f"(tol: the CPU's int8-vs-fp32 gap {step:.3e}), argmax agreement {agree:.4f} "
        f"(tol {LOGITS_INT8_MIN_AGREE:g})")
    if not (max_abs < step and agree >= LOGITS_INT8_MIN_AGREE):
        raise AssertionError("int8 card logits disagree with the CPU")
    return out


def phase_streaming(manifest: str, plan):
    """The streaming path: batched at lookahead 0, 1 and 2, then the
    long-form corpus, then live sessions, then two chunks at fp32 card
    against CPU. Returns each counted run's launch counts, the batched
    runs' WER by lookahead and their transcripts."""
    import torch

    from velocity_asr_tpu_torch.audio import load_audio
    from velocity_asr_tpu_torch.models.model import from_pretrained
    from velocity_asr_tpu_torch.ops.cuda_lib import launch_counts, reset_launch_counts
    from velocity_asr_tpu_torch.streaming import (BatchedStreamingTranscriber,
                                                  StreamingTranscriber, init_stream_state)
    from velocity_asr_tpu_torch.training import compute_cer, compute_wer
    from velocity_asr_tpu_torch.transcribe import checkpoint_decoder

    with open(manifest) as f:
        rows = [json.loads(line) for line in f]
    audios = [load_audio(r["audio_path"]) for r in rows]
    refs = [r["text"] for r in rows]
    n = len(rows)
    stream = plan["stream"]
    model = from_pretrained(CHECKPOINT, device="cuda")
    decoder = checkpoint_decoder(CHECKPOINT, model.config.vocab_size)
    out, wers = {}, {}
    batched_texts = {}
    for lookahead in (0, 1, 2):
        bt = BatchedStreamingTranscriber(model, decoder, chunk_frames=CHUNK_FRAMES,
                                         batch_size=BATCH, lookahead_chunks=lookahead)
        bt.transcribe_batch(audios[:BATCH])  # warm-up, not counted
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        texts = bt.transcribe_batch(audios)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launch_counts)
        wer, cer = compute_wer(texts, refs), compute_cer(texts, refs)
        jax_path = JAX_STREAM_EVALS[lookahead]
        jax_preds = read_jax_eval(jax_path, refs)
        jax_wer, jax_cer = compute_wer(jax_preds, refs), compute_cer(jax_preds, refs)
        same = sum(p == q for p, q in zip(texts, jax_preds))
        log(f"[streaming la{lookahead}] batch {BATCH}, {CHUNK_FRAMES}-frame chunks: WER "
            f"{wer * 100:.4f}% CER {cer * 100:.4f}% | JAX ({os.path.basename(jax_path)}, same "
            f"{n}) WER {jax_wer * 100:.4f}% CER {jax_cer * 100:.4f}% | identical transcripts "
            f"{same}/{n} | {wall / n * 1e3:.3f} ms/utterance with the host mel "
            f"({wall:.3f} s for {stream['steps']} advancing steps)")
        want = {"scan_fwd_state_f32": stream["launches"][lookahead]}
        log(f"[streaming la{lookahead}] launches {counts}, planned {want}")
        if counts != want:
            raise AssertionError(f"[streaming la{lookahead}] launches {counts}, expected {want}")
        if abs(wer - jax_wer) > WER_MAX_DIFF:
            raise AssertionError(f"[streaming la{lookahead}] WER {wer:.4f} is more than "
                                 f"{WER_MAX_DIFF} from JAX {jax_wer:.4f}")
        out[lookahead] = counts
        wers[lookahead] = wer
        batched_texts[lookahead] = texts

    out["longform"] = streaming_longform(model, decoder, plan["longform"])

    # live sessions, fed 0.1 s blocks, each advancing step timed to its sync
    st = StreamingTranscriber(model, decoder, chunk_frames=CHUNK_FRAMES)
    step_ms = []
    advance = st._advance_chunk

    def timed_advance(chunk, offset, valid=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = advance(chunk, offset, valid)  # ends in the argmax's copy to the host
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    st._advance_chunk = timed_advance
    st.feed(audios[0][:CHUNK_FRAMES * 160])  # warm-up, not counted
    st.finish()
    step_ms.clear()
    live = []
    reset_launch_counts()
    for audio in audios[:LIVE_UTTS]:
        st.reset()
        text = "".join(st.feed(audio[i:i + LIVE_BLOCK]) for i in range(0, len(audio), LIVE_BLOCK))
        live.append(text + st.finish())
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    want = {"scan_fwd_state_f32": stream["launches"]["live"]}
    agree = sum(a == b for a, b in zip(live, batched_texts[0]))
    log(f"[streaming live] {LIVE_UTTS} sessions fed {LIVE_BLOCK}-sample blocks: {agree}/"
        f"{LIVE_UTTS} transcripts identical to the batched lookahead-0 path (need "
        f"{LIVE_MIN_AGREE}); advancing step at batch 1 over {len(step_ms)} chunks: p50 "
        f"{np.percentile(step_ms, 50):.3f} ms, p95 {np.percentile(step_ms, 95):.3f} ms")
    log(f"[streaming live] launches {counts}, planned {want}")
    if counts != want:
        raise AssertionError(f"[streaming live] launches {counts}, expected {want}")
    if agree < LIVE_MIN_AGREE:
        raise AssertionError("live sessions disagree with the batched streaming path")
    out["live"] = counts

    # two chunks of utterance 0 at fp32: card against CPU, logits and state
    audio = audios[0]
    mel = np.concatenate([BatchedStreamingTranscriber(
        model, decoder, chunk_frames=CHUNK_FRAMES)._causal_mel_raw(audio)[0],
        np.zeros((2 * CHUNK_FRAMES, 80), np.float32)])[: 2 * CHUNK_FRAMES]
    results = []
    for device in ("cuda", "cpu"):
        m = from_pretrained(CHECKPOINT, device=device, dtype="float32")
        state = init_stream_state(m.config, 1, device)
        logits = []
        with torch.inference_mode():
            for c in range(2):
                chunk = torch.from_numpy(mel[None, c * CHUNK_FRAMES:(c + 1) * CHUNK_FRAMES])
                lg, state = m(chunk.to(device), stream_state=state,
                              time_offset=c * CHUNK_FRAMES // 2, return_state=True)
                logits.append(lg.cpu())
        leaves = [state["mel_carry"], state["gc_mem"]] + [
            t for b in state["blocks"] + state["gc_blocks"] for t in b.values()]
        results.append((torch.cat(logits, dim=1), [t.cpu() for t in leaves]))
    (lg_card, st_card), (lg_cpu, st_cpu) = results
    if not torch.isfinite(lg_card).all():
        raise AssertionError("streaming logits on the card are not finite")
    lg_err = (lg_card - lg_cpu).abs().max().item()
    st_err = max((a - b).abs().max().item() for a, b in zip(st_card, st_cpu))
    log(f"[streaming fp32] 2 chunks, card vs CPU: logits max_abs {lg_err:.3e} (tol "
        f"{LOGITS_FP32_MAX_ABS:g}), state leaves max_abs {st_err:.3e} (tol {STATE_FP32_MAX_ABS:g})")
    if not (lg_err <= LOGITS_FP32_MAX_ABS and st_err <= STATE_FP32_MAX_ABS):
        raise AssertionError("streaming card logits or state disagree with the CPU")
    return out, wers, batched_texts


def streaming_longform(model, decoder, longform):
    """7, long form: the 40-utterance long-form corpus (40-72 s each)
    through the batched streaming path at 2 s chunks and lookahead 0,
    held over all 40 to the JAX package's eval_longform_streaming.json,
    with the planned carried-state launches; returns the launch counts."""
    import torch

    from velocity_asr_tpu_torch.audio import load_audio
    from velocity_asr_tpu_torch.ops.cuda_lib import launch_counts, reset_launch_counts
    from velocity_asr_tpu_torch.streaming import BatchedStreamingTranscriber

    with open(longform["manifest"]) as f:
        rows = [json.loads(line) for line in f]
    audios = [load_audio(r["audio_path"]) for r in rows]
    plan = longform["stream"]
    seconds = [len(a) / 16000 for a in audios]
    log(f"[streaming long form] {len(rows)} utterances of {min(seconds):.1f}-{max(seconds):.1f} s; "
        f"chunks per utterance "
        f"{min(plan['chunks'])}-{max(plan['chunks'])}, {plan['steps']} advancing steps at "
        f"batch {BATCH}")
    bt = BatchedStreamingTranscriber(model, decoder, chunk_frames=CHUNK_FRAMES, batch_size=BATCH)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    texts = bt.transcribe_batch(audios)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    check_wer("streaming long form", texts, [r["text"] for r in rows], JAX_LONGFORM_EVAL)
    log(f"[streaming long form] {wall:.3f} s for {sum(seconds):.1f} s of audio")
    expect_launches("streaming long form", counts, {"scan_fwd_state_f32": plan["launches"][0]})
    return counts


def expect_launches(tag, counts, want):
    log(f"[{tag}] launches {counts}, planned {want}")
    if counts != want:
        raise AssertionError(f"[{tag}] launches {counts}, expected {want}")


def check_wer(tag, texts, refs, jax_path):
    """Log the WER beside the JAX package's over the same utterances and
    the count of identical transcripts; fail past WER_MAX_DIFF."""
    from velocity_asr_tpu_torch.training import compute_cer, compute_wer

    wer, cer = compute_wer(texts, refs), compute_cer(texts, refs)
    jax_preds = read_jax_eval(jax_path, refs)
    jax_wer, jax_cer = compute_wer(jax_preds, refs), compute_cer(jax_preds, refs)
    same = sum(p == q for p, q in zip(texts, jax_preds))
    log(f"[{tag}] WER {wer * 100:.4f}% CER {cer * 100:.4f}% | JAX ({os.path.basename(jax_path)}, "
        f"same {len(refs)}) WER {jax_wer * 100:.4f}% CER {jax_cer * 100:.4f}% | identical "
        f"transcripts {same}/{len(refs)}")
    if abs(wer - jax_wer) > WER_MAX_DIFF:
        raise AssertionError(f"[{tag}] WER {wer:.4f} is more than {WER_MAX_DIFF} from JAX "
                             f"{jax_wer:.4f}")
    return wer


def beam_card_vs_cpu(ds, n, collator, decoder, chunk_out):
    """10a: one batch's masked fp32 logits on the card, beamed on the card,
    on the CPU, by the host backend and by chunked resume; returns the
    card's logits (for the timing of 10e)."""
    import torch

    from velocity_asr_tpu_torch import evaluate as ev
    from velocity_asr_tpu_torch.beam import (beam_state_init, ctc_beam_resume,
                                             ctc_beam_search_torch)
    from velocity_asr_tpu_torch.models.model import from_pretrained

    batch = collator([ds[i] for i in range(min(n, BATCH))])
    mel = torch.from_numpy(batch["mel_spectrogram"]).cuda()
    lens = torch.from_numpy(batch["input_lengths"]).cuda()
    model = from_pretrained(CHECKPOINT, device="cuda", dtype="float32")
    logits = ev.masked_logits(model, mel, lens)
    host_logits = logits.cpu()
    if not torch.isfinite(host_logits).all():
        raise AssertionError("[beam 10a] logits on the card are not finite")
    b, t_len, _ = logits.shape
    card = [x.cpu() for x in ctc_beam_search_torch(logits, BEAM_WIDTH)]
    cpu = ctc_beam_search_torch(host_logits, BEAM_WIDTH)
    same_tokens = torch.equal(card[0], cpu[0]) and torch.equal(card[1], cpu[1])
    filled = cpu[2] > -1e29
    score_err = (card[2] - cpu[2])[filled].abs().max().item()
    host = decoder.decode_beam_search(host_logits, beam_width=BEAM_WIDTH, backend="host",
                                      return_all_beams=True)
    best = [card[0][i, 0, :card[1][i, 0]].tolist() for i in range(b)]
    host_same = sum(h[0].tokens == w for h, w in zip(host, best))
    # phase 7's chunking: chunk_out output frames a chunk, each row valid
    # for its own output frames
    out_lens = ((lens + 1) // 2).cpu().numpy()
    state = beam_state_init(b, BEAM_WIDTH, t_len, device="cuda")
    for c in range(-(-t_len // chunk_out)):
        lo = c * chunk_out
        state = ctc_beam_resume(state, logits[:, lo:lo + chunk_out],
                                np.clip(out_lens - lo, 0, chunk_out), frame_base=lo)
    resume = [state[key].cpu() for key in ("prefixes", "lengths", "scores")]
    resume_same = torch.equal(resume[0], card[0]) and torch.equal(resume[1], card[1])
    resume_err = (resume[2] - card[2])[filled].abs().max().item()
    log(f"[beam 10a] {b} x {t_len} frames fp32 logits, k {BEAM_WIDTH}: card vs CPU tokens and "
        f"lengths {'identical' if same_tokens else 'DIFFER'} in every slot, filled slots "
        f"{int(filled.sum())}/{filled.numel()}, scores max_abs {score_err:.3e} (tol "
        f"{BEAM_SCORE_MAX_ABS:g}); host backend's best identical for {host_same}/{b}; resume "
        f"over {chunk_out}-frame chunks vs one-shot on the card: tokens and lengths "
        f"{'identical' if resume_same else 'DIFFER'}, scores max_abs {resume_err:.3e}")
    if not (same_tokens and score_err <= BEAM_SCORE_MAX_ABS):
        raise AssertionError("[beam 10a] the card's beams disagree with the CPU's")
    if host_same != b:
        raise AssertionError("[beam 10a] the host backend's best hypotheses differ")
    if not (resume_same and resume_err <= BEAM_SCORE_MAX_ABS):
        raise AssertionError("[beam 10a] the chunked resume differs from the one-shot search")
    return logits


def profile_on_card(fn):
    """fn's median host time to a synchronise over BEAM_TIMING_REPS calls
    (after a warm-up), and one call under torch.profiler: (ms, the device
    operations, their device ms, the times)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    times = []
    for _ in range(BEAM_TIMING_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    return (float(np.median(times)), sum(e.count for e in events),
            sum(device_us(e) for e in events) / 1e3, times)


def time_beam_decode(logits, chunk_out):
    """10e: the beam decode alone on the card, model excluded: the one-shot
    search on (a)'s batch; and the live path's beam work at batch 1 on its
    first row: a StreamingBeam's update and commit over chunk_out-frame
    chunks (span tracks on, a host transfer per commit)."""
    from velocity_asr_tpu_torch.beam import StreamingBeam, ctc_beam_search_torch

    b, t_len, _ = logits.shape
    ms, ops, device_ms, times = profile_on_card(lambda: ctc_beam_search_torch(logits,
                                                                             BEAM_WIDTH))
    log(f"[beam 10e] beam decode alone, k {BEAM_WIDTH}, batch {b} x {t_len} frames: {ms:.3f} ms "
        f"a batch (median of {BEAM_TIMING_REPS}: {', '.join(f'{x:.3f}' for x in times)}), "
        f"{ms / t_len:.4f} ms a frame; under the profiler {ops} device operations "
        f"({ops / t_len:.1f} a frame), device time {device_ms:.3f} ms (card busy "
        f"{device_ms / ms * 100:.1f}% of the untraced call)")
    row = logits[:1]

    def live_beam():
        sb = StreamingBeam(1, BEAM_WIDTH, device=row.device)
        for lo in range(0, t_len, chunk_out):
            sb.update(row[:, lo:lo + chunk_out], min(chunk_out, t_len - lo), frame_base=lo)
            sb.commit()

    l_ms, l_ops, l_device_ms, l_times = profile_on_card(live_beam)
    chunks = -(-t_len // chunk_out)
    log(f"[beam 10e] live beam alone, k {BEAM_WIDTH}, batch 1 x {t_len} frames in {chunks} "
        f"chunks (update and commit): {l_ms:.3f} ms ({l_ms / chunks:.3f} ms a chunk, "
        f"{l_ms / t_len:.4f} ms a frame; median of {BEAM_TIMING_REPS}: "
        f"{', '.join(f'{x:.3f}' for x in l_times)}); under the profiler {l_ops} device "
        f"operations ({l_ops / t_len:.1f} a frame), device time {l_device_ms:.3f} ms (card busy "
        f"{l_device_ms / l_ms * 100:.1f}%)")
    return {"ms": ms, "frames": t_len, "ops_per_frame": ops / t_len, "device_ms": device_ms,
            "live_chunk_ms": l_ms / chunks}


def live_sessions(st, audios):
    """Feed each utterance to the live session in LIVE_BLOCK-sample blocks;
    returns the transcripts and each chunk step's ms (advance and decode,
    from a synchronise before the advance to one after the decode), and
    whether any session's beam overflowed."""
    import torch

    advance, consume = st._advance_chunk, st._consume
    step_ms, start, overflow = [], [0.0], False

    def timed_advance(chunk, offset, valid=None):
        torch.cuda.synchronize()
        start[0] = time.perf_counter()
        return advance(chunk, offset, valid)

    def timed_consume(out, out_valid, base):
        consume(out, out_valid, base)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - start[0]) * 1e3)

    st._advance_chunk, st._consume = timed_advance, timed_consume
    texts = []
    for audio in audios:
        st.reset()
        text = "".join(st.feed(audio[i:i + LIVE_BLOCK]) for i in range(0, len(audio), LIVE_BLOCK))
        texts.append(text + st.finish())
        overflow |= st._sbeam is not None and st._sbeam.overflowed
    return texts, step_ms, overflow


def phase_beam(manifest: str, plan):
    """Beam search (k = 8) on the card: 10a card against CPU, 10b batched
    accuracy and launches, 10c streaming, 10d live, 10e timings. Returns
    each counted run's launch counts and the timings."""
    import torch

    from velocity_asr_tpu_torch import evaluate as ev
    from velocity_asr_tpu_torch.audio import load_audio
    from velocity_asr_tpu_torch.data import ASRCollator
    from velocity_asr_tpu_torch.lm import CharNGramLM
    from velocity_asr_tpu_torch.models.model import from_pretrained
    from velocity_asr_tpu_torch.ops.cuda_lib import launch_counts, reset_launch_counts
    from velocity_asr_tpu_torch.streaming import (BatchedStreamingTranscriber,
                                                  StreamingTranscriber)
    from velocity_asr_tpu_torch.transcribe import checkpoint_decoder

    ds, n = ev.load_test_set(manifest)
    collator = ASRCollator(frame_bucket=FRAME_BUCKET, target_bucket=1)
    model = from_pretrained(CHECKPOINT, device="cuda")
    decoder = checkpoint_decoder(CHECKPOINT, model.config.vocab_size)
    t0 = time.perf_counter()
    lm = CharNGramLM.load(LM_PATH)
    log(f"[beam] LM {os.path.relpath(LM_PATH, ROOT)}: order {lm.order}, loaded in "
        f"{time.perf_counter() - t0:.3f} s")
    chunk_out = CHUNK_FRAMES // 2
    logits = beam_card_vs_cpu(ds, n, collator, decoder, chunk_out)

    # 10b: the batched evaluation's beam modes
    n_batches = -(-n // BATCH)
    modes = {"beam8": {}, "beam8_lm": {"lm": lm, "lm_weight": LM_WEIGHT},
             "oracle_w2": {"oracle": True, "hotword_weight": 2.0},
             "oracle_w4": {"oracle": True, "hotword_weight": 4.0}}
    out = {"batched": {}, "stream": {}}
    beam_seconds = []
    beam_texts = ev.beam_texts

    def timed_beam_texts(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        texts = beam_texts(*args, **kw)  # ends on the host
        beam_seconds.append(time.perf_counter() - t)
        return texts

    for mode, kw in modes.items():
        scorer_for = ev.fusion_scorer_for(decoder, **kw)
        ev.evaluate(model, decoder, ds, min(n, BATCH), collator, BATCH, beam_width=BEAM_WIDTH,
                    scorer_for=scorer_for)  # warm-up, not counted
        torch.cuda.synchronize()
        if mode == "beam8":
            ev.beam_texts = timed_beam_texts
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            res = ev.evaluate(model, decoder, ds, n, collator, BATCH, beam_width=BEAM_WIDTH,
                              scorer_for=scorer_for)
        finally:
            ev.beam_texts = beam_texts
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launch_counts)
        tag = f"beam 10b {mode}"
        check_wer(tag, [r["prediction"] for r in res["results"]],
                  [r["reference"] for r in res["results"]], JAX_BEAM_EVALS[mode])
        log(f"[{tag}] batch {BATCH}: {wall:.3f} s ({wall / n * 1e3:.3f} ms/utterance with host "
            f"mel), {res['seconds'] / n * 1e3:.3f} ms/utterance model, beam and pick")
        if mode == "beam8":
            share = sum(beam_seconds) / wall
            log(f"[{tag}] beam decode (to the host texts) {sum(beam_seconds):.3f} s of the "
                f"evaluation's {wall:.3f} s wall time ({share * 100:.1f}%), "
                f"{sum(beam_seconds) / n_batches * 1e3:.3f} ms a batch over {n_batches}")
            out["share"] = share
        expect_launches(tag, counts, {"scan_fwd_f32": 10 * n_batches})
        out["batched"][mode] = counts

    # 10c: the batched streaming path's beam modes
    with open(manifest) as f:
        rows = [json.loads(line) for line in f]
    audios = [load_audio(r["audio_path"]) for r in rows]
    refs = [r["text"] for r in rows]
    stream = plan["stream"]
    stream_texts = None
    for (lookahead, with_lm), jax_path in JAX_STREAM_BEAM_EVALS.items():
        tag = f"beam 10c la{lookahead}{' lm' if with_lm else ''}"
        bt = BatchedStreamingTranscriber(
            model, decoder, chunk_frames=CHUNK_FRAMES, batch_size=BATCH,
            lookahead_chunks=lookahead, beam_width=BEAM_WIDTH,
            beam_scorers=[(lm, LM_WEIGHT)] if with_lm else None)
        bt.transcribe_batch(audios[:BATCH])  # warm-up, not counted
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        texts = bt.transcribe_batch(audios)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launch_counts)
        check_wer(tag, texts, refs, jax_path)
        log(f"[{tag}] batch {BATCH}, {CHUNK_FRAMES}-frame chunks: {wall:.3f} s "
            f"({wall / len(audios) * 1e3:.3f} ms/utterance with the host mel, "
            f"{stream['steps']} advancing steps)")
        expect_launches(tag, counts, {"scan_fwd_state_f32": stream["launches"][lookahead]})
        out["stream"][tag] = counts
        if (lookahead, with_lm) == (0, False):
            stream_texts = texts
        if (lookahead, with_lm) == (0, True):
            out["lm_texts"] = texts  # phase 11's /stream ?beam against these

    # 10d: live sessions at beam 8, against the batched beam transcripts
    live = StreamingTranscriber(model, decoder, chunk_frames=CHUNK_FRAMES,
                                beam_width=BEAM_WIDTH)
    greedy = StreamingTranscriber(model, decoder, chunk_frames=CHUNK_FRAMES)
    for st in (live, greedy):  # warm-up, not counted
        st.feed(audios[0][:CHUNK_FRAMES * 160])
        st.finish()
    torch.cuda.synchronize()
    reset_launch_counts()
    texts, beam_ms, overflow = live_sessions(live, audios[:LIVE_UTTS])
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    _, greedy_ms, _ = live_sessions(greedy, audios[:LIVE_UTTS])
    agree = sum(a == b for a, b in zip(texts, stream_texts))
    log(f"[beam 10d] {LIVE_UTTS} live sessions at beam {BEAM_WIDTH} (beam_cap "
        f"{live._sbeam.cap}) fed {LIVE_BLOCK}-sample blocks: {agree}/{LIVE_UTTS} transcripts "
        f"identical to the batched beam path (need {LIVE_MIN_AGREE}); prefix buffer "
        f"{'OVERFLOWED' if overflow else 'never overflowed'}")
    log(f"[beam 10e] live step (advance and decode, to a synchronise) at batch 1 over "
        f"{len(beam_ms)} chunks: beam {BEAM_WIDTH} p50 {np.percentile(beam_ms, 50):.3f} ms, p95 "
        f"{np.percentile(beam_ms, 95):.3f} ms; greedy p50 {np.percentile(greedy_ms, 50):.3f} ms, "
        f"p95 {np.percentile(greedy_ms, 95):.3f} ms")
    expect_launches("beam 10d", counts, {"scan_fwd_state_f32": stream["launches"]["live"]})
    if agree < LIVE_MIN_AGREE:
        raise AssertionError("[beam 10d] live beam sessions disagree with the batched path")
    if overflow:
        raise AssertionError("[beam 10d] the live beam's prefix buffer overflowed")
    out["stream"]["beam 10d live"] = counts
    out["decode"] = time_beam_decode(logits, chunk_out)
    return out


def http_json(port: int, method: str, path: str, body=None, timeout: float = 300.0):
    """(status, parsed JSON body) of one request to the local server."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"null")
    finally:
        conn.close()


def http_stream(port: int, pcm: bytes, query: str, block: int = 2 * LIVE_BLOCK,
                pace: float = 0.0, delay: float = 0.0):
    """POST int16 PCM to /stream in chunked blocks (0.1 s each): as fast as
    it can, or with pace > 0 block i at delay + i * pace seconds from the
    call, as a live source sends. Returns the status and the NDJSON lines."""
    import http.client

    start = time.perf_counter() + delay
    if pace:
        time.sleep(delay)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.putrequest("POST", f"/stream?{query}")
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        for n, i in enumerate(range(0, len(pcm), block)):
            if pace:
                time.sleep(max(0.0, start + n * pace - time.perf_counter()))
            piece = pcm[i:i + block]
            conn.send(b"%x\r\n" % len(piece) + piece + b"\r\n")
        conn.send(b"0\r\n\r\n")
        resp = conn.getresponse()
        body = resp.read().decode()
        if resp.status != 200:
            return resp.status, [json.loads(body)]
        return resp.status, [json.loads(x) for x in body.splitlines() if x.strip()]
    finally:
        conn.close()


def check_words(tag, text, words):
    """Words that join to the text, with monotone starts, ends at or after
    them and confidences in (0, 1]."""
    if " ".join(w["word"] for w in words) != " ".join(text.split()):
        raise AssertionError(f"[{tag}] words do not join to the text: {text!r}")
    starts = [w["start"] for w in words]
    if starts != sorted(starts) or any(w["end"] < w["start"] for w in words):
        raise AssertionError(f"[{tag}] word times out of order: {words}")
    if not all(0.0 < w["confidence"] <= 1.0 for w in words):
        raise AssertionError(f"[{tag}] a confidence outside (0, 1]: {words}")


def same_words(a, b) -> bool:
    return len(a) == len(b) and all(
        (x["word"], x["start"], x["end"]) == (y["word"], y["start"], y["end"])
        and abs(x["confidence"] - y["confidence"]) <= 1e-9 for x, y in zip(a, b))


def serve_transcribe(port, bodies, clients, query=""):
    """POST every body to /transcribe[?query] from `clients` threads;
    returns the responses in input order, each request's ms and the wall
    seconds."""
    from concurrent.futures import ThreadPoolExecutor

    def one(body):
        t0 = time.perf_counter()
        status, res = http_json(port, "POST", f"/transcribe?{query}", body)
        if status != 200:
            raise AssertionError(f"/transcribe answered {status}: {res}")
        return res, (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        out = list(pool.map(one, bodies))
    return [r for r, _ in out], [ms for _, ms in out], time.perf_counter() - t0


def phase_serve(manifest: str, plan, card: str, offline_texts, stream_texts, lm_texts):
    """11: the server in process (a /health, /transcribe from 8 clients,
    with timestamps and the beam, /stream from 16 sessions greedy at
    lookahead 0 and 1 and at beam 8 with the LM, the budget's 503), the
    CLI server as a subprocess, and the recorded latencies. Returns the
    launch counts of the counted runs."""
    import socket
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from http.server import ThreadingHTTPServer

    import torch

    from velocity_asr_tpu_torch import streaming as tstream
    from velocity_asr_tpu_torch.audio import load_audio
    from velocity_asr_tpu_torch.ops.cuda_lib import launch_counts, reset_launch_counts
    from velocity_asr_tpu_torch.serve import ASRService, ServiceBusy, make_handler

    with open(manifest) as f:
        rows = [json.loads(line) for line in f]
    n = len(rows)
    refs = [r["text"] for r in rows]
    bodies = []
    for r in rows:
        with open(r["audio_path"], "rb") as f:
            bodies.append(f.read())
    out = {"stream": {}}

    # (a) the server in process, on the checkpoint, --max-streams 16
    t0 = time.perf_counter()
    svc = ASRService.from_checkpoint(CHECKPOINT, device="cuda", lm_path=LM_PATH,
                                     lm_weight=LM_WEIGHT, max_streams=SERVE_MAX_STREAMS)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        status, health = http_json(port, "GET", "/health")
        log(f"[serve 11a] in-process server on port {port} up in {time.perf_counter() - t0:.3f} s; "
            f"/health {status} {health}")
        if (status != 200 or health.get("status") != "ok"
                or not health["model"]["device"].startswith("cuda")):
            raise AssertionError("/health did not answer ok on cuda")

        # (b) /transcribe from 8 concurrent clients: micro-batched forwards
        tr = svc.transcriber
        forwards = [0]
        masked_logits = tr.masked_logits

        def counted(*args):
            forwards[0] += 1
            return masked_logits(*args)

        tr.masked_logits = counted
        serve_transcribe(port, bodies[:SERVE_CLIENTS], SERVE_CLIENTS)  # warm-up, not counted
        torch.cuda.synchronize()
        calls0, reqs0, forwards[0] = svc.batcher.calls, svc.batcher.requests, 0
        reset_launch_counts()
        results, ms8, wall8 = serve_transcribe(port, bodies, SERVE_CLIENTS)
        torch.cuda.synchronize()
        counts = dict(launch_counts)
        calls, fw = svc.batcher.calls - calls0, forwards[0]
        del tr.masked_logits
        texts = [r["text"] for r in results]
        check_wer("serve 11b /transcribe", texts, refs, JAX_EVAL)
        same = sum(a == b for a, b in zip(texts, offline_texts))
        log(f"[serve 11b] {n} requests from {SERVE_CLIENTS} clients in {wall8:.3f} s "
            f"({n / wall8:.2f} requests/s); {calls} batched calls ({n / calls:.2f} requests a "
            f"call), {fw} forwards (one per frame bucket of a call); {same}/{n} texts identical "
            f"to phase 4's batch-1 transcripts (need {SERVE_MIN_AGREE:.0%})")
        expect_launches("serve 11b", counts, {"scan_fwd_f32": 10 * fw, "log_mel_f32": fw})
        if not calls < n:
            raise AssertionError("[serve 11b] the micro-batcher made no fewer calls than requests")
        if same < SERVE_MIN_AGREE * n:
            raise AssertionError("[serve 11b] /transcribe disagrees with the offline path")
        out["transcribe"] = counts

        for query in ("timestamps=1", f"beam={BEAM_WIDTH}&timestamps=1"):
            tag = f"serve 11b ?{query}"
            res, _, wall = serve_transcribe(port, bodies[:SERVE_RICH_REQUESTS], SERVE_CLIENTS,
                                            query)
            for r in res:
                check_words(tag, r["text"], r["words"])
            log(f"[{tag}] {SERVE_RICH_REQUESTS} requests in {wall:.3f} s: every response's "
                f"words join to its text, starts monotone, confidences in (0, 1] (min "
                f"{min(w['confidence'] for r in res for w in r['words']):.4f})")

        # (c) /stream: 16 concurrent sessions at the default cadence
        # the WAVs' own int16 samples: the sessions see what phase 7 read
        pcm = [np.round(load_audio(r["audio_path"]) * 32768).astype("<i2").tobytes()
               for r in rows[:LIVE_UTTS]]
        # a session's submit-to-result time of its advancing steps, and the
        # dispatcher's own time a group with an advancing call (its shared
        # calls, to the results)
        step_ms, group_ms = [], []
        request = tstream.BatchedStreamSession._request
        run_group = tstream.StreamSessionBatcher._run_group

        def timed_request(self, kind, *payload):
            t = time.perf_counter()
            res = request(self, kind, *payload)
            if kind == "step":
                step_ms.append((time.perf_counter() - t) * 1e3)
            return res

        def timed_group(self, group):
            t = time.perf_counter()
            run_group(self, group)
            if any(g[0] == "step" for g in group):
                group_ms.append((time.perf_counter() - t) * 1e3)

        tstream.BatchedStreamSession._request = timed_request
        tstream.StreamSessionBatcher._run_group = timed_group
        try:
            # (name, query, the batcher's (lookahead, beam), the batched
            # texts, real time): the clients send as fast as they can, then
            # (recorded) in real time from staggered starts
            runs = (("la0", "lookahead=0", (0, 0), stream_texts[0], False),
                    ("la1", "lookahead=1", (1, 0), stream_texts[1], False),
                    (f"beam{BEAM_WIDTH} lm", f"beam={BEAM_WIDTH}", (0, BEAM_WIDTH), lm_texts,
                     False),
                    ("la0 real time", "lookahead=0", (0, 0), stream_texts[0], True))
            delays = np.random.default_rng(0).uniform(0.0, SERVE_STAGGER_S, LIVE_UTTS)
            chunks = sum(plan["stream"]["chunks"][:LIVE_UTTS])
            for name, query, key, want, real_time in runs:
                tag = f"serve 11c {name}"
                query += "&timestamps=1"
                http_stream(port, pcm[0], query)  # warm-up: builds the shape's batcher
                stats0 = dict(svc.stream_batchers[key].stats)
                step_ms.clear()
                group_ms.clear()
                torch.cuda.synchronize()
                reset_launch_counts()
                t0 = time.perf_counter()
                with ThreadPoolExecutor(LIVE_UTTS) as pool:
                    if real_time:
                        sessions = list(pool.map(
                            lambda p, d: http_stream(port, p, query, pace=SERVE_PACE_S, delay=d),
                            pcm, delays))
                    else:
                        sessions = list(pool.map(lambda p: http_stream(port, p, query), pcm))
                wall = time.perf_counter() - t0
                torch.cuda.synchronize()
                counts = dict(launch_counts)
                stats = {k: v - stats0.get(k, 0) for k, v in svc.stream_batchers[key].stats.items()}
                finals = []
                for status, lines in sessions:
                    if status != 200 or not lines[-1].get("final"):
                        raise AssertionError(f"[{tag}] a session ended with {status} {lines[-1]}")
                    final = lines[-1]
                    if "".join(x.get("text", "") for x in lines[:-1]) != final["text"]:
                        raise AssertionError(f"[{tag}] increments do not join to the final text")
                    if not same_words([w for x in lines[:-1] for w in x.get("words", [])],
                                      final["words"]):
                        raise AssertionError(f"[{tag}] increments' words do not join to the "
                                             "final words")
                    check_words(tag, final["text"], final["words"])
                    finals.append(final["text"])
                agree = sum(a == b for a, b in zip(finals, want))
                steps, emits = stats.get("step_calls", 0), stats.get("emit_calls", 0)
                sent = ("every 0.1 s, starts staggered over 2 s" if real_time
                        else "as fast as they go")
                log(f"[{tag}] {LIVE_UTTS} sessions, 0.1 s chunked blocks sent {sent}, in "
                    f"{wall:.3f} s: "
                    f"{agree}/{LIVE_UTTS} final texts identical to the batched path's (need "
                    f"{LIVE_MIN_AGREE}); increments join to the final text and words; "
                    f"{steps} shared advancing calls for {chunks} chunks (mean "
                    f"{stats.get('step_rows', 0) / max(steps, 1):.2f} active rows a call), "
                    f"{emits} shared emit calls (mean "
                    f"{stats.get('emit_rows', 0) / max(emits, 1):.2f} rows); step submit-to-"
                    f"result p50 {np.percentile(step_ms, 50):.3f} ms, p95 "
                    f"{np.percentile(step_ms, 95):.3f} ms")
                expect_launches(tag, counts, {"scan_fwd_state_f32": 10 * steps + 8 * emits})
                if agree < LIVE_MIN_AGREE:
                    raise AssertionError(f"[{tag}] sessions disagree with the batched path")
                # real time promises no sharing: its fill is the reading
                if not real_time and not steps < chunks:
                    raise AssertionError(f"[{tag}] no fewer shared calls than chunks")
                out["stream"][tag] = counts
                if name == "la0":
                    many_ms, many_group_ms = list(step_ms), list(group_ms)
                if real_time:
                    paced = (list(step_ms), list(group_ms), steps,
                             stats.get("step_rows", 0) / max(steps, 1))

            # the shared step's latency with one session at a time
            step_ms.clear()
            group_ms.clear()
            for p in pcm[:4]:
                http_stream(port, p, "lookahead=0")
            one_ms, one_group_ms = list(step_ms), list(group_ms)
        finally:
            tstream.BatchedStreamSession._request = request
            tstream.StreamSessionBatcher._run_group = run_group

        # the budget is shared across shapes: 16 held sessions, then a 503
        held = [svc.open_stream(2.0, lookahead, beam)
                for lookahead, beam in [(0, 0)] * 6 + [(1, 0)] * 5 + [(0, BEAM_WIDTH)] * 5]
        try:
            # a short Content-Length body: the 503 comes before it is read
            status, res = http_json(port, "POST", "/stream?lookahead=0", pcm[0][:3200])
            try:
                svc.open_stream(2.0, 1, 0)
                busy = False
            except ServiceBusy:
                busy = True
        finally:
            for st in held:
                svc.release_stream(st)
        log(f"[serve 11c] with {len(held)} sessions held across 3 shapes a 17th /stream "
            f"answered {status} {res}; open_stream raised ServiceBusy: {busy}")
        if status != 503 or not busy:
            raise AssertionError("[serve 11c] no 503 past --max-streams")

        # (e) /transcribe latency from one client
        _, ms1, wall1 = serve_transcribe(port, bodies[:SERVE_SOLO_REQUESTS], 1)
    finally:
        server.shutdown()
        server.server_close()
        svc.close()

    # (d) the entry point as a subprocess
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        cli_port = sock.getsockname()[1]
    log_path = os.path.join(os.path.dirname(manifest), "serve_cli.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "velocity_asr_tpu_torch.serve", "--checkpoint", CHECKPOINT,
             "--port", str(cli_port), "--max-streams", str(SERVE_DEFAULT_STREAMS)],
            cwd=ROOT, stdout=log_file, stderr=subprocess.STDOUT)
    try:
        while True:
            try:
                status, health = http_json(cli_port, "GET", "/health", timeout=10)
                break
            except OSError:
                if proc.poll() is not None or time.perf_counter() - t0 > SERVE_START_S:
                    raise AssertionError("the CLI server did not come up")
                time.sleep(0.5)
        up = time.perf_counter() - t0
        status_t, res = http_json(cli_port, "POST", "/transcribe", bodies[0])
        log(f"[serve 11d] python -m velocity_asr_tpu_torch.serve answered /health {status} in "
            f"{up:.3f} s and /transcribe {status_t}: {res.get('text')!r} (phase 4: "
            f"{offline_texts[0]!r})")
        if status != 200 or status_t != 200 or res["text"] != offline_texts[0]:
            raise AssertionError("the CLI server did not answer as the in-process one")
    except Exception:
        with open(log_path) as f:
            log("[serve 11d] the CLI server's log:\n" + f.read()[-4000:])
        raise
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()

    log(f"[serve 11e] {card}: shared /stream step submit-to-result at {LIVE_UTTS} sessions p50 "
        f"{np.percentile(many_ms, 50):.3f} ms, p95 {np.percentile(many_ms, 95):.3f} ms over "
        f"{len(many_ms)} steps (the dispatcher's own time a group p50 "
        f"{np.percentile(many_group_ms, 50):.3f} ms over {len(many_group_ms)}); at 1 session p50 "
        f"{np.percentile(one_ms, 50):.3f} ms, p95 {np.percentile(one_ms, 95):.3f} ms over "
        f"{len(one_ms)} steps (a group p50 {np.percentile(one_group_ms, 50):.3f} ms over "
        f"{len(one_group_ms)})")
    log(f"[serve 11e] {card}: in real time ({LIVE_UTTS} sessions, a 0.1 s block every 0.1 s, "
        f"starts staggered over {SERVE_STAGGER_S:g} s) the shared step p50 "
        f"{np.percentile(paced[0], 50):.3f} ms, p95 {np.percentile(paced[0], 95):.3f} ms over "
        f"{len(paced[0])} steps (a group p50 {np.percentile(paced[1], 50):.3f} ms); {paced[2]} "
        f"shared advancing calls, mean {paced[3]:.2f} active rows a call")
    log(f"[serve 11e] {card}: /transcribe at {SERVE_CLIENTS} clients p50 "
        f"{np.percentile(ms8, 50):.3f} ms, {n / wall8:.2f} requests/s over {n}; at 1 client p50 "
        f"{np.percentile(ms1, 50):.3f} ms, {SERVE_SOLO_REQUESTS / wall1:.2f} requests/s over "
        f"{SERVE_SOLO_REQUESTS}")
    return out


def check_batch():
    """Phase 8a's batch: the first CHECK_BATCH train-split utterances of at
    most CHECK_FRAMES mel frames, padded to CHECK_FRAMES."""
    from velocity_asr_tpu_torch.data import ASRCollator
    from velocity_asr_tpu_torch.synth import SyntheticSpeechDataset

    ds = SyntheticSpeechDataset(TRAIN_SYNTH, split="train", seed=1234)
    items = []
    for i in range(len(ds)):
        item = ds[i]
        if item["mel_spectrogram"].shape[0] <= CHECK_FRAMES:
            items.append(item)
        if len(items) == CHECK_BATCH:
            break
    batch = ASRCollator(frame_bucket=CHECK_FRAMES)(items)
    assert batch["mel_spectrogram"].shape == (CHECK_BATCH, CHECK_FRAMES, 80)
    return batch


def train_card_vs_cpu(tag, batch, shared_mel=None, check=True, **config):
    """8a and 9a: the loss and every gradient of one micro-batch, card
    against CPU, at fp32 with dropout and SpecAugment off; then one
    optimizer update on each (its largest weight difference is reported).
    `config` adds TrainingConfig fields (9a: the streaming term). With
    `shared_mel`, a device-mel batch's (normalised, raw) mel on the CPU,
    both sides start from that mel instead of computing their own: the
    gap then leaves out the log-mel's. `check` False only reports.
    Returns the worst gradient's max_abs / max|grad|."""
    import torch

    from velocity_asr_tpu_torch.models.model import from_pretrained
    from velocity_asr_tpu_torch.training import Trainer, TrainingConfig

    shape = "x".join(str(d) for d in next(batch[k] for k in ("mel_spectrogram", "audio")
                                          if k in batch).shape)
    results = []
    for device in ("cuda", "cpu"):
        model = from_pretrained(CHECKPOINT, device=device, dtype="float32", dropout=0.0)
        trainer = Trainer(model, TrainingConfig(learning_rate=3e-4, warmup_steps=1, **config),
                          iter(()))
        if shared_mel is not None:
            mel = tuple(m.to(device) for m in shared_mel)
            trainer._batch_mel = lambda _batch, mel=mel: mel
        model.train()
        loss = trainer._loss(trainer._to_device(batch), None)
        grads = torch.autograd.grad(loss, trainer.params)
        trainer.optimizer.step(list(grads))
        results.append((loss.item(), [g.cpu() for g in grads],
                        [p.detach().cpu() for p in trainer.params]))
    (loss_card, g_card, p_card), (loss_cpu, g_cpu, p_cpu) = results
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    names = [n for n, _ in from_pretrained(CHECKPOINT, device="cpu").named_parameters()]
    top = max(g.abs().max().item() for g in g_cpu)
    grad_rel, zero_rel = {}, {}
    for n, a, b in zip(names, g_card, g_cpu):
        if n in ZERO_GRAD_PARAMS:
            zero_rel[n] = max(a.abs().max().item(), b.abs().max().item()) / top
        else:
            grad_rel[n] = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
    worst = sorted(grad_rel, key=grad_rel.get)[-3:][::-1]
    upd = max((a - b).abs().max().item() for a, b in zip(p_card, p_cpu))
    finite = all(torch.isfinite(g).all() for g in g_card) and math.isfinite(loss_card)
    log(f"[train {tag}] fp32, {shape}"
        + "".join(f", {k} {v}" for k, v in config.items())
        + (", the CPU's log-mel on both sides" if shared_mel is not None else "")
        + ", card vs CPU: loss "
        f"{loss_card:.6f} vs {loss_cpu:.6f} (rel {loss_rel:.3e}, tol {TRAIN_LOSS_MAX_REL:g}); "
        f"gradients of {len(grad_rel)} parameters, max_abs / max|grad|: worst "
        + ", ".join(f"{grad_rel[n]:.3e} ({n})" for n in worst)
        + f" (tol {TRAIN_GRAD_MAX_REL:g}); exact-zero gradients "
        + ", ".join(f"{n} max|grad| {v:.3e} of the largest" for n, v in zero_rel.items())
        + f" (tol {ZERO_GRAD_MAX_REL:g}); largest gradient {top:.3e}; after one update, "
        f"weights max_abs {upd:.3e}")
    if check and not (finite and loss_rel <= TRAIN_LOSS_MAX_REL
                      and grad_rel[worst[0]] <= TRAIN_GRAD_MAX_REL
                      and all(v <= ZERO_GRAD_MAX_REL for v in zero_rel.values())):
        raise AssertionError(f"[train {tag}] training on the card disagrees with the CPU")
    return grad_rel[worst[0]]


def attribute_stream_gap(batch):
    """9a's card-vs-CPU gradient gap, taken apart (reported, not checked):
    the two sides' raw log-mel on this batch, then the micro-step with
    the CPU's mel on both sides for the mixed objective, the offline term
    alone and the streaming term alone."""
    import torch

    from velocity_asr_tpu_torch.training import Trainer

    raws = []
    for device in ("cuda", "cpu"):
        audio = {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()
                 if k in ("audio", "input_lengths")}
        raws.append(Trainer._batch_mel(audio))
    mel_gap = (raws[0][1].cpu() - raws[1][1]).abs().max().item()
    log(f"[train 9a, attribution] raw log-mel of 9a's batch, card vs CPU: max_abs {mel_gap:.3e}"
        f" (of max|mel| {raws[1][1].abs().max().item():.3e}); normalised: max_abs "
        f"{(raws[0][0].cpu() - raws[1][0]).abs().max().item():.3e}")
    gaps = {}
    for name, config in (("mixed", {"streaming_chunks": STREAM_CHUNK, "streaming_aux_weight": 0.5}),
                         ("offline term alone", {}),
                         ("streaming term alone", {"streaming_chunks": STREAM_CHUNK,
                                                   "streaming_aux_weight": 1.0})):
        gaps[name] = train_card_vs_cpu(f"9a, attribution, {name}", batch, shared_mel=raws[1],
                                       check=False, **config)
    log("[train 9a, attribution] worst gradient gap with the CPU's log-mel on both sides: "
        + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))


def batch_frames(batch):
    """Padded mel frames of a collated batch, host mel or int16 PCM."""
    if "mel_spectrogram" in batch:
        return batch["mel_spectrogram"].shape[1]
    return 1 + batch["audio"].shape[1] // 160


def run_train_cli(ckpt_dir, argv, traced=None, config=TRAIN_CONFIG, synthetic=TRAIN_SYNTH,
                  tag="8b", model_config=TRAIN_MODEL_CONFIG):
    """velocity_asr_tpu_torch.train's main with these arguments, each
    micro-step timed to a synchronise (frames, ms, loss, traced), and the
    launch counts of the run. traced = (first, count): a torch.profiler
    window over those micro-steps, whose device time by kernel is logged
    (those steps carry the profiler's cost and are marked). synthetic
    None leaves the data to the config."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from velocity_asr_tpu_torch import train as cli
    from velocity_asr_tpu_torch import training
    from velocity_asr_tpu_torch.ops.cuda_lib import launch_counts, reset_launch_counts

    steps = []
    step = training.Trainer._step
    first, count = traced or (0, 0)
    prof = count and profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                             schedule=schedule(wait=first, warmup=0, active=count, repeat=1))

    def timed_step(self, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(self, batch)
        value = loss.item()  # the step's end on the card
        n = len(steps)
        steps.append((batch_frames(batch), (time.perf_counter() - t0) * 1e3,
                      value, first <= n < first + count))
        if count:
            prof.step()
        return loss

    training.Trainer._step = timed_step
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        if count:
            prof.start()
        data = [] if synthetic is None else ["--synthetic", str(synthetic)]
        out = cli.main(["--config", config, "--model-config", model_config, *data,
                        "--checkpoint-dir", ckpt_dir, "--device", "cuda", *argv])
    finally:
        training.Trainer._step = step
        if count:
            prof.stop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if count:
        report_trace(prof, steps, count, tag)
    return out["trainer"], steps, dict(launch_counts), wall


def report_trace(prof, steps, count, tag):
    """Device time per traced micro-step, by kernel, beside the untraced
    steps' host time: the card's busy share of a micro-step."""
    from torch.autograd import DeviceType

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # the kernels and copies on the card (CPU operators also carry the
    # device time of what they launched, and the ProfilerStep annotation
    # spans the whole step on the device's timeline: either would count
    # the kernels twice)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and device_us(e) > 0
              and not e.key.startswith("ProfilerStep")]
    total = sum(device_us(e) for e in events) / 1e3 / count
    launches = sum(e.count for e in events) / count
    top = sorted(events, key=device_us, reverse=True)[:8]
    wall = np.percentile([ms for _, ms, _, traced in steps if not traced], 50)
    if not events:
        log(f"[train {tag} trace] {count} micro-steps traced: the profiler recorded no device "
            "time; the card's busy share is not measured")
        return
    log(f"[train {tag} trace] {count} micro-steps traced: device time {total:.3f} ms per "
        f"micro-step over {launches:.0f} device operations, against a p50 of {wall:.3f} ms for "
        f"an untraced "
        f"micro-step (card busy {total / wall * 100:.1f}%); by kernel, ms per micro-step: "
        + "; ".join(f"{e.key[:60]} {device_us(e) / 1e3 / count:.3f} (x{e.count / count:g})"
                    for e in top))


def report_steps(tag, steps, trainer, wall, batch=TRAIN_BATCH):
    """ms per micro-step (p50, p95) overall and per frame bucket, traced
    steps left out, and the host's data-wait share of the run."""
    by_bucket = collections.defaultdict(list)
    for frames, ms, _, traced in steps:
        if not traced:
            by_bucket[frames].append(ms)
    per = "; ".join(f"{f} frames x{len(v)}: p50 {np.percentile(v, 50):.3f} ms, p95 "
                    f"{np.percentile(v, 95):.3f} ms" for f, v in sorted(by_bucket.items()))
    all_ms = [ms for v in by_bucket.values() for ms in v]
    log(f"[train {tag}] {len(all_ms)} untraced micro-steps at batch {batch} "
        f"({len(steps)} in all, {wall:.3f} s): "
        f"p50 {np.percentile(all_ms, 50):.3f} ms, p95 {np.percentile(all_ms, 95):.3f} ms per "
        f"micro-step; by frame bucket: {per}; host data wait {trainer.data_wait_seconds:.3f} s "
        f"({trainer.data_wait_seconds / wall * 100:.2f}% of the run)")


def check_train_launches(tag, counts, n_steps):
    want = {"scan_fwd_bounds_f32": SCANS_PER_STEP * n_steps,
            "scan_bwd_f32": SCANS_PER_STEP * n_steps}
    log(f"[train {tag}] launches {counts}, planned {want} ({SCANS_PER_STEP} bounds forwards "
        f"and {SCANS_PER_STEP} backwards, one launch each, per micro-step)")
    if counts != want:
        raise AssertionError(f"[train {tag}] launches {counts}, expected {want}")


def phase_training(manifest, batched):
    """8a card against CPU, 8b from scratch through the CLI, 8c fine-tune
    through the CLI and evaluate; returns 8b's launch counts."""
    import torch

    from velocity_asr_tpu_torch import evaluate as ev
    from velocity_asr_tpu_torch.checkpoint import params_from_numpy, read_params
    from velocity_asr_tpu_torch.data import ASRCollator
    from velocity_asr_tpu_torch.models.model import from_pretrained
    from velocity_asr_tpu_torch.transcribe import checkpoint_decoder

    train_card_vs_cpu("8a", check_batch())
    tmp = tempfile.mkdtemp(prefix="velocity_asr_train_")
    try:
        # 8b: from scratch, the recipe as the CLI runs it
        trainer, steps, counts, wall = run_train_cli(
            os.path.join(tmp, "scratch"), ["--max-steps", str(TRAIN_STEPS)], TRAIN_TRACED)
        losses = [loss for _, _, loss, _ in steps]
        with open(os.path.join(tmp, "scratch", "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        late, first = np.mean(losses[150:200]), np.mean(losses[:10])
        log(f"[train 8b] loss: first 10 mean {first:.4f}, micro-steps 151-200 mean {late:.4f} "
            f"(bound {TRAIN_LOSS_BOUND:g} and half the first 10's); metrics.jsonl "
            + ", ".join(f"step {r['step']} loss {r['loss']:.4f} lr {r['lr']:.3e}"
                        for r in logged))
        report_steps("8b", steps, trainer, wall)
        check_train_launches("8b", counts, TRAIN_STEPS)
        if not (all(math.isfinite(v) for v in losses + [r["loss"] for r in logged])
                and len(logged) == TRAIN_STEPS // 50 and len(losses) == TRAIN_STEPS):
            raise AssertionError("[train 8b] a loss is not finite or a step is missing")
        if not (late <= TRAIN_LOSS_BOUND and late <= first / 2):
            raise AssertionError(f"[train 8b] micro-steps 151-200 mean loss {late:.4f}")

        # 8c: fine-tune the checkpoint, save, load and evaluate
        out_dir = os.path.join(tmp, "finetune")
        ft, ft_steps, ft_counts, ft_wall = run_train_cli(
            out_dir, ["--init-from", CHECKPOINT, "--max-steps", str(FINETUNE_STEPS)])
        report_steps("8c", ft_steps, ft, ft_wall)
        check_train_launches("8c", ft_counts, FINETUNE_STEPS)
        pretrained = os.path.join(out_dir, "final_pretrained")
        back = params_from_numpy(read_params(os.path.join(pretrained, "params.msgpack")))
        trained = {k: v.cpu() for k, v in ft.model.state_dict().items()}
        same = set(back) == set(trained) and all(torch.equal(back[k], trained[k])
                                                 for k in trained)
        model = from_pretrained(pretrained, device="cuda")
        ds, n = ev.load_test_set(manifest)
        res = ev.evaluate(model, checkpoint_decoder(pretrained, model.config.vocab_size), ds,
                          n, ASRCollator(frame_bucket=FRAME_BUCKET, target_bucket=1), BATCH)
        base = batched["bf16"]["wer"]
        log(f"[train 8c] params.msgpack read back {'equals' if same else 'DIFFERS from'} the "
            f"trained weights; fine-tuned {FINETUNE_STEPS} micro-steps, bf16 WER "
            f"{res['wer'] * 100:.4f}% CER {res['cer'] * 100:.4f}% over {n} utterances against "
            f"phase 5's {base * 100:.4f}% (tol {FINETUNE_WER_MAX_DIFF * 100:g} point)")
        if not same:
            raise AssertionError("[train 8c] the saved params differ from the trained ones")
        if abs(res["wer"] - base) > FINETUNE_WER_MAX_DIFF:
            raise AssertionError(f"[train 8c] WER {res['wer']:.4f} vs phase 5's {base:.4f}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"counts": counts, "steps": TRAIN_STEPS}


def stream_check_batch():
    """Phase 9a's batch: the first CHECK_BATCH train-split utterances of
    the streaming recipe (its word counts, raw audio) whose device-mel
    batch pads to STREAM_CHECK_FRAMES frames."""
    from velocity_asr_tpu_torch.config import load_yaml
    from velocity_asr_tpu_torch.data import ASRCollator
    from velocity_asr_tpu_torch.synth import SyntheticSpeechDataset

    data = load_yaml(STREAM_CONFIG)["data"]
    ds = SyntheticSpeechDataset(STREAM_SYNTH, split="train", seed=data["synthetic_seed"],
                                min_words=data["synthetic_min_words"],
                                max_words=data["synthetic_max_words"], device_mel=True)
    items = []
    for i in range(len(ds)):
        item = ds[i]
        if 1 + -(-len(item["audio"]) // 160) <= STREAM_CHECK_FRAMES:
            items.append(item)
        if len(items) == CHECK_BATCH:
            break
    batch = ASRCollator(frame_bucket=STREAM_CHECK_FRAMES)(items)
    assert batch["audio"].shape == (CHECK_BATCH, (STREAM_CHECK_FRAMES - 1) * 160)
    return batch


def check_stream_launches(tag, counts, steps):
    """Per micro-step one log-mel and the offline term's 10 bounds forwards
    and 10 backwards; per 200-frame chunk of its batch the streaming term's
    10 carried-state bounds forwards and 10 backwards; one launch each, no
    other kernel. Returns the chunks over all micro-steps."""
    n = len(steps)
    chunks = sum(frames // STREAM_CHUNK for frames, _, _, _ in steps)
    want = {"log_mel_f32": n,
            "scan_fwd_bounds_f32": SCANS_PER_STEP * n,
            "scan_bwd_f32": SCANS_PER_STEP * n,
            "scan_fwd_bounds_state_f32": SCANS_PER_STEP * chunks,
            "scan_bwd_state_f32": SCANS_PER_STEP * chunks}
    log(f"[train {tag}] launches {counts}, planned {want} ({n} micro-steps, {chunks} chunks of "
        f"{STREAM_CHUNK} frames)")
    if counts != want:
        raise AssertionError(f"[train {tag}] launches {counts}, expected {want}")
    return chunks


def phase_stream_training(manifest, stream_wers):
    """9a card against CPU on the streaming-aware objective, 9b the CLI
    fine-tunes the checkpoint on configs/train_synth_stream.yaml, 9c the
    result through the batched streaming evaluation; returns 9b's launch
    counts, micro-steps and chunks."""
    import torch

    from velocity_asr_tpu_torch.audio import load_audio
    from velocity_asr_tpu_torch.checkpoint import params_from_numpy, read_params
    from velocity_asr_tpu_torch.config import load_yaml
    from velocity_asr_tpu_torch.models.model import from_pretrained
    from velocity_asr_tpu_torch.streaming import BatchedStreamingTranscriber
    from velocity_asr_tpu_torch.training import compute_cer, compute_wer
    from velocity_asr_tpu_torch.transcribe import checkpoint_decoder

    batch = stream_check_batch()
    train_card_vs_cpu("9a", batch, streaming_chunks=STREAM_CHUNK, streaming_aux_weight=0.5)
    attribute_stream_gap(batch)
    tmp = tempfile.mkdtemp(prefix="velocity_asr_stream_")
    try:
        # 9b: the recipe through the CLI, from the checkpoint
        out_dir = os.path.join(tmp, "stream_ft")
        trainer, steps, counts, wall = run_train_cli(
            out_dir, ["--init-from", CHECKPOINT, "--max-steps", str(STREAM_STEPS)],
            STREAM_TRACED, config=STREAM_CONFIG, synthetic=STREAM_SYNTH, tag="9b")
        losses = [loss for _, _, loss, _ in steps]
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        mean = float(np.mean(losses))
        buckets = collections.Counter(frames for frames, _, _, _ in steps)
        lo, hi = STREAM_LOSS_RANGE
        log(f"[train 9b] loss: mean of the {len(losses)} micro-steps {mean:.4f} (range {lo:g}-"
            f"{hi:g}; the JAX run's interval means 0.279-0.369, "
            f"checkpoints/synth_run/metrics_streamft.jsonl), first 10 {np.mean(losses[:10]):.4f}, "
            f"last 10 {np.mean(losses[-10:]):.4f}; frame buckets {dict(sorted(buckets.items()))}; "
            "metrics.jsonl " + ", ".join(f"step {r['step']} loss {r['loss']:.4f} lr "
                                         f"{r['lr']:.3e}" for r in logged))
        report_steps("9b", steps, trainer, wall, STREAM_BATCH)
        chunks = check_stream_launches("9b", counts, steps)
        every = load_yaml(STREAM_CONFIG)["logging"]["log_interval"]
        if not (all(math.isfinite(v) for v in losses + [r["loss"] for r in logged])
                and len(losses) == STREAM_STEPS and len(logged) == STREAM_STEPS // every):
            raise AssertionError("[train 9b] a loss is not finite or a step is missing")
        if max(buckets) > STREAM_MAX_FRAMES:
            raise AssertionError(f"[train 9b] a {max(buckets)}-frame batch: phase 3 held the "
                                 f"training scans up to {STREAM_MAX_FRAMES} frames")
        if not lo <= mean <= hi:
            raise AssertionError(f"[train 9b] mean loss {mean:.4f} outside [{lo}, {hi}]")

        # 9c: save, read back, and the batched streaming evaluation
        pretrained = os.path.join(out_dir, "final_pretrained")
        back = params_from_numpy(read_params(os.path.join(pretrained, "params.msgpack")))
        trained = {k: v.cpu() for k, v in trainer.model.state_dict().items()}
        same = set(back) == set(trained) and all(torch.equal(back[k], trained[k])
                                                 for k in trained)
        with open(manifest) as f:
            rows = [json.loads(line) for line in f]
        refs = [r["text"] for r in rows]
        model = from_pretrained(pretrained, device="cuda")
        bt = BatchedStreamingTranscriber(
            model, checkpoint_decoder(pretrained, model.config.vocab_size),
            chunk_frames=CHUNK_FRAMES, batch_size=BATCH, lookahead_chunks=0)
        texts = bt.transcribe_batch([load_audio(r["audio_path"]) for r in rows])
        wer, cer = compute_wer(texts, refs), compute_cer(texts, refs)
        base = stream_wers[0]
        log(f"[train 9c] params.msgpack read back {'equals' if same else 'DIFFERS from'} the "
            f"trained weights; fine-tuned {STREAM_STEPS} micro-steps, streaming (lookahead 0, "
            f"batch {BATCH}) WER {wer * 100:.4f}% CER {cer * 100:.4f}% over {len(rows)} "
            f"utterances against phase 7's {base * 100:.4f}% (tol "
            f"{STREAM_WER_MAX_DIFF * 100:g} point)")
        if not same:
            raise AssertionError("[train 9c] the saved params differ from the trained ones")
        if abs(wer - base) > STREAM_WER_MAX_DIFF:
            raise AssertionError(f"[train 9c] WER {wer:.4f} vs phase 7's {base:.4f}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"counts": counts, "steps": STREAM_STEPS, "chunks": chunks, "buckets": buckets}


# ---------------------------------------------------------------- phase 12


def repo_test_module(name: str):
    """tests/<name>.py of this checkout (the test encoders), imported by
    its path: on some hosts ``tests`` names another installed package."""
    import importlib.util

    key = f"_velocity_asr_tests_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, os.path.join(ROOT, "tests",
                                                                        f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module  # pickled by this name into pool workers
        spec.loader.exec_module(module)
    return sys.modules[key]


def flac_bytes(pcm):
    """FLAC bytes of int16 PCM by tests/flac_encoder.py: fixed-2 subframes,
    or verbatim ones when the last 1,024-sample block holds fewer than 3
    samples (the encoder writes such a block with a fixed-2 predictor,
    whose 2 warm-up samples it cannot hold, and decoders reject it)."""
    mode = "verbatim" if len(pcm) % 1024 in (1, 2) else "fixed2"
    return repo_test_module("flac_encoder").encode_flac(pcm, mode=mode)


def phase_formats(tmp: str, manifest: str, offline_texts):
    """12a: the first FORMAT_UTTS held-out utterances re-encoded as FLAC
    (lossless: the transcripts must be phase 4's), and as mp3, Ogg Vorbis
    and m4a where this host's encoders load (WER within
    FORMAT_WER_MAX_DIFF of phase 4's over the same), each set through
    ``transcribe --input-dir`` and as /transcribe bodies to an in-process
    server. The native library must build here. Returns the launches."""
    import multiprocessing
    from http.server import ThreadingHTTPServer
    import threading

    import torch

    from velocity_asr_tpu_torch import io as tio
    from velocity_asr_tpu_torch import transcribe as cli
    from velocity_asr_tpu_torch.ops.cuda_lib import launch_counts, reset_launch_counts
    from velocity_asr_tpu_torch.serve import ASRService, make_handler
    from velocity_asr_tpu_torch.training import compute_wer

    mp3_codec, vorbis_codec = repo_test_module("mp3_codec"), repo_test_module("vorbis_codec")
    t0 = time.perf_counter()
    if not tio.native_available():
        raise AssertionError("[formats] the native decoder library did not build")
    log(f"[formats] native library built and loaded in {time.perf_counter() - t0:.3f} s "
        f"({os.path.relpath(tio.host_build_dir(), ROOT)}); m4a shim "
        f"{'built' if tio.m4a_available() else 'not built (no libavformat header or libraries)'}"
        f"; supported_audio_exts() = {tio.supported_audio_exts()}")
    with open(manifest) as f:
        rows = [json.loads(line) for line in f][:FORMAT_UTTS]
    n = len(rows)
    refs = [r["text"] for r in rows]
    pcms = [np.round(tio.decode_audio_file(r["audio_path"])[0][0] * 32768).astype(np.int16)
            for r in rows]
    floats = [p.astype(np.float32) / 32768 for p in pcms]
    available = {"flac": True, "mp3": mp3_codec.lame_available(),
                 "ogg": vorbis_codec.encoder_available(), "m4a": tio.m4a_available()}
    encoders = [name for name, ok in available.items() if ok]
    skipped = [name for name, ok in available.items() if not ok]
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(8) as pool:
        blobs = {"flac": pool.map(flac_bytes, pcms)}
    if available["mp3"]:
        blobs["mp3"] = [mp3_codec.lame_encode(x, 16000) for x in floats]
    if available["ogg"]:
        blobs["ogg"] = [vorbis_codec.vorbis_encode(x, 16000) for x in floats]
    dirs = {}
    for name in encoders:
        d = os.path.join(tmp, "formats", name)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            path = os.path.join(d, f"utt_{i:05d}.{name}")
            if name == "m4a":
                tio.encode_m4a(path, floats[i], 16000)
            else:
                with open(path, "wb") as f:
                    f.write(blobs[name][i])
        dirs[name] = d
    how = {"flac": "tests/flac_encoder.py", "mp3": "tests/mp3_codec.py over libmp3lame",
           "ogg": "tests/vorbis_codec.py over libvorbisenc", "m4a": "io.encode_m4a"}
    log(f"[formats] {n} utterances encoded in {time.perf_counter() - t0:.3f} s: "
        + ", ".join(f"{name} ({how[name]})" for name in encoders)
        + f"; encoders not loadable on this host: {', '.join(skipped) or 'none'}")

    base = compute_wer(offline_texts[:n], refs)
    total = collections.Counter()
    svc = ASRService.from_checkpoint(CHECKPOINT, device="cuda", max_streams=1)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        for name, d in dirs.items():
            out = os.path.join(tmp, "formats", f"{name}.json")
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main(["--input-dir", d, "--checkpoint", CHECKPOINT, "--json", "--output",
                           out, "--device", "cuda"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = dict(launch_counts)
            total.update(counts)
            with open(out) as f:
                texts = [r.get("text") for r in json.load(f)]
            files = sorted(os.listdir(d))
            bodies = []
            for fn in files:
                with open(os.path.join(d, fn), "rb") as f:
                    bodies.append(f.read())
            reset_launch_counts()
            served = []
            for body in bodies:
                status, res = http_json(server.server_address[1], "POST", "/transcribe", body)
                if status != 200:
                    raise AssertionError(f"[formats {name}] /transcribe answered {status}: {res}")
                served.append(res["text"])
            torch.cuda.synchronize()
            total.update(dict(launch_counts))
            same = sum(a == b for a, b in zip(texts, offline_texts))
            same_served = sum(a == b for a, b in zip(served, offline_texts))
            wer, wer_served = compute_wer(texts, refs), compute_wer(served, refs)
            log(f"[formats {name}] transcribe --input-dir: rc {rc}, {len(texts)} files in "
                f"{seconds:.3f} s, WER {wer * 100:.4f}%, {same}/{n} transcripts identical to "
                f"phase 4's (WER {base * 100:.4f}%); /transcribe bodies: WER "
                f"{wer_served * 100:.4f}%, {same_served}/{n} identical; launches {counts}")
            if rc != 0 or len(texts) != n:
                raise AssertionError(f"[formats {name}] the CLI failed on a file")
            if counts != {"scan_fwd_f32": 10 * n, "log_mel_f32": n}:
                raise AssertionError(f"[formats {name}] expected 10 scans and 1 log-mel a file")
            if name == "flac" and not (same == same_served == n):
                raise AssertionError("[formats flac] FLAC transcripts differ from the WAV's")
            if max(abs(wer - base), abs(wer_served - base)) > FORMAT_WER_MAX_DIFF:
                raise AssertionError(f"[formats {name}] WER off phase 4's by more than "
                                     f"{FORMAT_WER_MAX_DIFF}")
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
    return dict(total)


def phase_longform_offline(plan):
    """12b: the 40 long-form utterances through the batched evaluation
    (batch 16, bf16, frame buckets of LONGFORM_BUCKET) against
    eval_longform_offline.json, 10 scans a forward; the longest through
    the transcriber at batch 1 (10 scans, 1 log-mel), its fp32 logits card
    against CPU; the kernels timed at these lengths. Returns the
    launches."""
    import torch

    from velocity_asr_tpu_torch import evaluate as ev
    from velocity_asr_tpu_torch.audio import load_audio
    from velocity_asr_tpu_torch.data import ASRCollator
    from velocity_asr_tpu_torch.models.model import from_pretrained
    from velocity_asr_tpu_torch.ops.cuda_lib import launch_counts, reset_launch_counts
    from velocity_asr_tpu_torch.ops.mel import log_mel, log_mel_plain
    from velocity_asr_tpu_torch.ops.pooling import pool_size_level1
    from velocity_asr_tpu_torch.ops.scan import scan_fwd
    from velocity_asr_tpu_torch.transcribe import checkpoint_decoder, load_transcriber

    lf = plan["longform"]
    total = collections.Counter()
    model = from_pretrained(CHECKPOINT, device="cuda")
    decoder = checkpoint_decoder(CHECKPOINT, model.config.vocab_size)
    ds, n = ev.load_test_set(lf["manifest"])
    collator = ASRCollator(frame_bucket=LONGFORM_BUCKET, target_bucket=1)
    torch.cuda.synchronize()
    reset_launch_counts()
    res = ev.evaluate(model, decoder, ds, n, collator, BATCH)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    total.update(counts)
    n_batches = sum(lf["batched"].values())
    texts = [r["prediction"] for r in res["results"]]
    check_wer("long form offline, batched", texts, [r["reference"] for r in res["results"]],
              JAX_LONGFORM_OFFLINE)
    log(f"[long form offline] batched at {BATCH}, bucket {LONGFORM_BUCKET}: "
        f"{dict(sorted(lf['batched'].items()))}, {res['seconds']:.3f} s of model and decode "
        f"(rtf {res['rtf']:.5f})")
    expect_launches("long form offline, batched", counts, {"scan_fwd_f32": 10 * n_batches})

    longest = ds.samples[lf["longest"]]["audio_path"]
    tr = load_transcriber(CHECKPOINT, device="cuda")
    tr.transcribe_file(longest)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    text = tr.transcribe_file(longest)["text"]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = dict(launch_counts)
    total.update(counts)
    log(f"[long form offline] the longest ({lf['n_samples'][lf['longest']] / 16000:.2f} s, "
        f"bucket {lf['longest_bucket']} frames) at batch 1: {ms:.3f} ms; text "
        f"{'equals' if text == texts[lf['longest']] else 'differs from'} the batched one's")
    expect_launches("long form offline, batch 1", counts,
                    {"scan_fwd_f32": 10, "log_mel_f32": 1})
    audio = load_audio(longest)
    padded, n_frames = tr._pad_audio(audio)
    wire = torch.from_numpy(tr._to_wire(padded))
    out_len = (n_frames + 1) // 2
    f32 = [load_transcriber(CHECKPOINT, device=d, dtype="float32") for d in ("cuda", "cpu")]
    lg = [t.masked_logits(wire.to(t.device), n_frames)[:, :out_len].cpu() for t in f32]
    finite = all(torch.isfinite(x).all() for x in lg)
    max_abs = (lg[0] - lg[1]).abs().max().item()
    agree = (lg[0].argmax(-1) == lg[1].argmax(-1)).float().mean().item()
    log(f"[long form offline] fp32 logits of the longest, card vs CPU ({out_len} frames): "
        f"max_abs {max_abs:.3e} (tol {LOGITS_FP32_MAX_ABS:g}), argmax agreement {agree:.4f}")
    if not (finite and max_abs <= LOGITS_FP32_MAX_ABS):
        raise AssertionError("[long form offline] card logits disagree with the CPU")

    # rows 1 and 2 at the long-form shapes (device time, CUDA graphs)
    rng = np.random.default_rng(72)
    shapes = sorted({(b, f) for b, f in list(lf["batched"]) + [(1, lf["longest_bucket"]),
                                                                (1, LONG_FRAMES),
                                                                (BATCH, LONG_FRAMES)]})
    for batch, frames in shapes:
        for state_dim, length in ((64, frames // 2), (32, pool_size_level1(frames // 2))):
            args = scan_inputs(rng, length, state_dim, batch=batch)
            t_ms = graph_time_ms(lambda: scan_fwd(*args), iters=20)
            b_ms, b_by = bound_ms(*scan_cost(batch, length, 384, state_dim))
            log(f"time scan N={state_dim} L={length} B={batch} D=384 (long form, device, CUDA "
                f"graph): kernel {t_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), exp floor "
                f"{exp_floor_ms(batch, length, 384, state_dim):.5f} ms")
        _, padded = mel_inputs(rng, frames, batch)
        m_ms = graph_time_ms(lambda: log_mel(padded), iters=20)
        p_ms = graph_time_ms(lambda: log_mel_plain(padded), iters=5)
        b_ms, b_by = bound_ms(*mel_cost(padded, batch * frames))
        log(f"time log_mel B={batch} T={frames} (long form, device, CUDA graph): kernel "
            f"{m_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    return dict(total)


def disk_yaml(tmp: str, root: str, profile_dir: str, manifest=None) -> tuple:
    """(train YAML, model YAML) for phase 12c: the recipe
    (configs/train_synth.yaml) with its data read from the LibriSpeech tree
    at `root` (or from `manifest`) as raw audio for the device mel, the
    waveform augmentations on, a profiler window; the model
    (configs/model_synth.yaml) with gradient checkpointing."""
    with open(TRAIN_CONFIG) as f:
        text = f.read()
    if manifest:
        data = f"data:\n  manifest: {manifest}\n  device_mel: true\n"
    else:
        splits = list(DISK_SPLITS)
        data = (f"data:\n  librispeech_root: {root}\n  train_splits: [{splits[0]}]\n"
                f"  val_splits: [{splits[1]}]\n  device_mel: true\n")
    text, n_data = re.subn(r"^data:\n(  .*\n)+", data, text, flags=re.M)
    text, n_aug = re.subn(r"^(augmentation:\n  enabled: true\n)",
                          r"\1  noise_injection: true\n  speed_perturb: true\n", text, flags=re.M)
    text, n_log = re.subn(r"^(logging:\n)",
                          rf"\1  profile_dir: {profile_dir}\n  log_interval: 10\n", text,
                          flags=re.M)
    text = re.sub(r"^  log_interval: 50\n", "", text, flags=re.M)
    if (n_data, n_aug, n_log) != (1, 1, 1):
        raise AssertionError(f"{TRAIN_CONFIG}: its data, augmentation or logging section moved")
    with open(TRAIN_MODEL_CONFIG) as f:
        model = f.read()
    model, n_perf = re.subn(r"^(performance:\n)", r"\1  gradient_checkpointing: true\n", model,
                            flags=re.M)
    if n_perf != 1:
        raise AssertionError(f"{TRAIN_MODEL_CONFIG}: no performance section")
    paths = []
    for name, body in (("train.yaml" if not manifest else "train_manifest.yaml", text),
                       ("model.yaml", model)):
        paths.append(os.path.join(tmp, name))
        with open(paths[-1], "w") as f:
            f.write(body)
    return tuple(paths)


def checkpointed_step_bit_equal(batch):
    """One fp32 micro-step of the recipe's model (dropout 0.1, the waveform
    augmentations and the masks on) with gradient checkpointing against
    the same step without it, from one generator seed: the loss and every
    gradient compared bit for bit, and the plain step against itself (the
    CTC loss on the CPU, whose CUDA backward adds with atomics; cuDNN in
    its deterministic mode). Returns (bit-equal, plain repeatable)."""
    import torch

    from velocity_asr_tpu_torch.augment import SpecAugmentConfig, spec_augment
    from velocity_asr_tpu_torch.config import load_yaml, model_config_from_yaml
    from velocity_asr_tpu_torch.models.model import create_model
    from velocity_asr_tpu_torch.training import Trainer, TrainingConfig, ctc_loss, step_seed

    cfg = model_config_from_yaml(load_yaml(TRAIN_MODEL_CONFIG))
    cfg = dataclasses.replace(cfg, dtype="float32", dropout=0.1, vocab_size=31)
    aug = SpecAugmentConfig(enabled=True, noise_injection=True, speed_perturb=True)
    runs = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, True, False):
            model = create_model(dataclasses.replace(cfg, gradient_checkpointing=remat),
                                 device="cuda", generator=torch.Generator().manual_seed(3))
            trainer = Trainer(model, TrainingConfig(augment=aug), iter(()))
            model.train()
            rng = torch.Generator(device="cuda")
            rng.manual_seed(step_seed(0, 7))
            b = trainer._augment_waveform(trainer._to_device(batch), rng)
            mel, _ = Trainer._batch_mel(b)
            mel = spec_augment(mel, rng, aug, b["input_lengths"])
            logits = model(mel, rng=rng)
            loss = ctc_loss(logits.cpu(), torch.as_tensor(batch["targets"]),
                            ((b["input_lengths"] + 1) // 2).cpu(),
                            torch.as_tensor(batch["target_lengths"]))
            grads = torch.autograd.grad(loss, list(model.parameters()))
            runs.append((loss.detach(), [g.cpu() for g in grads]))
    finally:
        torch.backends.cudnn.deterministic = deterministic

    def same(a, b):
        return torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))

    return same(runs[0], runs[1]), same(runs[0], runs[2]), float(runs[0][0])


def peak_memory(batch, frames, kind):
    """torch.cuda.max_memory_allocated over one bf16 micro-step's forward
    and backward of the recipe's model at (batch, frames), host mel or
    device mel (int16 PCM), without and with gradient checkpointing (MB
    above what was allocated before the step)."""
    import torch

    from velocity_asr_tpu_torch.config import load_yaml, model_config_from_yaml
    from velocity_asr_tpu_torch.models.model import create_model
    from velocity_asr_tpu_torch.training import Trainer, TrainingConfig

    rng = np.random.default_rng(frames)
    targets = np.full((batch, 64), 2, np.int32)
    targets[:, :40] = rng.integers(3, 30, (batch, 40))
    data = {"targets": targets, "input_lengths": np.full(batch, frames, np.int32),
            "target_lengths": np.full(batch, 40, np.int32)}
    if kind == "device mel":
        data["audio"] = (rng.standard_normal((batch, (frames - 1) * 160)) * 3000).astype(np.int16)
    else:
        data["mel_spectrogram"] = rng.standard_normal((batch, frames, 80)).astype(np.float32)
    cfg = model_config_from_yaml(load_yaml(TRAIN_MODEL_CONFIG))
    out = {}
    for remat in (False, True):
        model = create_model(dataclasses.replace(cfg, gradient_checkpointing=remat),
                             device="cuda")
        trainer = Trainer(model, TrainingConfig(), iter(()))
        model.train()
        dev = trainer._to_device(data)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rng_t = torch.Generator(device="cuda")
        rng_t.manual_seed(1)
        loss = trainer._loss(dev, rng_t)
        torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        out[remat] = (torch.cuda.max_memory_allocated() - base) / 2**20
        del model, trainer, dev, loss
        torch.cuda.empty_cache()
    return out


def phase_disk_training(tmp: str):
    """12c: the recipe trained through the CLI from a LibriSpeech-layout
    FLAC tree (device mel, speed and noise augmentation, gradient
    checkpointing, a profiler window), then 5 micro-steps from a manifest
    over the same files: loss finite and falling, exactly
    CHECKPOINTED_STEP launches a micro-step; the checkpointed step bit
    for bit against the plain one on the card; peak memory with and
    without checkpointing. Returns (launches, the profile directory)."""
    import multiprocessing

    import torch

    from velocity_asr_tpu_torch import synth
    from velocity_asr_tpu_torch.data import ASRCollator, LibriSpeechDataset


    root = os.path.join(tmp, "librispeech")
    t0 = time.perf_counter()
    manifests = {}
    with multiprocessing.get_context("spawn").Pool(8) as pool:
        for split, (synth_split, n, speakers, chapters) in DISK_SPLITS.items():
            manifests[split] = synth.write_librispeech_tree(
                root, split, n, flac_bytes, speakers=speakers, chapters=chapters,
                synth_split=synth_split, map_fn=pool.map)
    log(f"[disk training] LibriSpeech tree (FLAC) written in {time.perf_counter() - t0:.3f} s: "
        + ", ".join(f"{split} {n} utterances ({s} speakers x {c} chapters)"
                    for split, (_, n, s, c) in DISK_SPLITS.items()))
    profile_dir = os.path.join(tmp, "profile")
    config, model_config = disk_yaml(tmp, root, profile_dir)
    total = collections.Counter()
    trainer, steps, counts, wall = run_train_cli(
        os.path.join(tmp, "disk_run"), ["--max-steps", str(DISK_STEPS), "--num-workers", "8"],
        config=config, synthetic=None, tag="12c", model_config=model_config)
    total.update(counts)
    losses = [loss for _, _, loss, _ in steps]
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    log(f"[disk training] vocabulary {trainer.model.config.vocab_size} tokens; gradient "
        f"checkpointing {trainer.model.config.gradient_checkpointing}; loss first 10 mean "
        f"{first:.4f}, last 10 mean {last:.4f}")
    report_steps("12c", steps, trainer, wall)
    want = {k: v * DISK_STEPS for k, v in CHECKPOINTED_STEP.items()}
    expect_launches("disk training 12c", counts, want)
    if not (all(math.isfinite(v) for v in losses) and len(losses) == DISK_STEPS
            and last < first):
        raise AssertionError("[disk training] a loss is not finite, or the loss did not fall")

    m_config, _ = disk_yaml(tmp, root, os.path.join(tmp, "profile_manifest"),
                            manifest=manifests["train-clean-100"])
    m_trainer, m_steps, m_counts, m_wall = run_train_cli(
        os.path.join(tmp, "manifest_run"),
        ["--max-steps", str(DISK_MANIFEST_STEPS), "--num-workers", "8"], config=m_config,
        synthetic=None, tag="12c manifest", model_config=model_config)
    total.update(m_counts)
    m_losses = [loss for _, _, loss, _ in m_steps]
    log(f"[disk training, manifest] {len(m_losses)} micro-steps, losses "
        + ", ".join(f"{v:.4f}" for v in m_losses))
    expect_launches("disk training 12c, manifest", m_counts,
                    {k: v * DISK_MANIFEST_STEPS for k, v in CHECKPOINTED_STEP.items()})
    if not all(math.isfinite(v) for v in m_losses):
        raise AssertionError("[disk training, manifest] a loss is not finite")

    ds = LibriSpeechDataset(root, "train-clean-100", device_mel=True)
    batch = ASRCollator(frame_bucket=200)([ds[i] for i in range(4)])
    same, repeatable, loss = checkpointed_step_bit_equal(batch)
    log(f"[disk training] one fp32 micro-step, 4 x {batch['audio'].shape[1] // 160 + 1} frames "
        f"device mel, dropout 0.1, speed, noise and masks on, one generator seed (loss "
        f"{loss:.6f}): with checkpointing loss and every gradient "
        f"{'bit-equal to' if same else 'DIFFER from'} the plain step's; the plain step "
        f"{'bit-equal to' if repeatable else 'DIFFERS from'} itself run again")
    if not (same and repeatable):
        raise AssertionError("[disk training] the checkpointed step differs from the plain one")
    for batch_size, frames, kind in MEMORY_SHAPES:
        mem = peak_memory(batch_size, frames, kind)
        log(f"[disk training] peak memory of one bf16 micro-step at {batch_size} x {frames} "
            f"{kind}: {mem[False]:.1f} MB without checkpointing, {mem[True]:.1f} MB with "
            f"({mem[True] / mem[False]:.3f})")
    torch.cuda.synchronize()
    return dict(total), profile_dir


def phase_profile(profile_dir: str):
    """12d: the trace 12c's profiler window wrote parses as JSON, covers
    exactly profile_steps micro-steps and names the log-mel, scan forward
    and scan backward kernels."""
    import glob

    start, count = DISK_PROFILE
    traces = glob.glob(os.path.join(profile_dir, "*.json"))
    if len(traces) != 1:
        raise AssertionError(f"[profile] expected one trace in {profile_dir}, found {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    steps = sorted({e["name"] for e in events if str(e.get("name", "")).startswith("micro_step_")})
    kernels = collections.Counter(
        k for e in events if e.get("cat") == "kernel"
        for k in ("log_mel_kernel", "scan_fwd_kernel", "scan_bwd_kernel") if k in e["name"])
    log(f"[profile] {os.path.basename(traces[0])}: {os.path.getsize(traces[0])} bytes, "
        f"{len(events)} events; micro-steps {steps}; kernel events {dict(kernels)}")
    want = [f"micro_step_{i}" for i in range(start, start + count)]
    if sorted(steps) != sorted(want):
        raise AssertionError(f"[profile] the window covers {steps}, not {want}")
    if len(kernels) != 3:
        raise AssertionError("[profile] the trace does not name the log-mel, scan forward and "
                             "scan backward kernels")
    per = {k: v / count for k, v in kernels.items()}
    log(f"[profile] kernel events per micro-step: {per}")
    return per


def exp_floor_ms(batch, length, d_inner, state_dim):
    """The least time the SFU takes for the forward's one IEEE expf per
    (b, t, d, n): exp2 at SFU_PER_CLOCK_PER_SM a clock on every SM at the
    boost clock."""
    exps = batch * length * d_inner * state_dim
    return exps / (SFU_PER_CLOCK_PER_SM * H100_SMS * H100_BOOST_HZ) * 1e3


def fwd_plan(batch, state_dim, with_state=False, save_bounds=False, d_inner=384):
    """The forward launcher's plan at one shape and what the card makes of
    it, in words: states a thread, lanes a channel, channels a block,
    grid, and waves of the resident blocks."""
    import torch

    from velocity_asr_tpu_torch.ops import cuda_lib

    occ = cuda_lib.library().occupancy("scan_fwd_occupancy", batch, d_inner, state_dim,
                                       int(with_state), int(save_bounds))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = occ["grid_x"] * occ["grid_y"]
    return (f"plan S={occ['states_per_thread']} ({occ['lanes']} lanes a channel), "
            f"{occ['channels']} channels a block of {occ['threads']} threads, grid "
            f"{occ['grid_x']} x {occ['grid_y']} = {blocks} blocks, "
            f"{blocks / (occ['blocks_per_sm'] * sms):.2f} waves of {occ['blocks_per_sm']} x {sms} "
            f"resident ({occ['registers']} registers, {occ['shared_bytes']} shared bytes)")


def time_int8(rng, m, k, n, dtype="float32"):
    """Times of both int8 kernels, their plain version and torch._int_mm
    (int8 x int8 -> int32 on pre-quantized operands, where its shape rules
    allow; None elsewhere) at one shape, x in `dtype`: device time from
    CUDA graphs, and the kernels' eager time (host launch included) from
    events."""
    import torch

    from velocity_asr_tpu_torch.ops.int8_matmul import (
        dynamic_scale, int8_dot, int8_dot_plain, quantize_activation, scale_of)

    x, w_q, w_scale = int8_inputs(rng, m, k, n, dtype)
    x_scale = scale_of(x.abs().amax())
    times = {
        "dynamic": graph_time_ms(lambda: int8_dot(x, w_q, w_scale), iters=100),
        "static": graph_time_ms(lambda: int8_dot(x, w_q, w_scale, x_scale), iters=100),
        "eager_dynamic": cuda_time_ms(lambda: int8_dot(x, w_q, w_scale), iters=200),
        "eager_static": cuda_time_ms(lambda: int8_dot(x, w_q, w_scale, x_scale), iters=200),
        "plain_dynamic": graph_time_ms(lambda: int8_dot_plain(x, w_q, w_scale), iters=20),
        "plain_static": graph_time_ms(lambda: int8_dot_plain(x, w_q, w_scale, x_scale), iters=20),
        "int_mm": None,
    }
    x_q, w_t = quantize_activation(x, dynamic_scale(x)), w_q.t()
    try:
        torch._int_mm(x_q, w_t)
    except RuntimeError as e:  # a shape _int_mm does not take
        log(f"  torch._int_mm M={m} K={k} N={n}: not available ({str(e).splitlines()[0]})")
    else:
        times["int_mm"] = graph_time_ms(lambda: torch._int_mm(x_q, w_t), iters=100)
    return times


def phase_timing(counts, bucket: int, errs, batched, streaming, training, stream_training,
                 served):
    import torch

    from velocity_asr_tpu_torch.audio import mel_filterbank
    from velocity_asr_tpu_torch.ops.mel import compute_mel_spectrogram, log_mel, log_mel_plain
    from velocity_asr_tpu_torch.ops.pooling import pool_size_level1
    from velocity_asr_tpu_torch.ops.scan import (scan_bwd, scan_bwd_plain, scan_bwd_state,
                                                 scan_fwd, scan_fwd_bounds,
                                                 scan_fwd_bounds_plain, scan_fwd_bounds_state,
                                                 scan_fwd_plain, scan_fwd_state,
                                                 scan_fwd_timeline, timeline_shares,
                                                 TIMELINE_PHASES)

    rng = np.random.default_rng(7)
    local_len = bucket // 2
    pooled = pool_size_level1(local_len)
    batched_len = batched["int8"]["bucket"] // 2
    rows = []
    # the offline path's shapes (batch 1, its most common bucket), N=16 for
    # the third width the repo's configs use, and the batched path's (its
    # most common padded length)
    for state_dim, length, batch in ((64, local_len, 1), (32, pooled, 1), (16, local_len, 1),
                                     (64, batched_len, BATCH),
                                     (32, pool_size_level1(batched_len), BATCH)):
        args = scan_inputs(rng, length, state_dim, batch=batch)
        ms = graph_time_ms(lambda: scan_fwd(*args), iters=50)
        eager = cuda_time_ms(lambda: scan_fwd(*args), iters=50)
        plain = graph_time_ms(lambda: scan_fwd_plain(*args), iters=3)
        b_ms, b_by = bound_ms(*scan_cost(batch, length, 384, state_dim))
        log(f"time scan N={state_dim} L={length} B={batch} D=384 (device, CUDA graph): kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.5f} ms ({b_by}), exp floor "
            f"{exp_floor_ms(batch, length, 384, state_dim):.5f} ms; eager (host launch included) "
            f"{eager:.4f} ms; {fwd_plan(batch, state_dim)}")
        rows.append((ms, plain, b_ms, b_by))

    # the carried-state scan at the streaming path's shapes: the live
    # session's local and global blocks (batch 1) and the batched local
    # blocks (batch 16); its bytes add h0 read and h_final written once
    state_rows = []
    for state_dim, length, batch in ((64, CHUNK_FRAMES // 2, 1), (32, 64, 1),
                                     (64, CHUNK_FRAMES // 2, BATCH)):
        args = scan_inputs(rng, length, state_dim, batch=batch, with_state=True)
        ms = graph_time_ms(lambda: scan_fwd_state(*args), iters=50)
        eager = cuda_time_ms(lambda: scan_fwd_state(*args), iters=50)
        plain = graph_time_ms(lambda: scan_fwd_plain(*args, return_state=True), iters=3)
        n_bytes, n_ops = scan_cost(batch, length, 384, state_dim)
        b_ms, b_by = bound_ms(n_bytes + carried_bytes(batch, 384, state_dim), n_ops)
        log(f"time state scan N={state_dim} L={length} B={batch} D=384 (device, CUDA graph): "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.5f} ms ({b_by}), exp floor "
            f"{exp_floor_ms(batch, length, 384, state_dim):.5f} ms; eager (host launch included) "
            f"{eager:.4f} ms; {fwd_plan(batch, state_dim, with_state=True)}")
        state_rows.append((ms, plain, b_ms, b_by))
    per_run = {run: c.get("scan_fwd_state_f32", 0) for run, c in streaming.items()}
    state_launches = sum(per_run.values())
    log(f"state scan launches on the streaming path: {state_launches} (per run: phase 7's "
        f"lookahead 0, 1, 2, long form and live, phase 10's beam runs and phase 11's /stream "
        f"runs: {per_run})")

    # the training scans at the recipe's main shapes: local blocks at batch
    # 16 and 600 frames (L = 300, N = 64), global blocks (L = 64, N = 32)
    train_rows = {}
    for state_dim, length in ((64, 300), (32, 64)):
        x, dt, A, B, C = scan_inputs(rng, length, state_dim, batch=TRAIN_BATCH)
        g = torch.tensor(rng.standard_normal((TRAIN_BATCH, length, 384)).astype(np.float32),
                         device="cuda")
        _, bounds = scan_fwd_bounds(x, dt, A, B, C)
        cases = {
            "scan_fwd_bounds_f32": (lambda: scan_fwd_bounds(x, dt, A, B, C),
                                    lambda: scan_fwd_bounds_plain(x, dt, A, B, C),
                                    scan_bounds_cost),
            "scan_bwd_f32": (lambda: scan_bwd(x, dt, A, B, C, bounds, g),
                             lambda: scan_bwd_plain(x, dt, A, B, C, bounds, g), scan_bwd_cost),
        }
        for name, (kernel, plain, cost) in cases.items():
            ms = graph_time_ms(kernel, iters=20)
            eager = cuda_time_ms(kernel, iters=20)
            plain_ms = graph_time_ms(plain, iters=2)
            b_ms, b_by = bound_ms(*cost(TRAIN_BATCH, length, 384, state_dim))
            fwd = (f", exp floor {exp_floor_ms(TRAIN_BATCH, length, 384, state_dim):.5f} ms; "
                   f"{fwd_plan(TRAIN_BATCH, state_dim, save_bounds=True)}"
                   if name == "scan_fwd_bounds_f32" else "")
            log(f"time {name} N={state_dim} L={length} B={TRAIN_BATCH} D=384 (device, CUDA "
                f"graph): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms "
                f"({b_by}); eager (host launch included) {eager:.4f} ms{fwd}")
            train_rows.setdefault(name, (ms, plain_ms, b_ms, b_by))
    t_counts = training["counts"]
    log(f"training launches over {training['steps']} micro-steps (phase 8b): {t_counts}; per "
        f"micro-step: bounds forward {t_counts.get('scan_fwd_bounds_f32', 0) / training['steps']:g}"
        f", backward {t_counts.get('scan_bwd_f32', 0) / training['steps']:g} (1 per scan)")

    # the carried-state training scans (rows 4s, 5s) at the streaming
    # term's shapes: batch 8, local blocks (L = 100, N = 64) and global
    # blocks (the 64 summary tokens, N = 32); their bytes add h0 and gh read
    # and h_final and dh0 written once
    for state_dim, length in ((64, STREAM_CHUNK // 2), (32, 64)):
        x, dt, A, B, C, h0 = scan_inputs(rng, length, state_dim, batch=STREAM_BATCH,
                                         with_state=True)
        g = torch.tensor(rng.standard_normal((STREAM_BATCH, length, 384)).astype(np.float32),
                         device="cuda")
        gh = torch.tensor(rng.standard_normal((STREAM_BATCH, 384, state_dim)).astype(np.float32),
                          device="cuda")
        _, bounds, _ = scan_fwd_bounds_state(x, dt, A, B, C, h0)
        cases = {
            "scan_fwd_bounds_state_f32": (
                lambda: scan_fwd_bounds_state(x, dt, A, B, C, h0),
                lambda: scan_fwd_bounds_plain(x, dt, A, B, C, h0, return_state=True),
                scan_bounds_cost),
            "scan_bwd_state_f32": (lambda: scan_bwd_state(x, dt, A, B, C, bounds, g, gh),
                                   lambda: scan_bwd_plain(x, dt, A, B, C, bounds, g, gh),
                                   scan_bwd_cost),
        }
        for name, (kernel, plain, cost) in cases.items():
            ms = graph_time_ms(kernel, iters=20)
            eager = cuda_time_ms(kernel, iters=20)
            plain_ms = graph_time_ms(plain, iters=2)
            b_ms, b_by = bound_ms(*cost(STREAM_BATCH, length, 384, state_dim, with_state=True))
            fwd = (f", exp floor {exp_floor_ms(STREAM_BATCH, length, 384, state_dim):.5f} ms; "
                   f"{fwd_plan(STREAM_BATCH, state_dim, with_state=True, save_bounds=True)}"
                   if name == "scan_fwd_bounds_state_f32" else "")
            log(f"time {name} N={state_dim} L={length} B={STREAM_BATCH} D=384 (device, CUDA "
                f"graph): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms "
                f"({b_by}); eager (host launch included) {eager:.4f} ms{fwd}")
            train_rows.setdefault(name, (ms, plain_ms, b_ms, b_by))
    s_counts = stream_training["counts"]
    s_steps = stream_training["steps"]
    log(f"streaming-aware training launches over {s_steps} micro-steps and "
        f"{stream_training['chunks']} chunks (phase 9b): {s_counts}")
    # where a forward block's time goes: the timeline entry (the offline
    # and the bounds instantiation with clock64 stamps; no path calls it)
    # at the offline path's (1, 200) and the training path's (16, 300)
    for batch, length, save_bounds in ((1, 200, False), (TRAIN_BATCH, 300, False),
                                       (TRAIN_BATCH, 300, True)):
        args = scan_inputs(rng, length, 64, batch=batch)
        y, _, clocks = scan_fwd_timeline(*args, save_bounds=save_bounds)
        same = torch.equal(y, scan_fwd(*args))
        shares = timeline_shares(clocks.cpu(), length)
        blocks = shares["blocks"]
        log(f"timeline of block (0, 0), {'bounds forward' if save_bounds else 'scan forward'} "
            f"N=64 L={length} B={batch} D=384: {shares['total'][0]} cycles at "
            f"{shares['clock_ghz']:.3f} GHz; "
            + ", ".join(f"{k} {shares[k][1] * 100:.1f}%" for k in TIMELINE_PHASES)
            + f"; all {blocks['count']} blocks on {blocks['sms']} SMs (at most "
            f"{blocks['per_sm_max']} an SM, {blocks['late_blocks']} started after the first "
            f"ended) over {blocks['span_us']:.3f} us, a block's own time median "
            f"{blocks['block_us'][0]:.3f} us ({blocks['block_us'][1]:.3f}-"
            f"{blocks['block_us'][2]:.3f}); y {'bit-equal to' if same else 'DIFFERS from'} "
            f"scan_fwd's")
        if not same:
            raise AssertionError("the timeline entry computes another y than scan_fwd")

    # row 5 at phase 9b's offline term: batch 8, local blocks at the frame
    # bucket 9b ran most often (L = frames / 2, N = 64)
    t_bucket = stream_training["buckets"].most_common(1)[0][0]
    length = t_bucket // 2
    x, dt, A, B, C = scan_inputs(rng, length, 64, batch=STREAM_BATCH)
    g = torch.tensor(rng.standard_normal((STREAM_BATCH, length, 384)).astype(np.float32),
                     device="cuda")
    _, bounds = scan_fwd_bounds(x, dt, A, B, C)
    ms = graph_time_ms(lambda: scan_bwd(x, dt, A, B, C, bounds, g), iters=10)
    eager = cuda_time_ms(lambda: scan_bwd(x, dt, A, B, C, bounds, g), iters=10)
    b_ms, b_by = bound_ms(*scan_bwd_cost(STREAM_BATCH, length, 384, 64))
    log(f"time scan_bwd_f32 N=64 L={length} B={STREAM_BATCH} D=384 (phase 9b's offline term at "
        f"its most frequent bucket, {t_bucket} frames) (device, CUDA graph): kernel {ms:.4f} ms, "
        f"bound {b_ms:.5f} ms ({b_by}); eager (host launch included) {eager:.4f} ms")

    audio, padded = mel_inputs(rng, bucket)
    mel_ms = graph_time_ms(lambda: log_mel(padded), iters=50)
    mel_eager = cuda_time_ms(lambda: log_mel(padded), iters=50)
    mel_plain = graph_time_ms(lambda: log_mel_plain(padded), iters=50)
    front = cuda_time_ms(lambda: compute_mel_spectrogram(audio), iters=50)
    window = torch.hann_window(400, device="cuda")
    fb = torch.tensor(mel_filterbank(), device="cuda")

    def library():
        spec = torch.stft(padded[0], 400, 160, window=window, center=False, return_complex=True)
        return torch.log(fb @ spec.abs().square() + 1e-10)

    lib_ms = graph_time_ms(library, iters=50)
    lib_err = (library().T - log_mel(padded)[0]).abs().max().item()
    mb_ms, mb_by = bound_ms(*mel_cost(padded, bucket))
    log(f"time log_mel T={bucket} (device, CUDA graph): kernel {mel_ms:.4f} ms, plain "
        f"{mel_plain:.4f} ms, library (stft+power+fb+log) {lib_ms:.4f} ms (max_abs vs kernel "
        f"{lib_err:.3e}), bound {mb_ms:.5f} ms ({mb_by}); eager (host launch included): kernel "
        f"{mel_eager:.4f} ms, the whole front end (compute_mel_spectrogram: pad, kernel, "
        f"normalise) {front:.4f} ms")
    # the training path's log-mel: one launch over a batch of 8 at the
    # frame bucket phase 9b ran most often
    n_frames = STREAM_BATCH * t_bucket
    t_audio, t_padded = mel_inputs(rng, t_bucket, STREAM_BATCH)
    t_ms = graph_time_ms(lambda: log_mel(t_padded), iters=20)
    t_plain = graph_time_ms(lambda: log_mel_plain(t_padded), iters=20)
    t_eager = cuda_time_ms(lambda: log_mel(t_padded), iters=20)
    t_front = cuda_time_ms(lambda: compute_mel_spectrogram(t_audio), iters=20)

    def t_library():
        spec = torch.stft(t_padded, 400, 160, window=window, center=False,
                          return_complex=True)
        return torch.log(fb @ spec.abs().square() + 1e-10)

    t_lib = graph_time_ms(t_library, iters=20)
    tb_ms, tb_by = bound_ms(*mel_cost(t_padded, n_frames))
    log(f"time log_mel B={STREAM_BATCH} T={t_bucket} ({n_frames} rows, phase 9b's most "
        f"frequent bucket {dict(stream_training['buckets'])}) (device, CUDA graph): kernel "
        f"{t_ms:.4f} ms, plain {t_plain:.4f} ms, library {t_lib:.4f} ms, bound {tb_ms:.5f} ms "
        f"({tb_by}); eager (host launch included): kernel {t_eager:.4f} ms, the whole front "
        f"end (normalise over the batch) {t_front:.4f} ms; launches: "
        f"{counts.get('log_mel_f32', 0)} offline (phase 4), {s_counts.get('log_mel_f32', 0)} "
        f"streaming-aware training (phase 9b), {served.get('log_mel_f32', 0)} /transcribe "
        f"(phase 11b)")

    # int8 at every distinct shape of the batched path (batch 16, its most
    # common padded length) and at a K that runs in stages, with x in fp32
    # and in bf16 (what the batched path's bf16 model hands its
    # projections); the JSON line carries the (16 * L) x 192 -> 192 shape,
    # 3 of the 11 projections, in bf16
    frames = batched["int8"]["bucket"]
    int8_rows = {}
    shapes = sorted({(m, k, n) for _, m, k, n in int8_shapes(BATCH, frames)})
    for m, k, n in shapes + [(frames // 2 * BATCH, INT8_STAGED_K, 192)]:
        for dtype, x_bytes in (("float32", 4), ("bfloat16", 2)):
            t = time_int8(rng, m, k, n, dtype)
            b_ms, b_by = int8_bound_ms(m, k, n, x_bytes)
            int_mm = "n/a" if t["int_mm"] is None else f"{t['int_mm']:.4f} ms"
            log(f"time int8 M={m} K={k} N={n} x {dtype} (device, CUDA graph): dynamic "
                f"{t['dynamic']:.4f} ms, static {t['static']:.4f} ms, plain "
                f"{t['plain_dynamic']:.4f} / {t['plain_static']:.4f} ms, torch._int_mm {int_mm}, "
                f"bound {b_ms:.5f} ms ({b_by}); eager (host launch included) "
                f"{t['eager_dynamic']:.4f} / {t['eager_static']:.4f} ms")
            int8_rows[(m, k, n, dtype)] = (t, b_ms, b_by)
    t, i8_b, i8_by = int8_rows[(frames // 2 * BATCH, 192, 192, "bfloat16")]
    per_utt = {mode: batched[mode]["counts"].get(name, 0) / (batched[mode]["batches"] * BATCH)
               for mode, name in (("int8", "int8_dense_dynamic_f32"),
                                  ("int8_static", "int8_dense_static_f32"))}
    log(f"int8 launches per utterance at batch {BATCH}: dynamic {per_utt['int8']:.4f}, "
        f"static {per_utt['int8_static']:.4f} (11 per batched forward)")

    scan_ms, scan_plain, scan_b, scan_by = rows[0]

    def int8_entry(name, replaces, mode, kind):
        return {"name": name, "route": "cuda", "source": INT8_SOURCE, "replaces": replaces,
                "launches": batched[mode]["counts"].get(name, 0), "max_abs_err": errs[name],
                "ms": t[kind], "plain_ms": t[f"plain_{kind}"], "bound_ms": i8_b,
                "bound_by": i8_by, "library_ms": t["int_mm"]}

    return {"kernels": [
        {"name": "scan_fwd_f32", "route": "cuda", "source": SCAN_SOURCE,
         "replaces": SCAN_REPLACES,
         "launches": counts.get("scan_fwd_f32", 0) + served.get("scan_fwd_f32", 0),
         "max_abs_err": errs["scan_fwd_f32"], "ms": scan_ms, "plain_ms": scan_plain,
         "bound_ms": scan_b, "bound_by": scan_by, "library_ms": None},
        {"name": "scan_fwd_state_f32", "route": "cuda", "source": SCAN_SOURCE,
         "replaces": SCAN_REPLACES, "launches": state_launches,
         "max_abs_err": errs["scan_fwd_state_f32"], "ms": state_rows[0][0],
         "plain_ms": state_rows[0][1], "bound_ms": state_rows[0][2],
         "bound_by": state_rows[0][3], "library_ms": None},
        {"name": "log_mel_f32", "route": "cuda", "source": MEL_SOURCE,
         "replaces": MEL_REPLACES,
         "launches": (counts.get("log_mel_f32", 0) + s_counts.get("log_mel_f32", 0)
                      + served.get("log_mel_f32", 0)),
         "max_abs_err": errs["log_mel_f32"], "ms": mel_ms, "plain_ms": mel_plain,
         "bound_ms": mb_ms, "bound_by": mb_by, "library_ms": lib_ms},
        int8_entry("int8_dense_dynamic_f32", INT8_DYNAMIC_REPLACES, "int8", "dynamic"),
        int8_entry("int8_dense_static_f32", INT8_STATIC_REPLACES, "int8_static", "static"),
    ] + [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": t_counts.get(name, 0) + s_counts.get(name, 0), "max_abs_err": errs[name],
         "ms": train_rows[name][0], "plain_ms": train_rows[name][1],
         "bound_ms": train_rows[name][2], "bound_by": train_rows[name][3], "library_ms": None}
        for name, source, replaces in (
            ("scan_fwd_bounds_f32", SCAN_SOURCE, SCAN_REPLACES),
            ("scan_bwd_f32", SCAN_BWD_SOURCE, SCAN_BWD_REPLACES),
            ("scan_fwd_bounds_state_f32", SCAN_SOURCE, SCAN_BOUNDS_STATE_REPLACES),
            ("scan_bwd_state_f32", SCAN_BWD_SOURCE, SCAN_BWD_STATE_REPLACES))
    ]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--utterances", type=int, default=200,
                        help="held-out utterances on the offline and batched paths (default 200)")
    args = parser.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from velocity_asr_tpu_torch.device import resolve_device

    resolve_device("cuda")  # also turns TF32 off for matmuls and convolutions

    tmp = tempfile.mkdtemp(prefix="velocity_asr_smoke_")
    try:
        card = run_phase("1 card", phase_card, t_start)
        run_phase("2 build", phase_build, t_start)
        manifest, plan = run_phase(
            "3a corpus and shapes", lambda: phase_corpus(tmp, args.utterances), t_start)
        errs = run_phase("3 kernels vs plain", lambda: phase_compare(plan), t_start)
        counts, bucket, offline_texts = run_phase(
            "4 offline path", lambda: phase_main_path(manifest, plan), t_start)
        batched = run_phase("5 batched int8 path", lambda: phase_batched(manifest, plan), t_start)
        streaming, stream_wers, stream_texts = run_phase(
            "7 streaming path", lambda: phase_streaming(manifest, plan), t_start)
        beam = run_phase("10 beam search", lambda: phase_beam(manifest, plan), t_start)
        streaming.update(beam["stream"])
        serve = run_phase(
            "11 serve", lambda: phase_serve(manifest, plan, card, offline_texts, stream_texts,
                                            beam["lm_texts"]), t_start)
        streaming.update(serve["stream"])
        training = run_phase(
            "8 training", lambda: phase_training(manifest, batched), t_start)
        stream_training = run_phase(
            "9 streaming-aware training",
            lambda: phase_stream_training(manifest, stream_wers), t_start)
        data_counts = collections.Counter(run_phase(
            "12a formats", lambda: phase_formats(tmp, manifest, offline_texts), t_start))
        data_counts.update(run_phase(
            "12b long-form offline", lambda: phase_longform_offline(plan), t_start))
        disk_counts, profile_dir = run_phase(
            "12c training from disk", lambda: phase_disk_training(tmp), t_start)
        data_counts.update(disk_counts)
        run_phase("12d profile_dir", lambda: phase_profile(profile_dir), t_start)
        kernels = run_phase(
            "6 timing",
            lambda: phase_timing(counts, bucket, errs, batched, streaming, training,
                                 stream_training, serve["transcribe"]), t_start)
        for kernel in kernels["kernels"]:  # phase 12's launches join each kernel's count
            kernel["launches"] += data_counts.get(kernel["name"], 0)
    except PhaseFailed as e:
        print(f"chip_smoke: phase {e} failed", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"total: {time.perf_counter() - t_start:.3f} s")
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
