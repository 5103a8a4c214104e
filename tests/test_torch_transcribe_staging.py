"""The offline entry's int16 staging (``velocity_asr_tpu_torch.transcribe``):
``fill_wire`` writes the wire format bit for bit as padding, scaling,
clipping and casting a fresh array did; ``Transcriber.transcribe_batch``
reuses one kept buffer across calls and threads and transcribes as a
fresh transcriber does. Tiny models on the CPU; the pinned buffer on a
CUDA card only."""

import math
import sys
import threading
import time

import numpy as np
import pytest
import torch

from velocity_asr_tpu_torch.decode import CTCDecoder, create_default_vocabulary
from velocity_asr_tpu_torch.models import model as tmodel
from velocity_asr_tpu_torch.models.config import VelocityASRConfig
from velocity_asr_tpu_torch.transcribe import Transcriber, fill_wire

SMALL = dict(d_model=16, ssm_layers=2, ssm_state_dim=4, global_ssm_layers=1,
             global_ssm_state_dim=4, attention_heads=2, attention_dim=8, vocab_size=30,
             scan_mode="pallas", dtype="float32")
BUCKET = 100  # frames: 15,840 samples a bucket step


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: under xdist the workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def old_wire(x: np.ndarray, pad: int) -> np.ndarray:
    """The wire as it was computed: the float32 row reflect-padded (zeros
    beyond the samples of a row under 2 samples), scaled, clipped and cast."""
    x = np.asarray(x, np.float32)
    if len(x) >= 2:
        padded = np.pad(x, (0, pad), mode="reflect")
    else:
        padded = np.zeros(len(x) + pad, np.float32)
        padded[:len(x)] = x
    return np.clip(padded * 32768.0, -32768, 32767).astype(np.int16)


def _signal(n: int, seed: int) -> np.ndarray:
    """n samples reaching past +-1.0, with -1.0, +1.0 and the int16 edges
    exactly among them."""
    x = (0.6 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)
    edges = np.array([-1.0, 1.0, 32767 / 32768, -1.5, 1.25, -32767.5 / 32768, 0.49999 / 32768],
                     np.float32)
    x[:min(n, len(edges))] = edges[:n]
    return x


# (length, pad): every length under 4, a pad of 0, of length - 1, and of
# 2x and 5x the row (repeated reflections)
CASES = [(0, 0), (0, 7), (1, 0), (1, 9), (2, 0), (2, 1), (2, 4), (2, 10), (3, 0), (3, 2),
         (3, 6), (3, 15), (8, 0), (8, 7), (8, 16), (8, 40), (1000, 0), (1000, 999),
         (1000, 2000), (1000, 5000), (15840, 0), (12345, 3495)]


@pytest.mark.parametrize("n,pad", CASES, ids=[f"len{n}-pad{p}" for n, p in CASES])
def test_fill_wire_is_bit_equal_to_the_old_wire(n, pad):
    """One row, alone and as the second row of a shared scratch that a
    longer row wrote first: the int16 equals the old formula's."""
    x = _signal(n, n + pad)
    want = old_wire(x, pad)
    out = np.full((1, n + pad), 12345, np.int16)
    fill_wire(out, [x])
    assert np.array_equal(out[0], want)
    long = _signal(n + pad + 5, 99)
    two = np.full((2, n + pad + 5), -7, np.int16)
    fill_wire(two, [long, x], np.empty(len(long), np.float32))
    assert np.array_equal(two[0], old_wire(long, 0))
    assert np.array_equal(two[1], old_wire(x, pad + 5))


def _model():
    cfg = VelocityASRConfig(**SMALL)
    return tmodel.create_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))


def _transcriber(model):
    return Transcriber(model, CTCDecoder(create_default_vocabulary(30)), frame_bucket=BUCKET)


def _batch(seed: int, lengths):
    rng = np.random.default_rng(seed)
    return [(0.5 * rng.standard_normal(n)).astype(np.float32) for n in lengths]


def _texts(out):
    return [r["text"] for r in out]


def test_kept_buffer_transcribes_as_a_fresh_transcriber():
    """Rising, then falling buckets, then one call over mixed buckets: each
    call's texts equal a fresh transcriber's; the buffer is allocated at
    most ceil(log2(largest / smallest)) + 1 times and not again for
    buckets it already holds."""
    model = _model()
    kept = _transcriber(model)
    sizes = [(2, 3000), (3, 12000), (4, 20000), (4, 45000)]  # rows x 1, 1, 2, 3 buckets
    calls = [_batch(i, [n] * rows) for i, (rows, n) in enumerate(sizes)]
    calls += calls[::-1]
    calls.append(_batch(9, [45000, 3000, 20000, 12000, 46000, 700]))
    for batch in calls:
        texts = _texts(kept.transcribe_batch(batch))
        assert texts == _texts(_transcriber(model).transcribe_batch(batch))
        assert any(texts)
    elems = [rows * kept.bucket_samples(np.empty(n)) for rows, n in sizes]
    assert 1 <= kept.staging_allocs <= math.ceil(math.log2(max(elems) / min(elems))) + 1
    assert kept.staging_fills == 8 + 3
    allocs = kept.staging_allocs
    for batch in calls:
        kept.transcribe_batch(batch)
    assert kept.staging_allocs == allocs and kept.staging_fills == 2 * (8 + 3)


def test_two_threads_on_one_transcriber_return_the_serial_texts():
    """Two threads call one transcriber at once, each on its own rows of
    the same bucket. The forward is slowed at its start, so a fill of the
    other thread's rows into the buffer the forward is about to read would
    show in the texts."""
    model = _model()
    shared = _transcriber(model)
    batches = [_batch(20 + t, [14000, 9000, 15000]) for t in range(2)]
    serial = [_texts(_transcriber(model).transcribe_batch(b)) for b in batches]
    assert serial[0] != serial[1]
    forward = shared.masked_logits

    def slow_forward(audio, n_valid):
        time.sleep(0.02)
        return forward(audio, n_valid)

    shared.masked_logits = slow_forward
    start = threading.Barrier(2)
    got = [[], []]

    def work(t):
        start.wait()
        for _ in range(4):
            got[t].append(_texts(shared.transcribe_batch(batches[t])))

    threads = [threading.Thread(target=work, args=(t,)) for t in range(2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert got == [[serial[0]] * 4, [serial[1]] * 4]
    assert shared.staging_allocs == 1 and shared.staging_fills == 8


def test_kept_buffer_is_pinned_on_the_card():
    """On a CUDA card the kept buffer is pinned, and a call's texts equal a
    fresh transcriber's call on the same rows. Skipped without a card (the
    check is made here, not at import: every worker collects the same
    tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model = _model().to("cuda")
    kept = _transcriber(model)
    batches = [_batch(30, [5000, 40000, 9000]), _batch(31, [16000] * 5)]
    for batch in batches + batches:
        texts = _texts(kept.transcribe_batch(batch))
        assert texts == _texts(_transcriber(model).transcribe_batch(batch))
    assert kept._pcm.is_pinned() and kept._frames.is_pinned()
