"""The port's WAV decoding and audio helpers are bit-exact with the JAX
package's (same numpy arithmetic on the same inputs)."""

import struct
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velocity_asr_tpu import audio as jaudio
from velocity_asr_tpu import io as jio
from velocity_asr_tpu_torch import audio as taudio
from velocity_asr_tpu_torch import io as tio


def _wav_bytes(tag, channels, rate, bits, payload, extensible=False):
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", 0xFFFE if extensible else tag, channels, rate,
                      rate * block, block, bits)
    if extensible:
        fmt += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", tag) + b"\x00" * 14
    chunks = b"fmt " + struct.pack("<I", len(fmt)) + fmt
    chunks += b"data" + struct.pack("<I", len(payload)) + payload
    if len(payload) % 2:
        chunks += b"\x00"
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def _payload(kind, n, channels, rng):
    if kind == "pcm8":
        return 1, 8, rng.integers(0, 256, n * channels, dtype=np.uint8).tobytes()
    if kind == "pcm16":
        return 1, 16, rng.integers(-32768, 32767, n * channels).astype("<i2").tobytes()
    if kind == "pcm24":
        return 1, 24, rng.integers(0, 256, n * channels * 3, dtype=np.uint8).tobytes()
    if kind == "pcm32":
        return 1, 32, rng.integers(-2**31, 2**31 - 1, n * channels).astype("<i4").tobytes()
    if kind == "float32":
        return 3, 32, rng.standard_normal(n * channels).astype("<f4").tobytes()
    return 3, 64, rng.standard_normal(n * channels).astype("<f8").tobytes()


@pytest.mark.parametrize("kind", ["pcm8", "pcm16", "pcm24", "pcm32", "float32", "float64"])
@pytest.mark.parametrize("channels,extensible", [(1, False), (2, False), (2, True)])
def test_wav_decode_bit_exact(tmp_path, kind, channels, extensible):
    rng = np.random.default_rng(len(kind) + channels)
    tag, bits, payload = _payload(kind, 301, channels, rng)
    path = tmp_path / f"{kind}.wav"
    path.write_bytes(_wav_bytes(tag, channels, 16000, bits, payload, extensible))
    ours, sr = tio.decode_audio_file(str(path))
    ref, ref_sr = jio._decode_wav_python(str(path))
    assert sr == ref_sr == 16000
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def test_decode_rejects_non_wav(tmp_path):
    """A corrupt FLAC goes to the native decoder, which rejects it as the
    JAX package's does."""
    path = tmp_path / "x.flac"
    path.write_bytes(b"fLaC" + b"\x00" * 64)
    with pytest.raises(ValueError, match="native decoder failed") as ours:
        tio.decode_audio_file(str(path))
    with pytest.raises(ValueError) as ref:
        jio.decode_audio_file(str(path))
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("rate", [16000, 8000, 22050])
def test_load_audio_matches_jax(tmp_path, rate):
    rng = np.random.default_rng(rate)
    pcm = rng.integers(-20000, 20000, (rate // 2, 2)).astype("<i2")
    path = str(tmp_path / "stereo.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    np.testing.assert_array_equal(taudio.load_audio(path), jaudio.load_audio(path))


def test_window_and_filterbank_bit_exact():
    np.testing.assert_array_equal(taudio.hann_window(), jaudio.hann_window())
    # torch builds its window in fp32, ours in fp64 then rounds: 1 ulp apart.
    np.testing.assert_allclose(taudio.hann_window(400), torch.hann_window(400).numpy(),
                               rtol=0, atol=1e-6)
    for args in [(), (512, 64, 16000), (400, 40, 8000)]:
        np.testing.assert_array_equal(taudio.mel_filterbank(*args), jaudio.mel_filterbank(*args))


@pytest.mark.parametrize("n", [0, 1, 159, 160, 161, 16000, 15923])
def test_frame_count(n):
    assert taudio.frame_count(n) == jaudio.frame_count(n)


@pytest.mark.parametrize("n", [400, 560, 16400, 16323])
def test_frame_signal_bit_exact(n):
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    ref = np.asarray(jaudio._frame_signal(jnp.asarray(x), 400, 160))
    np.testing.assert_array_equal(taudio.frame_signal(torch.from_numpy(x), 400, 160).numpy(), ref)


def test_reflect_pad_matches_numpy():
    x = np.random.default_rng(0).standard_normal((2, 1000)).astype(np.float32)
    np.testing.assert_array_equal(taudio.reflect_pad(torch.from_numpy(x), 200).numpy(),
                                  np.pad(x, ((0, 0), (200, 200)), mode="reflect"))


@pytest.mark.parametrize("n", [1, 2, 3, 150, 200, 201, 399, 400])
def test_reflect_pad_short_signal_matches_numpy(n):
    """A pad as long as the signal or longer reflects again and again, as
    np.pad does (a single sample repeats), bit for bit."""
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    np.testing.assert_array_equal(taudio.reflect_pad(torch.from_numpy(x), 200).numpy(),
                                  np.pad(x, ((0, 0), (200, 200)), mode="reflect"))
