"""The port's native audio decoding against the JAX package's.

The port builds the repo's C++ decoders itself (``velocity_asr_tpu_torch/
_build/``) and the JAX package loads its own copy; on the same file both
must give the same samples, bit for bit: WAV (int16 and float32), FLAC
(fixed2 and verbatim subframes, from ``tests/flac_encoder.py``), mp3 and
Ogg Vorbis (from the tests' codecs over the system's libmp3lame and
libvorbisenc) and m4a (the system-codec shim). The advertised extensions
and the sniffing errors match too, with the library and without it;
two processes building the library at once both get it, and each CPU
feature set builds into a directory of its own.
"""

import os
import subprocess
import sys
import wave

import numpy as np
import pytest

from tests.flac_encoder import encode_flac
from tests.mp3_codec import lame_available, lame_encode
from tests.vorbis_codec import encoder_available, vorbis_encode
from velocity_asr_tpu import io as jio
from velocity_asr_tpu_torch import audio as taudio
from velocity_asr_tpu_torch import io as tio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HINT = "onvert with e.g. `ffmpeg"  # "Convert" or "convert"


def _signal(n=12000, rate=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    x = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1873 * t)
    return np.clip(x + 0.05 * rng.standard_normal(n), -0.95, 0.95).astype(np.float32)


def _pcm16(x):
    return np.clip(x * 32767, -32768, 32767).astype(np.int16)


def _write_wav16(path, pcm, rate=16000):
    with wave.open(path, "wb") as w:
        w.setnchannels(1 if pcm.ndim == 1 else pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def _write_wav_f32(path, x, rate=16000):
    payload = x.astype("<f4").tobytes()
    fmt = (np.array([3, 1], "<u2").tobytes() + np.array([rate, rate * 4], "<u4").tobytes()
           + np.array([4, 32], "<u2").tobytes())
    body = b"fmt " + len(fmt).to_bytes(4, "little") + fmt
    body += b"data" + len(payload).to_bytes(4, "little") + payload
    with open(path, "wb") as f:
        f.write(b"RIFF" + (4 + len(body)).to_bytes(4, "little") + b"WAVE" + body)


def _fixture(kind, tmp_path):
    """Path of a test file of `kind`, its format's extension on it."""
    x = _signal(seed=len(kind))
    if kind == "wav_int16":
        path = str(tmp_path / "a.wav")
        _write_wav16(path, _pcm16(x))
    elif kind == "wav_float":
        path = str(tmp_path / "a.wav")
        _write_wav_f32(path, x)
    elif kind.startswith("flac_"):
        path = str(tmp_path / "a.flac")
        with open(path, "wb") as f:
            f.write(encode_flac(_pcm16(x), mode=kind[5:]))
    elif kind == "mp3":
        if not lame_available():
            pytest.skip("no libmp3lame on this host")
        path = str(tmp_path / "a.mp3")
        with open(path, "wb") as f:
            f.write(lame_encode(x, 16000))
    elif kind == "ogg":
        if not encoder_available():
            pytest.skip("no libvorbisenc on this host")
        path = str(tmp_path / "a.ogg")
        with open(path, "wb") as f:
            f.write(vorbis_encode(x, 16000))
    else:
        if not tio.m4a_available():
            pytest.skip("no libavformat header on this host: the m4a shim is not built")
        path = str(tmp_path / "a.m4a")
        tio.encode_m4a(path, x, 16000)
    return path


@pytest.mark.parametrize("kind", ["wav_int16", "wav_float", "flac_fixed2", "flac_verbatim",
                                  "mp3", "ogg", "m4a"])
def test_decode_bit_equal_to_jax(tmp_path, kind):
    """decode_audio_file gives the JAX package's samples and rate, bit
    for bit, and load_audio the JAX package's waveform."""
    path = _fixture(kind, tmp_path)
    ours, rate = tio.decode_audio_file(path)
    ref, ref_rate = jio.decode_audio_file(path)
    assert rate == ref_rate == 16000
    assert ours.dtype == ref.dtype == np.float32 and ours.shape == ref.shape
    assert ours.shape[1] > 8000
    np.testing.assert_array_equal(ours, ref)
    from velocity_asr_tpu import audio as jaudio

    np.testing.assert_array_equal(taudio.load_audio(path), jaudio.load_audio(path))


def test_flac_is_lossless(tmp_path):
    """A FLAC of int16 PCM decodes to the WAV's samples exactly."""
    pcm = _pcm16(_signal(seed=9))
    wav, flac = str(tmp_path / "a.wav"), str(tmp_path / "a.flac")
    _write_wav16(wav, pcm)
    with open(flac, "wb") as f:
        f.write(encode_flac(pcm, mode="fixed2"))
    np.testing.assert_array_equal(tio.decode_audio_file(flac)[0],
                                  tio.decode_audio_file(wav)[0])


def test_supported_exts_equal_jax():
    assert tio.native_available() and tio.m4a_available() == jio.m4a_available()
    assert tio.supported_audio_exts() == jio.supported_audio_exts()


def _sniff_case(case, tmp_path):
    if case == "misnamed_flac":
        path = tmp_path / "clip.wav"
        path.write_bytes(encode_flac(_pcm16(_signal(seed=3)), mode="fixed2"))
    elif case == "riff_not_wave":
        path = tmp_path / "clip.bin"
        path.write_bytes(b"RIFF" + (100).to_bytes(4, "little") + b"AVI " + bytes(100))
    else:
        path = tmp_path / "clip.xyz"
        path.write_bytes(b"\x01\x02\x03\x04" + bytes(200))
    return str(path)


@pytest.mark.parametrize("case", ["misnamed_flac", "riff_not_wave", "unknown"])
def test_sniffing_matches_jax(tmp_path, case):
    """With the library a misnamed FLAC decodes by its content (as the JAX
    package's); a RIFF that is not WAVE and an unknown format raise the
    same RuntimeError with the conversion hint."""
    path = _sniff_case(case, tmp_path)
    if case == "misnamed_flac":
        np.testing.assert_array_equal(tio.decode_audio_file(path)[0],
                                      jio.decode_audio_file(path)[0])
        return
    with pytest.raises(RuntimeError, match="unsupported format") as ours:
        tio.decode_audio_file(path)
    with pytest.raises(RuntimeError) as ref:
        jio.decode_audio_file(path)
    assert HINT in str(ours.value)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("case", ["misnamed_flac", "riff_not_wave", "unknown"])
def test_sniffing_without_the_library_matches_jax(tmp_path, case, monkeypatch):
    """With no library (no compiler), both packages advertise WAV alone
    and raise a RuntimeError with the conversion hint for the rest."""
    for mod, prefix in ((tio, "_NATIVE"), (tio, "_M4A"), (jio, "_NATIVE"), (jio, "_M4A")):
        monkeypatch.setattr(mod, f"{prefix}_LIB", None)
        monkeypatch.setattr(mod, f"{prefix}_CHECKED", True)
    assert tio.supported_audio_exts() == jio.supported_audio_exts() == (".wav",)
    path = _sniff_case(case, tmp_path)
    with pytest.raises(RuntimeError) as ours:
        tio.decode_audio_file(path)
    with pytest.raises(RuntimeError) as ref:
        jio.decode_audio_file(path)
    assert HINT in str(ours.value) and HINT in str(ref.value)
    assert ("only WAV" in str(ours.value)) == ("only WAV" in str(ref.value))


def test_two_processes_build_the_library_at_once(tmp_path):
    """Two processes asking for the library in a fresh build directory at
    the same moment both get the one library, built once, that decodes."""
    code = (
        "import sys, ctypes\n"
        "from velocity_asr_tpu_torch import io\n"
        "p = io.build_native_library(io.AUDIO_LIB, io.AUDIO_SOURCES, io.AUDIO_DEPS, "
        "build_dir=sys.argv[1])\n"
        "ctypes.CDLL(p).va_decode_file\n"
        "print(p)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path / "build")], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err for _, err in outs]
    paths = {out.strip() for out, _ in outs}
    assert paths == {str(tmp_path / "build" / tio.AUDIO_LIB)}
    # the loser of the lock found the library built: no temporary is left
    assert sorted(os.listdir(tmp_path / "build")) == [".native.lock", tio.AUDIO_LIB]


def test_each_cpu_builds_its_own_library(tmp_path):
    """The library is compiled with -march=native, so its build directory
    is keyed by the CPU's feature flags: the same flags in another order
    give the same directory under _build/, other flags another one."""
    def cpuinfo(name, flags):
        path = tmp_path / name
        path.write_text(f"processor\t: 0\nflags\t\t: {flags}\n\nprocessor\t: 1\n"
                        f"flags\t\t: {flags}\n")
        return str(path)

    a = tio.host_build_dir(cpuinfo("a", "fpu sse2 avx2 avx512f"))
    same = tio.host_build_dir(cpuinfo("b", "avx512f avx2 fpu sse2"))
    other = tio.host_build_dir(cpuinfo("c", "fpu sse2 avx2"))
    assert a == same != other
    assert os.path.dirname(a) == tio.BUILD_DIR == os.path.dirname(tio.host_build_dir())
