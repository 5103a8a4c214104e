"""Host-side audio file decoding (mirrors velocity_asr_tpu/io.py).

WAV, FLAC, MPEG Layer III (mp3) and Ogg Vorbis decode through the
repo's native C++ library (``native/audio_decoder.cc``,
``mp3_decoder.cc``, ``vorbis_decoder.cc``), and m4a/AAC through its
system-codec shim (``native/m4a_decoder.cc`` over libavformat /
libavcodec), both loaded with ctypes. The port builds them itself at
first use, with ``g++`` and the flags of ``native/Makefile``, into a
directory of ``velocity_asr_tpu_torch/_build/`` named after the host's
CPU (the shim only where the libavformat header exists, as the Makefile
gates it): ``-march=native`` code runs only on the CPU it was built for,
so a tree copied to another machine builds that machine's own. It never
runs the Makefile and never loads another copy. Builds run under a file
lock into a temporary name, then move into place, so worker processes
and threads asking at once all get the one library. Without a compiler only WAV decodes (a
pure-Python parser), and other formats raise with a conversion hint.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import platform
import shutil
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
NATIVE_DIR = os.path.join(os.path.dirname(_HERE), "native")
BUILD_DIR = os.path.join(_HERE, "_build")
# native/Makefile:2
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
# native/Makefile:11: the m4a shim builds only where this header exists
AVFORMAT_HEADERS = ("/usr/include/x86_64-linux-gnu/libavformat/avformat.h",
                    "/usr/include/libavformat/avformat.h")
AUDIO_LIB = "libvelocity_audio.so"
AUDIO_SOURCES = ("audio_decoder.cc", "mp3_decoder.cc", "vorbis_decoder.cc")
AUDIO_DEPS = AUDIO_SOURCES + ("mp3_tables.h", "vorbis_tables.h")
M4A_LIB = "libvelocity_m4a.so"
M4A_SOURCES = ("m4a_decoder.cc",)
M4A_LIBS = ("-lavformat", "-lavcodec", "-lswresample", "-lavutil")

_NATIVE_LIB: Optional[ctypes.CDLL] = None
_NATIVE_CHECKED = False
_NATIVE_LOCK = threading.Lock()

_M4A_LIB: Optional[ctypes.CDLL] = None
_M4A_CHECKED = False

_DECODE_ARGTYPES = [
    ctypes.c_char_p,
    ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
    ctypes.POINTER(ctypes.c_int64),
    ctypes.POINTER(ctypes.c_int32),
    ctypes.POINTER(ctypes.c_int32),
]


def host_build_dir(cpuinfo: str = "/proc/cpuinfo") -> str:
    """``_build/native-<machine>-<key>``: key hashes the CPU's feature
    flags (`cpuinfo`), the instruction sets ``-march=native`` may use, so
    a library is found current only on a CPU that runs it."""
    flags = platform.processor()
    try:
        with open(cpuinfo) as f:
            flags = next((line for line in f if line.startswith(("flags", "Features"))),
                         flags)
    except OSError:
        pass
    key = hashlib.sha256(" ".join(sorted(flags.split())).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"native-{platform.machine()}-{key}")


def build_native_library(name: str, sources: Sequence[str], deps: Sequence[str] = (),
                         libs: Sequence[str] = (),
                         build_dir: Optional[str] = None) -> Optional[str]:
    """Path of `name` built from `sources` under ``native/`` into
    `build_dir` (default ``host_build_dir()``): built now if it is missing
    or older than a source or dep, else as it is. None if there is no C++
    compiler or the compile fails (logged).

    Many processes may ask at once: the build runs under an exclusive
    ``fcntl`` lock on a file in the build directory, into a temporary name
    that ``os.replace`` moves into place, and a process that waited on the
    lock finds the library built."""
    build_dir = build_dir or host_build_dir()
    out = os.path.join(build_dir, name)
    inputs = [os.path.join(NATIVE_DIR, f) for f in tuple(sources) + tuple(deps)]
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, ".native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out) and all(os.path.getmtime(out) >= os.path.getmtime(f)
                                       for f in inputs):
            return out
        if cxx is None:
            return None
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [cxx, *CXXFLAGS, "-shared", "-o", tmp,
               *(os.path.join(NATIVE_DIR, f) for f in sources), *libs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            logger.warning("building %s failed (exit %d): %s", name, proc.returncode,
                           proc.stderr[-2000:])
            if os.path.exists(tmp):
                os.unlink(tmp)
            return None
        os.replace(tmp, out)
        return out


def _load_native() -> Optional[ctypes.CDLL]:
    global _NATIVE_LIB, _NATIVE_CHECKED
    if _NATIVE_CHECKED:
        return _NATIVE_LIB
    with _NATIVE_LOCK:
        return _load_native_locked()


def _load_native_locked() -> Optional[ctypes.CDLL]:
    # Data-loader threads race to the first load; _NATIVE_CHECKED must only
    # flip after _NATIVE_LIB is fully initialized (hence the lock + ordering).
    global _NATIVE_LIB, _NATIVE_CHECKED
    if _NATIVE_CHECKED:
        return _NATIVE_LIB
    path = build_native_library(AUDIO_LIB, AUDIO_SOURCES, AUDIO_DEPS)
    if path is None:
        _NATIVE_CHECKED = True
        return None
    try:
        lib = ctypes.CDLL(path)
        # int va_decode_file(const char* path, float** out_samples,
        #                    int64_t* out_frames, int32_t* out_channels,
        #                    int32_t* out_sample_rate)
        lib.va_decode_file.restype = ctypes.c_int
        lib.va_decode_file.argtypes = _DECODE_ARGTYPES
        lib.va_free.restype = None
        lib.va_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        _NATIVE_LIB = lib
    except OSError:
        _NATIVE_LIB = None
    _NATIVE_CHECKED = True
    return _NATIVE_LIB


def native_available() -> bool:
    """Whether the native C++ audio decoder is loaded (built first if
    needed)."""
    return _load_native() is not None


def _m4a_buildable() -> bool:
    return any(os.path.exists(h) for h in AVFORMAT_HEADERS)


def _load_m4a() -> Optional[ctypes.CDLL]:
    """Build (where the libavformat header exists) and load the m4a shim,
    once."""
    global _M4A_LIB, _M4A_CHECKED
    if _M4A_CHECKED:
        return _M4A_LIB
    with _NATIVE_LOCK:
        if _M4A_CHECKED:
            return _M4A_LIB
        path = build_native_library(M4A_LIB, M4A_SOURCES, libs=M4A_LIBS) \
            if _m4a_buildable() else None
        lib = None
        if path is not None:
            try:
                lib = ctypes.CDLL(path)
                lib.va_m4a_decode_file.restype = ctypes.c_int
                lib.va_m4a_decode_file.argtypes = _DECODE_ARGTYPES
                lib.va_m4a_free.restype = None
                lib.va_m4a_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
                lib.va_m4a_encode_file.restype = ctypes.c_int
                lib.va_m4a_encode_file.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.c_int64,
                    ctypes.c_int32,
                ]
            except OSError:
                # built, but its libav* dependencies are not loadable on
                # this host: treat as unavailable
                lib = None
        _M4A_LIB = lib
        _M4A_CHECKED = True
        return _M4A_LIB


def m4a_available() -> bool:
    """Whether the system-codec m4a/AAC decoder shim is loaded."""
    return _load_m4a() is not None


def _decode_with(decode, free, path: str, what: str) -> Tuple[np.ndarray, int]:
    """Call a native decoder; (channels, samples) float32 and the rate."""
    out_ptr = ctypes.POINTER(ctypes.c_float)()
    out_frames = ctypes.c_int64(0)
    out_channels = ctypes.c_int32(0)
    out_rate = ctypes.c_int32(0)
    rc = decode(path.encode("utf-8"), ctypes.byref(out_ptr), ctypes.byref(out_frames),
                ctypes.byref(out_channels), ctypes.byref(out_rate))
    if rc != 0:
        raise ValueError(f"{what} failed on {path!r} (code {rc})")
    n = out_frames.value * out_channels.value
    try:
        buf = np.ctypeslib.as_array(out_ptr, shape=(n,)).copy()
    finally:
        free(out_ptr)
    # Native layout is interleaved (frames, channels); return (channels, frames).
    data = buf.reshape(out_frames.value, out_channels.value).T
    return np.ascontiguousarray(data, dtype=np.float32), out_rate.value


def _decode_m4a(path: str) -> Tuple[np.ndarray, int]:
    lib = _load_m4a()
    assert lib is not None
    return _decode_with(lib.va_m4a_decode_file, lib.va_m4a_free, path, "m4a decoder")


def _decode_native(path: str) -> Tuple[np.ndarray, int]:
    lib = _load_native()
    assert lib is not None
    return _decode_with(lib.va_decode_file, lib.va_free, path, "native decoder")


def encode_m4a(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Encode mono float32 PCM to AAC-LC in an mp4 container (test
    fixtures). Raises if the system-codec shim is absent."""
    lib = _load_m4a()
    if lib is None:
        raise RuntimeError(
            "m4a support requires the system libavformat/libavcodec stack "
            "(the shim builds where the ffmpeg dev headers exist)"
        )
    pcm = np.ascontiguousarray(samples, dtype=np.float32).reshape(-1)
    rc = lib.va_m4a_encode_file(
        path.encode("utf-8"),
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(pcm),
        int(sample_rate),
    )
    if rc != 0:
        raise ValueError(f"m4a encoder failed on {path!r} (code {rc})")


def _decode_wav_python(path: str) -> Tuple[np.ndarray, int]:
    """Pure-Python RIFF/WAVE decode: PCM 8/16/24/32-bit, IEEE float32/64,
    and WAVE_FORMAT_EXTENSIBLE wrappers of both."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path!r}")
        fmt = raw = None
        while fmt is None or raw is None:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid = hdr[:4]
            size = int.from_bytes(hdr[4:8], "little")
            payload = f.read(size)
            if cid == b"fmt ":
                fmt = payload
            elif cid == b"data":
                raw = payload
            if size % 2:  # RIFF chunks are word-aligned
                f.seek(1, 1)
    if fmt is None or len(fmt) < 16 or raw is None:
        raise ValueError(f"WAV missing fmt/data chunk: {path!r}")

    tag = int.from_bytes(fmt[0:2], "little")
    channels = int.from_bytes(fmt[2:4], "little")
    rate = int.from_bytes(fmt[4:8], "little")
    bits = int.from_bytes(fmt[14:16], "little")
    if tag == 0xFFFE and len(fmt) >= 26:
        # WAVE_FORMAT_EXTENSIBLE: the real format is the first two bytes
        # of the SubFormat GUID.
        tag = int.from_bytes(fmt[24:26], "little")
    if channels <= 0 or rate <= 0:
        raise ValueError(f"invalid WAV header (channels={channels}, rate={rate})")

    def trim(buf: bytes, itemsize: int) -> bytes:
        return buf[: (len(buf) // itemsize) * itemsize]

    if tag == 3:  # IEEE float
        if bits == 32:
            data = np.frombuffer(trim(raw, 4), dtype="<f4").astype(np.float32)
        elif bits == 64:
            data = np.frombuffer(trim(raw, 8), dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"unsupported float WAV bit depth: {bits}")
    elif tag == 1:  # integer PCM
        if bits == 16:
            data = np.frombuffer(trim(raw, 2), dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            data = (
                np.frombuffer(trim(raw, 4), dtype="<i4").astype(np.float32)
                / 2147483648.0
            )
        elif bits == 8:
            data = (
                np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0
            ) / 128.0
        elif bits == 24:
            b = np.frombuffer(trim(raw, 3), dtype=np.uint8).reshape(-1, 3)
            vals = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            data = vals.astype(np.float32) / float(1 << 23)
        else:
            raise ValueError(f"unsupported WAV bit depth: {bits}")
    else:
        raise ValueError(f"unsupported WAV format tag: {tag}")

    n = (len(data) // channels) * channels
    data = data[:n].reshape(-1, channels).T
    return np.ascontiguousarray(data, dtype=np.float32), rate


def supported_audio_exts() -> Tuple[str, ...]:
    """Extensions the current build can decode: WAV always; FLAC, mp3
    and Ogg Vorbis with the native library; m4a/mp4 with the shim."""
    exts: Tuple[str, ...] = (".wav",)
    if native_available():
        exts = (".wav", ".flac", ".mp3", ".ogg", ".oga")
    if m4a_available():
        exts = exts + (".m4a", ".mp4")
    return exts


def _sniff_format(path: str) -> str:
    """Container format from magic bytes: 'wav'|'flac'|'mp3'|'ogg'|'m4a'|''."""
    try:
        with open(path, "rb") as f:
            head = f.read(12)
    except OSError:
        return ""
    if head[:4] == b"RIFF" and head[8:12] == b"WAVE":
        # RIFF alone is not enough (AVI/WebP are RIFF too).
        return "wav"
    if head[4:8] == b"ftyp":
        # ISO BMFF (mp4/m4a/mov): box size then the 'ftyp' box type.
        return "m4a"
    head = head[:4]
    if head == b"fLaC":
        return "flac"
    if head == b"OggS":
        return "ogg"
    if _looks_like_mp3(head):
        return "mp3"
    return ""


def _looks_like_mp3(head: bytes) -> bool:
    """ID3v2 container or an MPEG-1/2/2.5 Layer III frame sync."""
    if head[:3] == b"ID3":
        return True
    if len(head) < 4 or head[0] != 0xFF or (head[1] & 0xE0) != 0xE0:
        return False
    version_bits = (head[1] >> 3) & 3
    layer_bits = (head[1] >> 1) & 3
    bitrate_index = head[2] >> 4
    sr_index = (head[2] >> 2) & 3
    return (
        version_bits != 1
        and layer_bits == 1
        and bitrate_index not in (0, 15)
        and sr_index != 3
    )


def decode_audio_file(path: str) -> Tuple[np.ndarray, int]:
    """Decode an audio file to ((channels, samples) float32, sample_rate).

    Dispatch is by content sniffing (magic bytes) with the extension as
    the tiebreak for headerless files (the server's request bodies carry
    no meaningful name), as the JAX package dispatches; a WAV the native
    reader refuses goes to the Python parser as well (the JAX package
    raises there). A format no decoder here handles fails fast with a
    conversion hint.
    """
    lower = path.lower()
    exts = supported_audio_exts()
    sniffed = _sniff_format(path)
    if not lower.endswith(exts):
        known = {
            "wav": True,
            "flac": native_available(),
            "mp3": native_available(),
            "ogg": native_available(),
            "m4a": m4a_available(),
        }
        if not known.get(sniffed, False):
            raise RuntimeError(
                f"Cannot decode {path!r}: unsupported format. Supported: "
                f"{', '.join(exts)}. (m4a requires the system "
                "libavformat/libavcodec stack; convert with e.g. "
                "`ffmpeg -i in.m4a -ar 16000 out.wav`.)"
            )
    if sniffed == "m4a" or (not sniffed and lower.endswith((".m4a", ".mp4"))):
        if not m4a_available():
            raise RuntimeError(
                f"Cannot decode {path!r}: m4a requires the system "
                "libavformat/libavcodec stack (absent here). Convert with "
                "e.g. `ffmpeg -i in.m4a -ar 16000 out.wav`."
            )
        return _decode_m4a(path)
    if native_available():
        try:
            return _decode_native(path)
        except ValueError:
            if sniffed != "wav":
                raise
            # the native WAV reader refuses some encodings the Python one
            # reads (float64 samples): a WAV gets the Python parser too
            return _decode_wav_python(path)
    # The Python fallback parses WAV only: verify the content really is a
    # WAV before handing it to the RIFF parser, so a misnamed FLAC/mp3
    # fails with the conversion hint, not an opaque parser error.
    if sniffed != "wav":
        raise RuntimeError(
            f"Cannot decode {path!r}: only WAV is supported until the "
            "native decoder is built (a C++ compiler builds it at first use; "
            "it adds flac/mp3/ogg). Convert with e.g. "
            "`ffmpeg -i in.xxx -ar 16000 out.wav`."
        )
    return _decode_wav_python(path)
