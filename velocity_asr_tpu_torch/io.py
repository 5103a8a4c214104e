"""WAV decoding (mirrors the pure-Python path of velocity_asr_tpu/io.py).

The JAX package also decodes FLAC, mp3, Ogg Vorbis and m4a through its
native C++ library; this slice of the port reads WAV only, with no
native code.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


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


def decode_audio_file(path: str) -> Tuple[np.ndarray, int]:
    """Decode a WAV file to ((channels, samples) float32, sample_rate)."""
    with open(path, "rb") as f:
        head = f.read(12)
    if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
        raise RuntimeError(
            f"Cannot decode {path!r}: this package reads WAV only. Convert "
            "with e.g. `ffmpeg -i in.xxx -ar 16000 out.wav`."
        )
    return _decode_wav_python(path)
