"""Build and load the package's CUDA kernels.

Each ``csrc/*.cu`` file compiles in an ``nvcc`` of its own, all started
together, and one more ``nvcc`` links them into a shared library with a
plain C interface (no PyTorch headers), keyed by a hash of the sources
and flags, under ``velocity_asr_tpu_torch/_build/``. It is loaded with
``ctypes``; every pointer and the stream pass as ``ctypes.c_void_p``.
The build happens at the first launch, never at import, and a failed
build raises.

``launch_counts`` counts the launches of each kernel: a wrapper adds one
where it launches its kernel, and nowhere else. Every C entry starts
exactly one kernel. The server launches from several threads at once, so
the count is taken under a lock.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C signature of each kernel's launcher: every one returns cudaError_t.
SIGNATURES = {
    # x, dt, A, B, C, y, batch, length, d_inner, state_dim, stream
    "scan_fwd_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, dt, A, B, C, h0, y, h_final, batch, length, d_inner, state_dim, stream
    "scan_fwd_state_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, dt, A, B, C, y, bounds, batch, length, d_inner, state_dim, stream
    "scan_fwd_bounds_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, dt, A, B, C, h0, y, bounds, h_final, batch, length, d_inner,
    # state_dim, stream
    "scan_fwd_bounds_state_f32": [_P] * 9 + [_I, _I, _I, _I, _P],
    # x, dt, A, B, C, y, bounds (or None), clocks, n_clocks, save_bounds,
    # batch, length, d_inner, state_dim, stream
    "scan_fwd_timeline_f32": [_P] * 8 + [_LL, _I, _I, _I, _I, _I, _P],
    # x, dt, A, B, C, bounds, g, dx, ddt, dA, dB, dC, work, work_floats,
    # batch, length, d_inner, state_dim, stream
    "scan_bwd_f32": [_P] * 13 + [_LL, _I, _I, _I, _I, _P],
    # x, dt, A, B, C, bounds, g, gh, dx, ddt, dA, dB, dC, dh0, work,
    # work_floats, batch, length, d_inner, state_dim, stream
    "scan_bwd_state_f32": [_P] * 15 + [_LL, _I, _I, _I, _I, _P],
    # padded, window, twiddle, band_first, band_offset, band_weight, out,
    # batch, padded_len, n_frames, hop, n_mels, n_weights, stream
    "log_mel_f32": [_P] * 7 + [_I] * 6 + [_P],
    # x, w_q, w_scale, out, x_q_out (or None), x_type, M, K, N, stream
    "int8_dense_dynamic_f32": [_P] * 5 + [_I] * 4 + [_P],
    # x, x_scale, w_q, w_scale, out, x_q_out (or None), x_type, M, K, N, stream
    "int8_dense_static_f32": [_P] * 6 + [_I] * 4 + [_P],
}

# Occupancy queries: the instantiation's arguments, then an int array out.
OCCUPANCY_SIGNATURES = {
    "log_mel_occupancy": [_I, _I, _P],  # n_mels, n_weights, out
    # batch, d_inner, state_dim, with_state, save_bounds, out
    "scan_fwd_occupancy": [_I] * 5 + [_P],
    "scan_bwd_occupancy": [_I, _I, _P],  # lanes per channel, with_state, out
    "int8_dense_occupancy": [_I] * 5 + [_P],  # is_static, x_type, M, K, N, out
}
OCCUPANCY_KEYS = {
    "log_mel_occupancy": ("registers", "spill_bytes", "shared_bytes", "blocks_per_sm",
                          "threads"),
    "scan_fwd_occupancy": ("registers", "spill_bytes", "shared_bytes", "blocks_per_sm",
                           "threads", "states_per_thread", "lanes", "channels", "grid_x",
                           "grid_y", "passes"),
    "scan_bwd_occupancy": ("registers", "spill_bytes", "shared_bytes", "blocks_per_sm",
                           "clusters", "threads"),
    "int8_dense_occupancy": ("registers", "spill_bytes", "shared_bytes", "blocks_per_sm",
                             "threads", "blocks", "stages"),
}

launch_counts: collections.Counter = collections.Counter()
_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        launch_counts.clear()


class KernelLibrary:
    """The loaded shared library plus how it was built."""

    def __init__(self, path: str, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self.lib = ctypes.CDLL(path)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.lib.kernel_error_string.argtypes = [ctypes.c_int]
        self.lib.kernel_error_string.restype = ctypes.c_char_p
        self.lib.scan_bwd_workspace_floats.argtypes = [_I, _I, _I, _I]
        self.lib.scan_bwd_workspace_floats.restype = _LL
        self.lib.scan_fwd_timeline_clocks.argtypes = [_I, _I, _I, _I]
        self.lib.scan_fwd_timeline_clocks.restype = _LL
        for name, argtypes in OCCUPANCY_SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def _check(self, name: str, rc: int) -> None:
        if rc != 0:
            msg = self.lib.kernel_error_string(rc).decode()
            raise RuntimeError(f"CUDA kernel {name} failed: {msg} (code {rc})")

    def launch(self, name: str, *args) -> None:
        """Call one launcher on the current stream and raise on its error."""
        stream = torch.cuda.current_stream().cuda_stream
        self._check(name, getattr(self.lib, name)(*args, stream))
        with _COUNT_LOCK:
            launch_counts[name] += 1

    def occupancy(self, name: str, *args) -> dict:
        """What the build and the card give one kernel instantiation:
        registers and spill bytes per thread, shared bytes and threads per
        block, resident blocks per SM (and, for a clustered kernel,
        resident clusters on the device)."""
        keys = OCCUPANCY_KEYS[name]
        out = (ctypes.c_int * len(keys))()
        self._check(name, getattr(self.lib, name)(*args, out))
        return dict(zip(keys, out))


_LIB: KernelLibrary | None = None
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def library() -> KernelLibrary:
    """The kernel library, built on first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _build_and_load()
    return _LIB


def _build_and_load() -> KernelLibrary:
    sources = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(src, "rb") as f:
            digest.update(os.path.basename(src).encode() + f.read())
    key = digest.hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"libvelocity_kernels_{key}.so")
    log_path = path + ".log"
    if os.path.exists(path):
        log = open(log_path).read() if os.path.exists(log_path) else ""
        return KernelLibrary(path, 0.0, log)
    # Build to private names and rename into place: a concurrent build
    # never sees a half-written library, and no lock file is left behind.
    tmp = f"{path}.{os.getpid()}.tmp"
    objects = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objects)]
    logs = [proc.communicate()[0] for proc in procs]
    try:
        failed = [(src, proc.returncode) for src, proc in zip(sources, procs) if proc.returncode]
        if not failed:
            link = subprocess.run([nvcc, *LINK_FLAGS, "-o", tmp, *objects],
                                  capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            if link.returncode:
                failed = [("link", link.returncode)]
    finally:
        for obj in objects:
            if os.path.exists(obj):
                os.remove(obj)
    seconds = time.perf_counter() - t0
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed}):\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, path)
    return KernelLibrary(path, seconds, log)


def check_tensor(t: torch.Tensor, name: str, shape, dtype=torch.float32) -> None:
    """Raise unless t is a contiguous CUDA tensor of this shape and dtype."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
