"""Read a flax ``params.msgpack`` without flax or msgpack.

flax serialises a parameter tree with ``flax.serialization.to_bytes``: a
msgpack map of maps whose leaves are msgpack ext type 1, each holding a
nested msgpack array ``(shape, dtype name, raw bytes)``. ``read_msgpack``
decodes the subset of msgpack that such a file uses (maps, arrays,
strings, binaries, integers, floats, booleans, nil and the ndarray /
scalar ext types) into plain dicts of numpy arrays.

``params_from_numpy`` maps that tree onto the port's ``state_dict``:
Dense kernels (in, out) become Linear weights (out, in), conv kernels
(k, in/groups, out) become Conv1d weights (out, in/groups, k), LayerNorm
``scale`` becomes ``weight`` and ``layers_{i}`` becomes ``layers.{i}``.
It is the inverse of ``velocity_asr_tpu/compat/torch_convert.py``.
``quant_stats_from_numpy`` names a flax ``quant_stats`` tree (``x_amax``
and ``calibrated`` per static int8 layer) the same way, for
``quantize.load_quant_stats``.

``stream_state_from_numpy`` and ``stream_state_to_numpy`` carry a
streaming state across: the JAX package's ``init_stream_state`` tree
(numpy leaves) and the port's (``streaming.init_stream_state``) have the
same keys, lists and layouts, the scan state (batch, d_inner, state_dim)
included, so the map is leaf by leaf.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3

_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
# type byte -> (kind, struct format of the length, or the fixed length)
_SIZED = {
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xD4: ("ext", 1), 0xD5: ("ext", 2), 0xD6: ("ext", 4),
    0xD7: ("ext", 8), 0xD8: ("ext", 16),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return self.array(b & 0x0F)
        if b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt) if isinstance(fmt, str) else fmt
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, size: int) -> Any:
        code = self.unpack(">b")
        data = bytes(self.take(size))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype_name, raw = read_msgpack(data)
        arr = np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape).copy()
        return arr if code == _EXT_NDARRAY else arr[()]


def read_msgpack(data: bytes) -> Any:
    """Decode one msgpack object (flax's ndarray ext types included)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} trailing bytes after msgpack object")
    return out


def read_params(path: str) -> Dict[str, Any]:
    """Read a flax ``params.msgpack`` into a nested dict of numpy arrays."""
    with open(path, "rb") as f:
        return read_msgpack(f.read())


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _torch_key(path: Tuple[str, ...]) -> Tuple[str, str]:
    """(state_dict key, kind) for one flax leaf path."""
    mods = [p.replace("layers_", "layers.", 1) if p.startswith("layers_") else p
            for p in path[:-1]]
    leaf = path[-1]
    if leaf == "kernel":
        return ".".join(mods + ["weight"]), "dense"
    if leaf == "scale":
        return ".".join(mods + ["weight"]), "copy"
    if leaf == "conv_kernel":
        return ".".join(mods + ["conv", "weight"]), "conv"
    if leaf == "conv_bias":
        return ".".join(mods + ["conv", "bias"]), "copy"
    return ".".join(mods + [leaf]), "copy"


def params_from_numpy(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a flax parameter tree (numpy leaves) onto the port's state_dict."""
    state = {}
    for path, value in _flatten(tree):
        key, kind = _torch_key(path)
        arr = np.asarray(value)
        if kind == "dense":
            arr = arr.T  # (in, out) -> (out, in)
        elif kind == "conv":
            arr = arr.transpose(2, 1, 0)  # (k, in/groups, out) -> (out, in/groups, k)
        state[key] = torch.tensor(arr)  # a contiguous copy
    return state


def quant_stats_from_numpy(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a flax ``quant_stats`` tree (numpy leaves) onto the port's int8
    buffer names, e.g. ``global_context.pool1.pool_proj.x_amax``."""
    return {_torch_key(path)[0]: torch.tensor(np.asarray(value))
            for path, value in _flatten(tree)}


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return None if tree is None else fn(tree)


def stream_state_from_numpy(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """A JAX streaming state (numpy leaves) as the port's, on `device`."""
    return _map_tree(lambda a: torch.tensor(np.asarray(a), device=device), tree)


def stream_state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's streaming state as numpy leaves, in the JAX tree's layout."""
    return _map_tree(lambda t: t.detach().cpu().numpy(), state)
