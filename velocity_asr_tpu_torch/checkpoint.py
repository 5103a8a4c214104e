"""Read and write a flax ``params.msgpack`` without flax or msgpack.

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
``params_to_numpy`` maps a model's parameters back onto the flax tree,
and ``write_msgpack`` encodes such a tree byte for byte as
``flax.serialization.to_bytes`` does, so the JAX package's
``from_pretrained`` loads what the port trains.
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

import os
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


def _pack_len(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A msgpack length header: a fix code below fix_max, else the
    narrowest of codes (for 8-, 16- and 32-bit lengths; None where the
    type has no such width)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} is too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"integer {v} does not fit msgpack")
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"integer {v} does not fit msgpack")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None or isinstance(obj, bool):
        out.append({None: 0xC0, False: 0xC2, True: 0xC3}[obj])
    elif isinstance(obj, np.ndarray) or isinstance(obj, np.generic):
        arr = np.asarray(obj)
        if arr.dtype.hasobject:
            raise ValueError("object arrays do not serialise")
        inner = bytearray()
        _pack(inner, (list(arr.shape), arr.dtype.name, arr.tobytes("C")))
        _pack_ext(out, _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR,
                  bytes(inner))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def write_msgpack(obj: Any) -> bytes:
    """Encode maps, arrays, strings, binaries, numbers, booleans, nil and
    numpy arrays and scalars (flax's ext types) as ``flax.serialization``
    does (``msgpack.packb(..., use_bin_type=True)``)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def write_params(path: str, tree: Dict[str, Any]) -> None:
    """Write a flax parameter tree (numpy leaves) as ``params.msgpack``."""
    data = write_msgpack(tree)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


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


def _flax_path(key: str, module: torch.nn.Module) -> Tuple[Tuple[str, ...], str]:
    """(flax leaf path, kind) for one state_dict key of a parameter held
    by `module`: the inverse of ``_torch_key``."""
    parts = key.split(".")
    mods: list = []
    i = 0
    while i < len(parts) - 1:
        if parts[i] == "layers" and parts[i + 1].isdigit():
            mods.append(f"layers_{parts[i + 1]}")
            i += 2
        else:
            mods.append(parts[i])
            i += 1
    leaf = parts[-1]
    if isinstance(module, torch.nn.Conv1d):  # the block's or binding's `conv`
        return tuple(mods[:-1]) + ("conv_kernel" if leaf == "weight" else "conv_bias",), (
            "conv" if leaf == "weight" else "copy")
    if isinstance(module, torch.nn.Linear) and leaf == "weight":
        return tuple(mods) + ("kernel",), "dense"
    if isinstance(module, torch.nn.LayerNorm) and leaf == "weight":
        return tuple(mods) + ("scale",), "copy"
    return tuple(mods) + (leaf,), "copy"


def params_to_numpy(model: torch.nn.Module) -> Dict[str, Any]:
    """A model's parameters as the flax parameter tree (nested dicts of
    fp32 numpy arrays): the inverse of ``params_from_numpy``."""
    tree: Dict[str, Any] = {}
    for key, param in model.named_parameters():
        owner = model.get_submodule(key.rpartition(".")[0]) if "." in key else model
        path, kind = _flax_path(key, owner)
        arr = param.detach().to("cpu", torch.float32).numpy()
        if kind == "dense":
            arr = arr.T  # (out, in) -> (in, out)
        elif kind == "conv":
            arr = arr.transpose(2, 1, 0)  # (out, in/groups, k) -> (k, in/groups, out)
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = np.array(arr, order="C")  # a copy: never a view of the parameter
    return tree


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
