"""A MessagePack decoder for flax checkpoints, in the standard library.

witw_tpu writes checkpoints with ``flax.serialization.to_bytes``: MessagePack
maps of strings, ints, floats and arrays, each array an extension of type 1
whose payload is itself MessagePack, ``[shape, dtype name, raw C-order
bytes]`` (type 3 is a numpy scalar in the same form, type 2 a Python
complex), and arrays over 1 GB split into ``__msgpack_chunked_array__``
maps. ``unpackb`` reads that much of the format (the whole format but
timestamps) and returns dicts, lists, str, bytes, numbers and numpy arrays,
without the ``msgpack`` package or flax.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


def _dtype_array(buffer: bytes, name: str, shape) -> np.ndarray:
    if name == "bfloat16":  # no numpy dtype: widen the bits to float32
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data: bytes) -> Any:
    if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
        shape, name, buffer = unpackb(data)
        name = name.decode() if isinstance(name, bytes) else name
        arr = _dtype_array(buffer, name, tuple(shape))
        return arr if code == _EXT_NDARRAY else arr[()]
    if code == _EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    raise ValueError(f"unknown MessagePack extension type {code}")


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated MessagePack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {  # tag: (length format, kind)
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode()
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            code = self.unpack(">b")
            return _ext(code, self.take(n))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            code = self.unpack(">b")
            return _ext(code, self.take(fixext[b]))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        raise ValueError(f"unsupported MessagePack tag 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _as_tuple(d: dict) -> Tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(tree: Any) -> Any:
    """Join flax's chunked array maps back into arrays."""
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = _as_tuple(tree["shape"])
            return np.concatenate(_as_tuple(tree["chunks"])).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes) -> Any:
    """Decode one MessagePack value (the whole of ``data``)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the MessagePack value")
    return out


def restore_flax_state(data: bytes) -> Any:
    """A ``flax.serialization.to_bytes`` checkpoint's state dict, with numpy
    arrays for its array leaves."""
    return _unchunk(unpackb(data))
