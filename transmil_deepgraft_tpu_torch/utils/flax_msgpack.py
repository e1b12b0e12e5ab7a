"""Read the ``variables.msgpack`` of a bundle the JAX package exported.

``flax.serialization.msgpack_serialize`` writes a msgpack document of maps,
arrays, strings, bin, ints, floats, bools and nil, with two extension types:
ndarrays as ExtType 1, whose payload is itself a msgpack triple (shape, dtype
name, raw C-order buffer), and numpy scalars as ExtType 3 (the same triple of
a 0-d array). The ``msgpack`` package may be absent where the port runs, so
this is a reader of that subset, written by hand.

``bfloat16`` arrays (flax writes the dtype name ``bfloat16`` and 2-byte
elements; numpy has no such dtype) come back as ``torch.bfloat16`` tensors;
every other array as a numpy array.

Refused with a ``ValueError`` that names the format: native complex numbers
(ExtType 2), flax's chunked leaves (arrays over 1 GiB), any other extension
type and any byte that is not msgpack.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

_FORMAT = "flax msgpack (variables.msgpack)"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED_KEY = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"truncated {_FORMAT}: wanted {n} bytes at offset {self.pos}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        tag = self.take(1)[0]
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self.mapping(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return [self.value() for _ in range(tag & 0x0F)]
        if 0xA0 <= tag <= 0xBF:
            return self.string(tag & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if tag in simple:
            return simple[tag]
        sized = {  # tag: (struct format of the length, kind)
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
        }
        if tag in sized:
            fmt, kind = sized[tag]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "ext":
                return self.ext(self.unpack(">b"), n)
            if kind == "str":
                return self.string(n)
            if kind == "array":
                return [self.value() for _ in range(n)]
            return self.mapping(n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if tag in numbers:
            return self.unpack(numbers[tag])
        if 0xD4 <= tag <= 0xD8:  # fixext 1, 2, 4, 8, 16
            code = self.unpack(">b")
            return self.ext(code, 1 << (tag - 0xD4))
        raise ValueError(f"byte 0x{tag:02x} at offset {self.pos - 1} is not part of {_FORMAT}")

    def string(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def mapping(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if _CHUNKED_KEY in out:
            raise ValueError(f"chunked array leaves (over 1 GiB) of {_FORMAT} are not supported")
        return out

    def ext(self, code: int, n: int) -> Any:
        payload = bytes(self.take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            arr = _ndarray(payload)
            return arr if code == _EXT_NDARRAY else arr[()]
        if code == _EXT_COMPLEX:
            raise ValueError(f"native complex numbers (ExtType 2) in {_FORMAT} are not supported")
        raise ValueError(f"unknown ExtType {code} in {_FORMAT}")


def _ndarray(payload: bytes) -> np.ndarray | torch.Tensor:
    """flax ``_ndarray_to_bytes``: msgpack (shape, dtype name, C-order
    buffer); a bfloat16 buffer becomes a ``torch.bfloat16`` tensor."""
    inner = _Reader(payload)
    triple = inner.value()
    if not (isinstance(triple, list) and len(triple) == 3):
        raise ValueError(f"an ndarray of {_FORMAT} must be a (shape, dtype, buffer) triple")
    shape, name, buf = triple
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    dtype = np.dtype(name)
    if dtype.hasobject:
        raise ValueError(f"object arrays in {_FORMAT} are not supported")
    return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()


def read_flax_msgpack(data: bytes) -> Any:
    """Decode the bytes of ``flax.serialization.msgpack_serialize`` into
    nested dicts and lists with numpy array leaves (``torch.bfloat16``
    tensors for bfloat16 arrays)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} trailing bytes after {_FORMAT}")
    return out
