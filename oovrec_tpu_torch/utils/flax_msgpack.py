"""A msgpack decoder for flax's serialized trees, in numpy.

The JAX package stores a checkpoint's parameter, variable and optimizer
trees as `flax.serialization.to_bytes` output (`train/trainer.py:851-881`
there): msgpack maps of str keys whose leaves are arrays packed as ext
type 1, the payload itself msgpack of (shape, dtype name, raw C-order
bytes). Ext type 2 is a Python complex (msgpack of (real, imag)) and ext
type 3 a numpy scalar (an array payload read back as its 0-d element). An
array larger than 2^30 bytes is split by flax into a map
``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
of flat pieces, which `msgpack_restore` joins again, as
`flax.serialization.msgpack_restore` does.

A `bfloat16` array (numpy has no such dtype) is returned as float32 with
the same values: bf16 widens to f32 exactly, so `tensor.to(torch.bfloat16)`
gives back its bits.

Neither msgpack nor flax is needed: the card's machine has neither.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    """The bytes are not the msgpack this decoder reads."""


def _array(payload: bytes) -> np.ndarray:
    """An ext-1 payload: msgpack (shape, dtype name, C-order bytes)."""
    shape, name, buf = unpackb(payload)
    if isinstance(name, bytes):
        name = name.decode()
    shape = tuple(int(s) for s in shape)
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _array(data)
    if code == EXT_NPSCALAR:
        return _array(data)[()]
    if code == EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    raise MsgpackError(f"msgpack ext type {code} is not one flax writes")


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise MsgpackError("msgpack data ends inside an object")
        out = self.data[self.pos:end].tobytes()
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: "B", 0xC5: "H", 0xC6: "I"}  # bin 8/16/32
        if b in sized:
            return self.take(self.unpack(sized[b]))
        sized = {0xD9: "B", 0xDA: "H", 0xDB: "I"}  # str 8/16/32
        if b in sized:
            return self.take(self.unpack(sized[b])).decode()
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.unpack({0xC7: "B", 0xC8: "H", 0xC9: "I"}[b])
            code = self.unpack("b")
            return _ext(code, self.take(n))
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            code = self.unpack("b")
            return _ext(code, self.take(1 << (b - 0xD4)))
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if b in (0xDC, 0xDD):
            return [self.obj() for _ in range(self.unpack("H" if b == 0xDC else "I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack("H" if b == 0xDE else "I"))
        raise MsgpackError(f"msgpack byte 0x{b:02x} at {self.pos - 1} is not a type")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(data: bytes) -> Any:
    """One msgpack object from `data` (all of it): maps as dicts, arrays as
    lists, strings as str, bin as bytes, flax's ext types decoded."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise MsgpackError(f"{len(r.data) - r.pos} bytes after the msgpack object")
    return out


def _ordered(d: dict) -> Tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(int(s) for s in _ordered(tree["shape"]))
        return np.concatenate(_ordered(tree["chunks"])).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """`flax.serialization.msgpack_restore` without flax: the state-dict
    tree of `to_bytes` output (a tuple there is a map of "0", "1", ...; a
    NamedTuple a map of its fields), arrays as numpy arrays."""
    return _unchunk(unpackb(data))
