"""A msgpack codec for the subset that flax's `serialization` writes, with
neither flax nor the `msgpack` package.

The JAX package stores params and training snapshots with flax's
`msgpack_serialize`: maps with str keys, lists, str, int, float, bool, nil,
bytes, and three extension types, each an inner msgpack array
`(shape, dtype name, C-order bytes)`:

- 1: an ndarray;
- 2: a Python complex, as the inner array `(real, imag)`;
- 3: a numpy scalar, stored as a 0-d array.

An array leaf of a map larger than `MAX_CHUNK_SIZE` bytes is written as a
map `{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
{"0": flat piece, ...}}` and joined again on reading. `packb` writes the
bytes flax's `msgpack_serialize` writes for the same tree (map keys sorted,
the smallest msgpack format of each value, as the msgpack package picks
it); `unpackb` reads any conforming
msgpack in this subset.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

# flax's limit for one array leaf (msgpack caps an object at 2**31 - 1)
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


# ------------------------------------------------------------------ writing
def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack's uint64")
    elif v >= -0x20:
        out += struct.pack(">b", v)
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if v >= low:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack's int64")


def _pack_len(n: int, out: bytearray, fix: int, fix_max: int,
              codes: tuple) -> None:
    """A length header: `fix | n` below `fix_max`, else the 8/16/32-bit
    form of `codes` (None where the format has no 8-bit form)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"msgpack object of length {n} is too long")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(len(data), out, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    out = bytearray()
    _pack((list(arr.shape), arr.dtype.name, arr.tobytes("C")), out)
    return bytes(out)


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif type(obj) is int:
        _pack_int(obj, out)
    elif type(obj) is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif type(obj) is str:
        data = obj.encode("utf-8")
        _pack_len(len(data), out, 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), out, None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(_EXT_NDARRAY, _ndarray_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)), out)
    elif type(obj) is complex:
        inner = bytearray()
        _pack((obj.real, obj.imag), inner)
        _pack_ext(_EXT_COMPLEX, bytes(inner), out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r} object")


def _chunk(arr: np.ndarray) -> dict:
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _too_big(x) -> bool:
    return (isinstance(x, np.ndarray)
            and x.size * x.dtype.itemsize > MAX_CHUNK_SIZE)


def _chunk_leaves(tree):
    """The maps of `tree` with their keys sorted (as flax's tree copy sorts
    them) and oversized array leaves in chunked form (as flax splits them,
    after the sort); lists are not entered."""
    if isinstance(tree, dict):
        return {k: (_chunk(v) if _too_big(v) else
                    _chunk_leaves(v) if isinstance(v, dict) else v)
                for k, v in sorted(tree.items())}
    return _chunk(tree) if _too_big(tree) else tree


def packb(tree) -> bytes:
    """The msgpack bytes of a tree of maps, lists and leaves (numpy arrays
    and scalars, Python scalars, str, bytes, None), laid out as flax's
    `msgpack_serialize` lays them out."""
    out = bytearray()
    _pack(_chunk_leaves(tree), out)
    return bytes(out)


# ------------------------------------------------------------------ reading
class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # str as bytes (flax's inner ndarray encoding)

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        data = self.take(n)
        return data if self.raw else data.decode("utf-8")

    def read(self):
        b = self.unpack(">B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lengths:
            return self.take(self.unpack(lengths[b]))
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            n = self.unpack(ext[b])
            return self.ext(self.unpack(">b"), self.take(n))
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if 0xD4 <= b <= 0xD8:
            code = self.unpack(">b")
            return self.ext(code, self.take(1 << (b - 0xD4)))
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return self.str_(self.unpack(strs[b]))
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.read() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map_(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack byte 0x{b:02x}")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    @staticmethod
    def ext(code: int, data: bytes):
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype, buf = _Reader(data, raw=True).read()
            if isinstance(dtype, bytes):
                dtype = dtype.decode()
            if dtype == "bfloat16":
                raise ValueError("bfloat16 leaves need ml_dtypes, which the "
                                 "port does not use")
            arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
            arr = arr.copy()  # writable, independent of the file's bytes
            return arr[()] if code == _EXT_NPSCALAR else arr
        if code == _EXT_COMPLEX:
            re, im = _Reader(data, raw=False).read()
            return complex(re, im)
        raise ValueError(f"unknown msgpack extension type {code}")


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes):
    """The tree of a flax msgpack file (`msgpack_restore`'s result):
    maps, lists, numpy arrays and scalars, Python scalars, with chunked
    arrays joined."""
    reader = _Reader(bytes(data), raw=False)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)
