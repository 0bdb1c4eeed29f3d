"""The JAX package's inference-weight file format, read and written without
flax or the msgpack library.

transfuser_tpu/train/checkpoint.py ``save_inference_weights`` writes
``flax.serialization.to_bytes(jax.device_get(variables))``: a msgpack map
of maps whose keys are strings, sorted (``device_get`` rebuilds the dicts
in key order), and whose leaves are:
  * numpy arrays: ext type 1 around ``msgpack((shape, dtype name,
    C-order bytes))``, the shape an array of ints, the name a str, the
    bytes a bin;
  * numpy scalars: ext type 3 around the same triple with shape ();
  * arrays over 2**30 bytes: a map ``{"__msgpack_chunked_array__": true,
    "shape": {"0": d0, ...}, "chunks": {"0": flat chunk, ...}}``.

This module encodes and decodes exactly that subset (maps, str, bin,
arrays, ints, booleans, ext types 1 and 3) and raises ``ValueError`` on
any other msgpack type or dtype. What it writes equals what flax writes
for the same tree, byte for byte.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"
_DTYPES = ("bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
           "uint32", "uint64", "float16", "float32", "float64")


# ------------------------------------------------------------------ encoding

def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                               (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if v < top:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, bits in ((0xd0, ">b", 7), (0xd1, ">h", 15),
                                (0xd2, ">i", 31), (0xd3, ">q", 63)):
            if v >= -(1 << bits):
                return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} does not fit msgpack")


def _sized(n: int, fix: Tuple[int, int], codes) -> bytes:
    """Header of a str / bin / array / map of length n: the fix form when
    ``fix`` (base, limit) allows it, else the smallest sized form."""
    if fix and n < fix[1]:
        return bytes([fix[0] | n])
    for code, fmt, top in codes:
        if n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n} is too long")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), (0xa0, 32), ((0xd9, ">B", 1 << 8),
                                        (0xda, ">H", 1 << 16),
                                        (0xdb, ">I", 1 << 32))) + b


def _bin_header(n: int) -> bytes:
    return _sized(n, None, ((0xc4, ">B", 1 << 8), (0xc5, ">H", 1 << 16),
                            (0xc6, ">I", 1 << 32)))


def _array_header(n: int) -> bytes:
    return _sized(n, (0x90, 16), ((0xdc, ">H", 1 << 16),
                                  (0xdd, ">I", 1 << 32)))


def _map_header(n: int) -> bytes:
    return _sized(n, (0x80, 16), ((0xde, ">H", 1 << 16),
                                  (0xdf, ">I", 1 << 32)))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _sized(n, None, ((0xc7, ">B", 1 << 8), (0xc8, ">H", 1 << 16),
                                (0xc9, ">I", 1 << 32)))
    return head + struct.pack(">b", code)


def _ndarray(code: int, arr: np.ndarray, out: list) -> None:
    """ext(code, msgpack((shape, dtype name, C-order bytes))), the array's
    memory appended as it is, not copied into a bytes object."""
    if arr.dtype.name not in _DTYPES:
        raise ValueError(f"dtype {arr.dtype} is not in the flax subset")
    data = memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    head = (_array_header(3) + _array_header(arr.ndim) +
            b"".join(_int(int(d)) for d in arr.shape) +
            _str(arr.dtype.name) + _bin_header(data.nbytes))
    out += [_ext_header(code, len(head) + data.nbytes), head, data]


def _chunk(arr: np.ndarray) -> Dict[str, Any]:
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[j:j + size] for i, j in
                       enumerate(range(0, flat.size, size))}}


def _encode(obj: Any, out: list, sort: bool = True) -> None:
    """Keys sorted; a chunked array's maps, made after the sort, keep
    their insertion order."""
    if isinstance(obj, dict):
        out.append(_map_header(len(obj)))
        for k in (sorted(obj) if sort else obj):
            if not isinstance(k, str):
                raise ValueError(f"map key {k!r} is not a str")
            out.append(_str(k))
            _encode(obj[k], out, sort)
    elif isinstance(obj, np.ndarray):
        if obj.nbytes > MAX_CHUNK_SIZE:
            _encode(_chunk(obj), out, sort=False)
        else:
            _ndarray(EXT_NDARRAY, obj, out)
    elif isinstance(obj, np.generic):
        _ndarray(EXT_NPSCALAR, np.asarray(obj), out)
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    else:
        raise ValueError(f"{type(obj).__name__} is not in the flax subset")


def encode(tree: Dict[str, Any]) -> bytes:
    """A tree of str-keyed dicts with numpy leaves -> msgpack bytes."""
    out: list = []
    _encode(tree, out)
    return b"".join(out)


# ------------------------------------------------------------------ decoding

class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        c = self.take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self.map(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return [self.obj() for _ in range(c & 0x0f)]
        if 0xa0 <= c <= 0xbf:
            return self.str(c & 0x1f)
        if c in (0xc2, 0xc3):
            return c == 0xc3
        ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
                0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if c in ints:
            return self.unpack(ints[c])
        sizes = {0: ">B", 1: ">H", 2: ">I"}
        if 0xd9 <= c <= 0xdb:
            return self.str(self.unpack(sizes[c - 0xd9]))
        if 0xc4 <= c <= 0xc6:
            return self.take(self.unpack(sizes[c - 0xc4]))
        if c in (0xdc, 0xdd):
            return [self.obj() for _ in range(self.unpack(sizes[c - 0xdb]))]
        if c in (0xde, 0xdf):
            return self.map(self.unpack(sizes[c - 0xdd]))
        if 0xd4 <= c <= 0xd8:
            return self.ext(1 << (c - 0xd4))
        if 0xc7 <= c <= 0xc9:
            return self.ext(self.unpack(sizes[c - 0xc7]))
        raise ValueError(f"msgpack type byte 0x{c:02x} is not in the flax "
                         "subset")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int) -> Dict[str, Any]:
        out = {}
        for _ in range(n):
            key = self.obj()
            if not isinstance(key, str):
                raise ValueError(f"map key {key!r} is not a str")
            out[key] = self.obj()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not in the flax "
                             "subset")
        inner = _Reader(payload)
        triple = inner.obj()
        if not (isinstance(triple, list) and len(triple) == 3):
            raise ValueError("malformed flax array record")
        shape, name, buf = triple
        if name not in _DTYPES:
            raise ValueError(f"dtype {name!r} is not in the flax subset")
        arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)
        return arr[()] if code == EXT_NPSCALAR else arr


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def decode(data: bytes) -> Dict[str, Any]:
    """msgpack bytes -> the tree of dicts and numpy leaves flax's
    ``msgpack_restore`` gives."""
    reader = _Reader(data)
    tree = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)
