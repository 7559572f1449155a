"""A msgpack codec for the subset of msgpack that flax.serialization writes.

The JAX package checkpoints with ``flax.serialization.msgpack_serialize``;
the machine that runs the port has neither flax nor the ``msgpack``
package, so the port reads and writes the same bytes with this module
(numpy only). Covered (msgpack spec, https://github.com/msgpack/msgpack/
blob/master/spec.md):

* nil, bool, positive / negative fixint and every int width up to uint64
  and int64, written in the smallest form as msgpack-python packs them;
* float32 (read only) and float64;
* fixstr / str8 / str16 / str32 (UTF-8), bin8 / bin16 / bin32;
* fixarray / array16 / array32 (read as lists), fixmap / map16 / map32
  (read as dicts in file order);
* fixext 1-16 and ext8 / ext16 / ext32.

flax's two ext types carry arrays: an ``np.ndarray`` is ext type 1 and a
numpy scalar (``np.generic``) ext type 3, both with the payload
``packb((shape, dtype.name, arr.tobytes("C")))``; they decode to a numpy
array and a numpy scalar. Any other ext type decodes to an ``Ext``. A
tuple packs as an array, as inside flax's payloads (flax never writes one
at the top level, where it packs with ``strict_types``).

Not covered, and raising ``ValueError``: flax's chunked layout of arrays
above ``MAX_CHUNK_SIZE`` bytes (no array of this model comes near it),
and bfloat16 leaves (checkpoints are float32; ``compute_dtype`` is a
runtime switch).
"""

from __future__ import annotations

import struct
from typing import Any, NamedTuple

import numpy as np

__all__ = ["packb", "unpackb", "Ext", "EXT_NDARRAY", "EXT_NPSCALAR",
           "MAX_CHUNK_SIZE"]

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30        # flax.serialization's chunking threshold
_CHUNKED = "__msgpack_chunked_array__"


class Ext(NamedTuple):
    """An ext value of a type this codec does not interpret."""
    code: int
    data: bytes


# ---- encoding ----------------------------------------------------------------

def _pack_int(v: int, out: list) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -0x20 <= v < 0:
        out.append(struct.pack("b", v))
    elif 0 < v <= 0xFF:
        out.append(struct.pack(">BB", 0xCC, v))
    elif -0x80 <= v < 0:
        out.append(struct.pack(">Bb", 0xD0, v))
    elif 0 < v <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, v))
    elif -0x8000 <= v < 0:
        out.append(struct.pack(">Bh", 0xD1, v))
    elif 0 < v <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, v))
    elif -0x80000000 <= v < 0:
        out.append(struct.pack(">Bi", 0xD2, v))
    elif 0 < v <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, v))
    elif -0x8000000000000000 <= v < 0:
        out.append(struct.pack(">Bq", 0xD3, v))
    else:
        raise OverflowError(f"integer {v} does not fit msgpack's 64 bits")


def _pack_len(n: int, fix: int, fix_max: int, codes: tuple, out: list) -> None:
    """A length header: the fix form below ``fix_max``, else the 8- (when
    ``codes`` has three), 16- or 32-bit form."""
    if n < fix_max:
        out.append(struct.pack("B", fix | n))
        return
    for code, fmt, top in zip(codes, (">BB", ">BH", ">BI")[-len(codes):],
                              (0xFF, 0xFFFF, 0xFFFFFFFF)[-len(codes):]):
        if n <= top:
            out.append(struct.pack(fmt, code, n))
            return
    raise ValueError(f"length {n} exceeds msgpack's 32 bits")


def _pack_bin(b: bytes, out: list) -> None:
    _pack_len(len(b), 0, 0, (0xC4, 0xC5, 0xC6), out)
    out.append(b)


def _pack_ext(code: int, data: bytes, out: list) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(struct.pack("B", fixed[n]))
    elif n <= 0xFF:
        out.append(struct.pack(">BB", 0xC7, n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", 0xC8, n))
    else:
        out.append(struct.pack(">BI", 0xC9, n))
    out.append(struct.pack("b", code))
    out.append(data)


def _array_payload(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: (shape, dtype name, C-order bytes)."""
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("object and structured dtypes cannot be packed")
    if arr.dtype.name == "bfloat16":
        raise ValueError("bfloat16 leaves are not written: checkpoints are "
                         "float32 (compute_dtype is a runtime switch)")
    if arr.nbytes > MAX_CHUNK_SIZE:
        raise ValueError(f"an array of {arr.nbytes} bytes needs flax's "
                         "chunked layout, which this codec does not write")
    return packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(obj: Any, out: list) -> None:
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        _pack_int(obj, out)
    elif t is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif t is str:
        b = obj.encode("utf-8")
        _pack_len(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out.append(b)
    elif t in (bytes, bytearray, memoryview):
        _pack_bin(bytes(obj), out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, _array_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_payload(np.asarray(obj)), out)
    elif t is Ext:
        _pack_ext(obj.code, obj.data, out)
    elif t in (list, tuple):
        _pack_len(len(obj), 0x90, 16, (0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif t is dict:
        _pack_len(len(obj), 0x80, 16, (0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {t.__name__}")


def packb(obj: Any) -> bytes:
    """msgpack bytes of ``obj``, dict entries in their insertion order."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# ---- decoding ----------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _array_from_payload(payload: bytes) -> np.ndarray:
    shape, name, buf = unpackb(payload)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        raise ValueError("a bfloat16 leaf: the port reads float32 "
                         "checkpoints only (compute_dtype is a runtime "
                         "switch)")
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _array_from_payload(data)
    if code == EXT_NPSCALAR:
        return _array_from_payload(data)[()]
    return Ext(code, data)


_SIZED = {  # code -> (kind, length format)
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _read(r: _Reader):
    c = r.unpack("B")
    if c <= 0x7F:
        return c
    if c >= 0xE0:
        return c - 0x100
    if 0x80 <= c <= 0x8F:
        return _read_map(r, c & 0x0F)
    if 0x90 <= c <= 0x9F:
        return [_read(r) for _ in range(c & 0x0F)]
    if 0xA0 <= c <= 0xBF:
        return r.take(c & 0x1F).decode("utf-8")
    if c == 0xC0:
        return None
    if c in (0xC2, 0xC3):
        return c == 0xC3
    if c in _NUMBERS:
        v = r.unpack(_NUMBERS[c])
        return float(v) if c in (0xCA, 0xCB) else int(v)
    if c in _FIXEXT:
        code = r.unpack("b")
        return _ext(code, r.take(_FIXEXT[c]))
    if c in _SIZED:
        kind, fmt = _SIZED[c]
        n = r.unpack(fmt)
        if kind == "bin":
            return r.take(n)
        if kind == "str":
            return r.take(n).decode("utf-8")
        if kind == "array":
            return [_read(r) for _ in range(n)]
        if kind == "map":
            return _read_map(r, n)
        code = r.unpack("b")
        return _ext(code, r.take(n))
    raise ValueError(f"msgpack type byte {c:#04x} is not covered")


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r)
        out[k] = _read(r)
    if _CHUNKED in out:
        raise ValueError("flax's chunked array layout (arrays above "
                         f"{MAX_CHUNK_SIZE} bytes) is not covered")
    return out


def unpackb(data: bytes) -> Any:
    """The object of one msgpack value that fills ``data``."""
    r = _Reader(data)
    obj = _read(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after the "
                         "msgpack value")
    return obj
