"""The msgpack subset of flax's parameter checkpoints, read and written
without the ``msgpack`` or ``flax`` packages.

The JAX package saves a parameter tree with ``flax.serialization.
msgpack_serialize`` and reads it with ``msgpack_restore``
(``osmosis_tpu/models/convert.py:148-159``). This module is their
counterpart for the port:

* types: maps (str keys), arrays (lists), str, bin, int, float, nil, bool;
* ext type 1, an ndarray packed as ``(shape, dtype.name, C-order bytes)``,
  and ext type 3, a numpy scalar packed the same way with shape ``()``;
* flax's chunked form: a dict's array leaf of more than
  :data:`MAX_CHUNK_SIZE` bytes is written as
  ``{"__msgpack_chunked_array__": True, "shape": {"0": ...},
  "chunks": {"0": <flat chunk>, ...}}`` and read back whole;
* dtypes: every numpy bool, int, uint and float width, and bfloat16, which
  numpy lacks: its raw bytes become a ``torch.bfloat16`` tensor, and a
  ``torch.bfloat16`` tensor is written under the name ``bfloat16``.

:func:`packb` writes what ``msgpack_serialize`` writes for the same tree,
byte for byte: flax maps a tree through ``jax.tree_util`` first, which sorts
every dict's keys, so the keys are written sorted (a chunked array's own
dicts keep flax's insertion order); floats are float64; ints take the
smallest encoding. :func:`unpackb` returns numpy arrays (read-only views of
the input where the dtype allows) and ``torch.bfloat16`` tensors.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Dict, Union

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE: bytes of an unchunked array

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"

Array = Union[np.ndarray, torch.Tensor]
Write = Callable[[Any], Any]


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return struct.pack("B", v)
    if -0x20 <= v < 0:
        return struct.pack("b", v)
    if 0x80 <= v <= 0xFF:
        return struct.pack("BB", 0xCC, v)
    if -0x80 <= v < 0:
        return struct.pack(">Bb", 0xD0, v)
    if 0xFF < v <= 0xFFFF:
        return struct.pack(">BH", 0xCD, v)
    if -0x8000 <= v < -0x80:
        return struct.pack(">Bh", 0xD1, v)
    if 0xFFFF < v <= 0xFFFFFFFF:
        return struct.pack(">BI", 0xCE, v)
    if -0x80000000 <= v < -0x8000:
        return struct.pack(">Bi", 0xD2, v)
    if 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        return struct.pack(">BQ", 0xCF, v)
    if -0x8000000000000000 <= v < -0x80000000:
        return struct.pack(">Bq", 0xD3, v)
    raise OverflowError(f"msgpack: integer {v} out of range")


def _header(n: int, fix: int, fix_max: int, codes) -> bytes:
    """A length header: the fix form below ``fix_max``, else 8/16/32 bits
    (``codes`` holds the 8-bit code or None where the type has none)."""
    if n < fix_max:
        return struct.pack("B", fix | n)
    c8, c16, c32 = codes
    if c8 is not None and n <= 0xFF:
        return struct.pack("BB", c8, n)
    if n <= 0xFFFF:
        return struct.pack(">BH", c16, n)
    if n < 2 ** 32:
        return struct.pack(">BI", c32, n)
    raise ValueError(f"msgpack: an object of {n} bytes or items is too large")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _header(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + b


def _bin_header(n: int) -> bytes:
    return _header(n, 0, 0, (0xC4, 0xC5, 0xC6))


def _array_header(n: int) -> bytes:
    return _header(n, 0x90, 16, (None, 0xDC, 0xDD))


def _map_header(n: int) -> bytes:
    return _header(n, 0x80, 16, (None, 0xDE, 0xDF))


def _ext_header(n: int, code: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = struct.pack("B", fixed[n])
    elif n <= 0xFF:
        head = struct.pack("BB", 0xC7, n)
    elif n <= 0xFFFF:
        head = struct.pack(">BH", 0xC8, n)
    else:
        head = struct.pack(">BI", 0xC9, n)
    return head + struct.pack("b", code)


def _array_parts(arr: Array):
    """(shape, dtype name, a C-order buffer of the bytes, its length)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            bits = t.reshape(-1).view(torch.int16).numpy()
            return tuple(t.shape), "bfloat16", bits.view(np.uint8).data, bits.nbytes
        arr = t.numpy()
    if arr.dtype.hasobject or arr.dtype.isalignedstruct or arr.dtype.names:
        raise ValueError("msgpack: object and structured dtypes are not supported")
    a = arr if arr.flags.c_contiguous else arr.copy(order="C")  # keeps a 0-d shape
    return a.shape, a.dtype.name, a.reshape(-1).view(np.uint8).data, a.nbytes


def _write_array(arr: Array, code: int, write: Write) -> None:
    shape, name, data, nbytes = _array_parts(arr)
    head = _array_header(3) + _array_header(len(shape)) + b"".join(_int(int(d)) for d in shape)
    head += _str(name) + _bin_header(nbytes)
    write(_ext_header(len(head) + nbytes, code))
    write(head)
    write(data)


def _nbytes(arr: Array) -> int:
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return arr.size * arr.dtype.itemsize


def _chunked(arr: Array) -> Dict[str, Any]:
    """flax's ``_chunk``: a flat array cut into chunks of MAX_CHUNK_SIZE bytes."""
    item = arr.element_size() if isinstance(arr, torch.Tensor) else arr.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / item))
    flat = arr.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    chunks = [flat[i:i + size] for i in range(0, n, size)]
    return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(obj: Any, write: Write, sort_keys: bool = True) -> None:
    t = type(obj)
    if obj is None:
        write(b"\xc0")
    elif t is bool:
        write(b"\xc3" if obj else b"\xc2")
    elif t is int:
        write(_int(obj))
    elif t is float:
        write(struct.pack(">Bd", 0xCB, obj))
    elif t is str:
        write(_str(obj))
    elif t in (bytes, bytearray):
        write(_bin_header(len(obj)))
        write(obj)
    elif t is list:
        write(_array_header(len(obj)))
        for v in obj:
            _pack(v, write)
    elif t is dict:
        write(_map_header(len(obj)))
        for k in (sorted(obj) if sort_keys else obj):
            v = obj[k]
            _pack(k, write)
            if isinstance(v, (np.ndarray, torch.Tensor)) and _nbytes(v) > MAX_CHUNK_SIZE:
                _pack(_chunked(v), write, sort_keys=False)
            elif type(v) is dict and not sort_keys:
                _pack(v, write, sort_keys=False)
            else:
                _pack(v, write)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _write_array(obj, EXT_NDARRAY, write)
    elif isinstance(obj, np.generic):
        _write_array(np.asarray(obj), EXT_NPSCALAR, write)
    else:
        raise TypeError(f"msgpack: cannot serialize {obj!r} of type {t.__name__}")


def dump(tree: Any, write: Write) -> None:
    """Write ``tree`` through ``write`` (a file's ``write``), in pieces: an
    array's bytes go out as a view, without a copy."""
    _pack(tree, write)


def packb(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``, for trees of dicts,
    lists, Python scalars, str, bytes, numpy arrays and scalars, and CPU or
    CUDA tensors."""
    parts = []
    dump(tree, lambda b: parts.append(bytes(b)))
    return b"".join(parts)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _dtype(name: str):
    if name == "bfloat16":
        return torch.bfloat16
    return np.dtype(name)


def _array_from(data: memoryview) -> Array:
    shape, name, buf = _Reader(data, raw=True).read()
    shape = tuple(shape)
    dt = _dtype(name.decode() if isinstance(name, bytes) else name)
    if dt is torch.bfloat16:
        bits = np.frombuffer(buf, dtype=np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=dt).reshape(shape)


class _Reader:
    """A msgpack decoder over one buffer: ``raw`` leaves str as bytes (the
    inside of an ndarray ext, as flax reads it)."""

    def __init__(self, data, raw: bool = False):
        self.buf = memoryview(data).cast("B")
        self.pos = 0
        self.raw = raw

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _str(self, n: int):
        b = bytes(self._take(n))
        return b if self.raw else b.decode("utf-8")

    def _ext(self, n: int):
        code = self._unpack("b")
        data = self._take(n)
        if code == EXT_NDARRAY:
            return _array_from(data)
        if code == EXT_NPSCALAR:
            a = _array_from(data)
            return a.reshape(()) if isinstance(a, torch.Tensor) else a[()]
        raise ValueError(f"msgpack: ext type {code} is not supported")

    def read(self):
        b = self._unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sizes:
            return bytes(self._take(self._unpack(sizes[b])))
        ext_sizes = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext_sizes:
            return self._ext(self._unpack(ext_sizes[b]))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self._unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return self._str(self._unpack(strs[b]))
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self._unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _unchunk(d: Dict[str, Any]) -> Array:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        if CHUNKED in tree:
            return _unchunk(tree)
        return {k: _unchunk_tree(v) for k, v in tree.items()}
    return tree


def unpackb(data) -> Any:
    """``flax.serialization.msgpack_restore(data)``: the tree, its chunked
    arrays whole again."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} bytes of extra data")
    return _unchunk_tree(tree)
