"""Read and write the key-value store of an orbax checkpoint, without
tensorstore: OCDBT (TensorStore's optionally-cooperative distributed B+tree)
and the zarr v2 arrays kept in it.

An orbax directory (``use_ocdbt: true, use_zarr3: false`` in its
``_METADATA``) is one OCDBT database: ``manifest.ocdbt`` holds the config
and the newest versions of the version tree, each naming the root of a
B+tree; the nodes and the values too large to sit in a node live in data
files, ``d/<name>`` under the directory or under a per-process database
(``ocdbt.process_0/d/<name>``) that the root's data file tables name. Every
manifest and node is framed (magic, length, version, compression) with a
CRC-32C at its end, and compressed with zstd (``utils/zstd``). A parameter
``a.b.c`` is the zarr v2 array ``a.b.c/.zarray`` (JSON) plus its chunks
``a.b.c/i.j.k``, each a zstd frame of the chunk's C-order bytes.

Only what a reader needs is implemented: the newest version is read, the
older version-tree nodes are not. Every checksum the format has is checked;
a damaged or truncated file raises :class:`OcdbtError`.

:class:`Writer` and :func:`write_array` write the single-version database
that orbax writes for one process, in orbax's config (values up to 1024
bytes inline, zstd): one data file ``d/<hex>`` holding the values too large
to inline, then the B+tree's leaf nodes (cut near :data:`NODE_BYTES`) and
the interior nodes above them, then ``manifest.ocdbt`` naming the root.
Nodes and the manifest are framed with their CRC-32C; everything zstd holds
is raw blocks (``zstd.compress``).
"""

from __future__ import annotations

import json
import math
import os
import struct
import time
import uuid
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MISSING = (1 << 64) - 1  # the offset of an empty tree's root

Value = Union[bytes, Tuple[str, int, int]]  # inline bytes, or (data file, offset, length)


class OcdbtError(ValueError):
    """A database that is damaged, truncated, or of a kind not read here."""


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C of ``data``: the native host ops' where they are in use, else
    :func:`crc32c_py`."""
    from . import native

    crc = native.crc32c(data)
    return crc32c_py(data) if crc is None else crc


def crc32c_py(data: bytes) -> int:
    """CRC-32C (Castagnoli), a byte at a time: the native one's twin."""
    crc = 0xFFFFFFFF
    table = _CRC32C
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Cursor:
    def __init__(self, data: bytes):
        self.data, self.i = data, 0

    def varint(self) -> int:
        r = shift = 0
        while True:
            if self.i >= len(self.data) or shift > 63:
                raise OcdbtError("truncated or overlong varint")
            c = self.data[self.i]
            self.i += 1
            r |= (c & 0x7F) << shift
            shift += 7
            if not c & 0x80:
                return r

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.i + n > len(self.data):
            raise OcdbtError("truncated node")
        out = self.data[self.i:self.i + n]
        self.i += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def end(self, what: str) -> None:
        if self.i != len(self.data):
            raise OcdbtError(f"{what}: {len(self.data) - self.i} bytes left over")


def _unframe(blob: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node: header and checksum checked, zstd
    undone."""
    if len(blob) < 18:
        raise OcdbtError(f"{what}: truncated ({len(blob)} bytes)")
    if struct.unpack_from(">I", blob)[0] != magic:
        raise OcdbtError(f"{what}: bad magic {blob[:4].hex()}")
    if struct.unpack_from("<Q", blob, 4)[0] != len(blob):
        raise OcdbtError(f"{what}: length field {struct.unpack_from('<Q', blob, 4)[0]} "
                         f"for {len(blob)} bytes")
    if crc32c(blob[:-4]) != struct.unpack_from("<I", blob, len(blob) - 4)[0]:
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    cur = _Cursor(blob[:-4])
    cur.i = 12
    version, compression = cur.varint(), cur.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version}")
    body = blob[cur.i:-4]
    if compression == 1:
        try:
            return zstd.decompress(body)
        except zstd.ZstdError as e:
            raise OcdbtError(f"{what}: {e}") from e
    if compression != 0:
        raise OcdbtError(f"{what}: compression format {compression}")
    return body


def _keys(cur: _Cursor, prefix_lengths, suffix) -> list:
    """Prefix-compressed keys: each shares ``prefix_lengths[k]`` bytes with
    the previous one and adds ``suffix[k]`` bytes."""
    out, prev = [], b""
    for k in range(len(suffix)):
        if prefix_lengths[k] > len(prev):
            raise OcdbtError("key prefix longer than the previous key")
        prev = prev[:prefix_lengths[k]] + cur.take(suffix[k])
        out.append(prev)
    return out


def _data_file_table(cur: _Cursor) -> list:
    n = cur.varint()
    prefix = [0] + cur.varints(max(n - 1, 0))
    suffix = cur.varints(n)
    base = cur.varints(n)
    paths, prev = [], b""
    for k in range(n):
        if prefix[k] > len(prev):
            raise OcdbtError("data file path prefix too long")
        prev = prev[:prefix[k]] + cur.take(suffix[k])
        if base[k] > len(prev):
            raise OcdbtError("data file base path too long")
        paths.append(prev.decode())
    return paths


class Database:
    """The newest version of the OCDBT database at ``root``: ``keys()`` and
    ``read(key)``."""

    def __init__(self, root: str):
        self.root = os.path.realpath(root)
        with open(os.path.join(self.root, "manifest.ocdbt"), "rb") as f:
            body = _unframe(f.read(), MANIFEST_MAGIC, "manifest.ocdbt")
        cur = _Cursor(body)
        cur.take(16)  # the database's uuid
        kind = cur.varint()
        if kind != 0:
            raise OcdbtError(f"manifest kind {kind}: only single-file manifests are read")
        cur.varint()  # max_inline_value_bytes
        self.max_decoded_node_bytes = cur.varint()
        cur.byte()  # version tree arity, log2
        compression = cur.varint()
        if compression == 1:
            cur.take(4)  # zstd level
        elif compression != 0:
            raise OcdbtError(f"compression method {compression}")
        files = _data_file_table(cur)
        n = cur.varint()
        gens, heights = cur.varints(n), [cur.byte() for _ in range(n)]
        fids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
        cur.varints(3 * n)  # statistics: keys, tree bytes, indirect value bytes
        cur.take(8 * n)  # commit times
        m = cur.varint()  # references to older version-tree nodes: not read
        cur.varints(5 * m)
        cur.take(8 * m)
        cur.take(m)
        cur.end("manifest.ocdbt")
        if not n:
            raise OcdbtError("manifest.ocdbt holds no version")
        k = max(range(n), key=gens.__getitem__)  # the newest version
        self.entries: Dict[bytes, Value] = {}
        if offsets[k] != MISSING:
            self._node(self._path(files, fids[k]), offsets[k], lengths[k], heights[k], b"")

    def _path(self, files: list, fid: int) -> str:
        if fid >= len(files):
            raise OcdbtError(f"data file id {fid} of {len(files)}")
        path = os.path.realpath(os.path.join(self.root, files[fid]))
        if not path.startswith(self.root + os.sep):
            raise OcdbtError(f"data file {files[fid]!r} outside the database")
        return path

    def _blob(self, path: str, offset: int, length: int) -> bytes:
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                blob = f.read(length)
        except OSError as e:
            raise OcdbtError(f"cannot read {os.path.relpath(path, self.root)}: {e}") from e
        if len(blob) != length:
            raise OcdbtError(f"{os.path.relpath(path, self.root)} is truncated: {len(blob)} of "
                             f"{length} bytes at {offset}")
        return blob

    def _node(self, path: str, offset: int, length: int, height: int, prefix: bytes) -> None:
        what = f"B-tree node {os.path.relpath(path, self.root)}@{offset}"
        body = _unframe(self._blob(path, offset, length), NODE_MAGIC, what)
        if len(body) > self.max_decoded_node_bytes:
            raise OcdbtError(f"{what}: {len(body)} bytes decoded, over the config's maximum")
        cur = _Cursor(body)
        if cur.byte() != height:
            raise OcdbtError(f"{what}: height differs from its reference's")
        files = _data_file_table(cur)
        n = cur.varint()
        pre = [0] + cur.varints(max(n - 1, 0))
        suffix = cur.varints(n)
        if height:
            common = cur.varints(n)  # each child's keys omit this much of its first key
            keys = _keys(cur, pre, suffix)
            fids, offs, lens = cur.varints(n), cur.varints(n), cur.varints(n)
            cur.varints(3 * n)  # statistics
            cur.end(what)
            for k in range(n):
                self._node(self._path(files, fids[k]), offs[k], lens[k], height - 1,
                           prefix + keys[k][:common[k]])
            return
        keys = _keys(cur, pre, suffix)
        lengths = cur.varints(n)
        kinds = cur.varints(n)
        if any(x not in (0, 1) for x in kinds):
            raise OcdbtError(f"{what}: unknown value kind")
        n_ind = sum(kinds)
        fids, offs = cur.varints(n_ind), cur.varints(n_ind)
        j = 0
        for k in range(n):
            if kinds[k]:
                self.entries[prefix + keys[k]] = (self._path(files, fids[j]), offs[j], lengths[k])
                j += 1
            else:
                self.entries[prefix + keys[k]] = cur.take(lengths[k])
        cur.end(what)

    def keys(self):
        return self.entries.keys()

    def read(self, key: Union[str, bytes]) -> Optional[bytes]:
        """The value of ``key``, or None where the database has no such key."""
        v = self.entries.get(key.encode() if isinstance(key, str) else key)
        if v is None or isinstance(v, bytes):
            return v
        return self._blob(*v)


# ---------------------------------------------------------------------------
# zarr v2
# ---------------------------------------------------------------------------

def read_array(db: Database, name: str):
    """The zarr v2 array ``name`` of ``db`` as a numpy array; a ``bfloat16``
    array comes back as its raw ``uint16`` bits, with ``True`` as the
    second value (``(array, is_bfloat16)``)."""
    raw = db.read(f"{name}/.zarray")
    if raw is None:
        raise OcdbtError(f"no array {name!r} in the database")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2 or meta.get("order", "C") != "C" or meta.get("filters"):
        raise OcdbtError(f"{name}: not a C-order zarr v2 array without filters: {meta}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OcdbtError(f"{name}: compressor {comp} (zstd or none is read)")
    bf16 = meta["dtype"] == "bfloat16"
    dtype = np.dtype("<u2" if bf16 else meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise OcdbtError(f"{name}: chunks {chunks} for shape {shape}")
    fill = 0 if meta.get("fill_value") is None else meta["fill_value"]
    if bf16:  # the fill's bf16 bits, rounded to nearest even
        u = int(np.float32(fill).view(np.uint32))
        fill = u >> 16 if np.isnan(np.float32(fill)) else (u + 0x7FFF + ((u >> 16) & 1)) >> 16
    out = np.full(shape, fill, dtype=dtype)
    sep = meta.get("dimension_separator", ".")
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if shape else '0'}"
        data = db.read(key)
        if data is None:  # an absent chunk holds the fill value
            continue
        if comp is not None:
            try:
                data = zstd.decompress(data, chunk_bytes)
            except zstd.ZstdError as e:
                raise OcdbtError(f"{key}: {e}") from e
        if len(data) != chunk_bytes:
            raise OcdbtError(f"{key}: {len(data)} bytes for a chunk of {chunk_bytes}")
        chunk = np.frombuffer(data, dtype=dtype).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    return out, bf16


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

MAX_INLINE_VALUE_BYTES = 1024  # orbax's OCDBT config
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
NODE_BYTES = 1 << 16  # a node is cut once its entries pass this many bytes
# a zarr chunk holds at most this many bytes: each leaf of the 552.8M tree
# (75.5 MB at most) is one chunk, as orbax writes it; a chunk cut from an
# axis that its length does not divide is padded to its full shape
CHUNK_BYTES = 1 << 30
ZSTD = 1  # the compression method's id


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _varints(vs) -> bytes:
    return b"".join(_varint(v) for v in vs)


def _frame(magic: int, body: bytes) -> bytes:
    """:func:`_unframe`'s inverse: magic, length, format version 0, zstd,
    the body, CRC-32C."""
    payload = _varint(0) + _varint(ZSTD) + zstd.compress(body)
    blob = struct.pack(">I", magic) + struct.pack("<Q", 12 + len(payload) + 4) + payload
    return blob + struct.pack("<I", crc32c(blob))


def _prefixed(keys: List[bytes]) -> Tuple[bytes, bytes]:
    """Keys as :func:`_keys` reads them: (each one's prefix length shared
    with the one before, from the second on, then the suffix lengths; the
    suffixes)."""
    pre = [len(os.path.commonprefix([a, b])) for a, b in zip(keys, keys[1:])]
    suffixes = [keys[0]] + [k[p:] for k, p in zip(keys[1:], pre)]
    return _varints(pre) + _varints(len(x) for x in suffixes), b"".join(suffixes)


class Writer:
    """A new single-version OCDBT database at ``root`` (a directory without
    one). ``put(key, value)`` in any order; ``commit()`` writes the B+tree
    and the manifest, without which nothing written is a database. As a
    context manager it commits on a clean exit and closes the data file
    either way."""

    def __init__(self, root: str):
        self.root = root
        self.data_file = f"d/{uuid.uuid4().hex}"
        os.makedirs(os.path.join(root, "d"), exist_ok=True)
        self._f = open(os.path.join(root, self.data_file), "xb")
        self._offset = 0
        self._entries: Dict[bytes, Union[bytes, Tuple[int, int]]] = {}

    def __enter__(self) -> "Writer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.commit()
        self._f.close()

    def _append(self, blob) -> int:
        offset = self._offset
        self._f.write(blob)
        self._offset += len(blob)
        return offset

    def put(self, key: Union[str, bytes], value) -> None:
        """Store ``value`` (bytes-like) under ``key``: inline in its leaf up
        to :data:`MAX_INLINE_VALUE_BYTES`, else in the data file now."""
        key = key.encode() if isinstance(key, str) else bytes(key)
        if key in self._entries:
            raise ValueError(f"key {key!r} written twice")
        n = memoryview(value).nbytes
        self._entries[key] = (bytes(value) if n <= MAX_INLINE_VALUE_BYTES
                              else (self._append(value), n))

    def _table(self) -> bytes:
        """The data file table of every node and of the manifest: this
        database's one data file, base path empty."""
        name = self.data_file.encode()
        return _varint(1) + _varint(len(name)) + _varint(0) + name

    def _node(self, height: int, body: bytes) -> Tuple[int, int]:
        blob = _frame(NODE_MAGIC, bytes([height]) + self._table() + body)
        return self._append(blob), len(blob)

    def _leaf(self, keys: List[bytes]):
        """A leaf node: its reference (first key, offset, length) and its
        statistics (keys, tree bytes, indirect value bytes)."""
        values = [self._entries[k] for k in keys]
        inline = [v for v in values if isinstance(v, bytes)]
        indirect = [v for v in values if not isinstance(v, bytes)]
        body = (_varint(len(keys)) + b"".join(_prefixed(keys))
                + _varints(len(v) if isinstance(v, bytes) else v[1] for v in values)
                + _varints(0 if isinstance(v, bytes) else 1 for v in values)
                + _varints(0 for _ in indirect) + _varints(v[0] for v in indirect)
                + b"".join(inline))
        offset, length = self._node(0, body)
        return (keys[0], offset, length), (len(keys), length, sum(v[1] for v in indirect))

    def _interior(self, height: int, children):
        """An interior node over ``children`` ([(reference, statistics)]),
        each child's keys stored whole (no common prefix taken out)."""
        refs, stats = [c[0] for c in children], [c[1] for c in children]
        lengths, suffixes = _prefixed([r[0] for r in refs])
        body = (_varint(len(refs)) + lengths + _varints(0 for _ in refs) + suffixes
                + _varints(0 for _ in refs) + _varints(r[1] for r in refs)
                + _varints(r[2] for r in refs)
                + b"".join(_varints(s[j] for s in stats) for j in range(3)))
        offset, length = self._node(height, body)
        return (refs[0][0], offset, length), (sum(s[0] for s in stats),
                                              length + sum(s[1] for s in stats),
                                              sum(s[2] for s in stats))

    def commit(self) -> None:
        """Write the B+tree over every key put, then ``manifest.ocdbt``."""
        if not self._entries:
            raise ValueError("an empty database is not written")
        keys = sorted(self._entries)
        inline = {k: len(v) for k, v in self._entries.items() if isinstance(v, bytes)}
        nodes = [self._leaf(group) for group in _cut(keys, lambda k: len(k) + 8 + inline.get(k, 0))]
        height = 0
        while len(nodes) > 1:
            height += 1
            nodes = [self._interior(height, group) for group in _cut(
                nodes, lambda node: len(node[0][0]) + 40)]
        (_, offset, length), stats = nodes[0]
        self._f.flush()
        os.fsync(self._f.fileno())
        body = (uuid.uuid4().bytes + _varint(0) + _varint(MAX_INLINE_VALUE_BYTES)
                + _varint(MAX_DECODED_NODE_BYTES) + bytes([VERSION_TREE_ARITY_LOG2])
                + _varint(ZSTD) + struct.pack("<i", 0) + self._table()
                + _varint(1) + _varint(1) + bytes([height])  # one version, generation 1
                + _varint(0) + _varint(offset) + _varint(length) + _varints(stats)
                + struct.pack("<Q", time.time_ns()) + _varint(0))  # no version-tree nodes
        path = os.path.join(self.root, "manifest.ocdbt")
        with open(path + ".tmp", "wb") as f:
            f.write(_frame(MANIFEST_MAGIC, body))
            f.flush()
            os.fsync(f.fileno())
        os.replace(path + ".tmp", path)


def _cut(items: list, size) -> List[list]:
    """``items`` in runs whose ``size`` sums reach :data:`NODE_BYTES` (the
    last run may be shorter; every run holds one item at least)."""
    runs, run, total = [], [], 0
    for item in items:
        run.append(item)
        total += size(item)
        if total >= NODE_BYTES:
            runs.append(run)
            run, total = [], 0
    return runs + ([run] if run else [])


def _chunk_shape(shape: Tuple[int, ...], itemsize: int, max_bytes: int) -> Tuple[int, ...]:
    """The whole array where it fits in ``max_bytes``, else its leading axes
    cut (the first to a part of its length, those before it to 1) until a
    chunk does, or holds one element of them."""
    chunks = [max(1, d) for d in shape]  # an empty axis: a chunk of 1, none written
    for ax in range(len(shape)):
        if math.prod(chunks) * itemsize <= max_bytes:
            break
        chunks[ax] = max(1, min(shape[ax], max_bytes // (itemsize * math.prod(chunks[ax + 1:]))))
    return tuple(chunks)


def write_array(writer: Writer, name: str, arr: np.ndarray, dtype: str) -> None:
    """``arr`` as the zarr v2 array ``name`` of ``writer``'s database, as
    orbax writes one: ``.zarray`` (C order, zstd, no fill value), then every
    chunk of at most :data:`CHUNK_BYTES`, an edge chunk padded with zeros. ``dtype`` is the zarr dtype
    (``arr.dtype.str``, or ``"bfloat16"`` with ``arr`` its uint16 bits)."""
    arr = np.asarray(arr)
    arr = arr if arr.flags.c_contiguous else arr.copy(order="C")  # a 0-d array stays 0-d
    shape = tuple(int(d) for d in arr.shape)
    chunks = _chunk_shape(shape, arr.dtype.itemsize, CHUNK_BYTES)
    meta = dict(chunks=list(chunks), compressor=dict(id="zstd", level=1),
                dimension_separator=".", dtype=dtype, fill_value=None, filters=None,
                order="C", shape=list(shape), zarr_format=2)
    writer.put(f"{name}/.zarray", json.dumps(meta, sort_keys=True,
                                             separators=(",", ":")).encode())
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        part = arr[region]
        if part.shape != chunks:
            padded = np.zeros(chunks, dtype=arr.dtype)
            padded[tuple(slice(0, d) for d in part.shape)] = part
            part = padded
        part = part if part.flags.c_contiguous else part.copy(order="C")
        writer.put(f"{name}/{'.'.join(map(str, idx)) if shape else '0'}", zstd.compress(part))
