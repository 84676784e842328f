"""Zstandard (RFC 8878) without the ``zstandard`` package: a decoder, and
an encoder of raw blocks.

Orbax checkpoints compress their zarr chunks, and OCDBT its manifests and
B-tree nodes, as zstd frames; the card's machine has no zstd module and
Python 3.12 none of its own. :func:`decompress` takes the native decoder in
``utils/csrc/host_ops.cc`` where the native host ops are in use
(``utils/native``), else :func:`decompress_py`, this module's plain decoder:
the same frames, the same bytes, a few MB a second. :func:`decoder` says
which one runs. Both cover raw, RLE and compressed blocks, Huffman and
treeless literals, FSE, RLE, predefined and repeated sequence tables, the
repeat offsets, skippable frames and the content checksum (XXH64), and both
raise :class:`ZstdError` on a corrupt or truncated frame. Dictionaries are
not supported (orbax writes none).

:func:`compress` writes what the port's orbax writer stores: one frame of
raw (type 0) blocks of at most 128 KiB with its content size, which every
decoder reads; it compresses nothing, so it is a header and the data's
slices joined once.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

MAGIC = 0xFD2FB528
_M64 = (1 << 64) - 1
RAW_BLOCK = 128 * 1024  # the largest block a frame may hold


class ZstdError(ValueError):
    """A frame that is corrupt, truncated, or uses a dictionary."""


# ---------------------------------------------------------------------------
# XXH64, for the content checksum
# ---------------------------------------------------------------------------

_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    n, i = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed, (seed - _P1) & _M64]
        lanes = struct.unpack_from(f"<{(n // 32) * 4}Q", data)
        for j in range(0, len(lanes), 4):
            v = [_round(v[k], lanes[j + k]) for k in range(4)]
        i = (n // 32) * 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M64
        for x in v:
            h = ((h ^ _round(0, x)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h = (_rotl(h ^ _round(0, struct.unpack_from("<Q", data, i)[0]), 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h = (_rotl(h ^ (struct.unpack_from("<I", data, i)[0] * _P1 & _M64), 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h = (_rotl(h ^ (data[i] * _P5 & _M64), 11) * _P1) & _M64
        i += 1
    h = ((h ^ (h >> 33)) * _P2) & _M64
    h = ((h ^ (h >> 29)) * _P3) & _M64
    return h ^ (h >> 32)


# ---------------------------------------------------------------------------
# bit readers
# ---------------------------------------------------------------------------

class _Backward:
    """The reverse bitstream of Huffman and FSE data: read from the end,
    after the last byte's padding marker; bits past the start read as zero,
    and ``overflowed`` says that happened."""

    def __init__(self, data: bytes, start: int, end: int):
        if end <= start or data[end - 1] == 0:
            raise ZstdError("bitstream without its end marker")
        self.data, self.start = data, start
        self.pos = (end - start) * 8 - 9 + data[end - 1].bit_length()  # bits left

    def read(self, n: int) -> int:
        """The next ``n`` (at most 31) bits."""
        if n == 0:
            return 0
        old = self.pos
        self.pos = p = old - n
        if p >= 0:
            b = self.start + (p >> 3)
            return (int.from_bytes(self.data[b:b + 8], "little") >> (p & 7)) & ((1 << n) - 1)
        if old <= 0:
            return 0
        low = int.from_bytes(self.data[self.start:self.start + 8], "little") & ((1 << old) - 1)
        return low << -p

    @property
    def overflowed(self) -> bool:
        return self.pos < 0

    @property
    def done(self) -> bool:
        return self.pos == 0


# ---------------------------------------------------------------------------
# FSE tables
# ---------------------------------------------------------------------------

def _read_ncount(data: bytes, i: int, end: int, max_symbol: int, max_log: int
                 ) -> Tuple[List[int], int, int]:
    """An FSE table description (normalized counts) at ``data[i:end]``;
    returns (counts, accuracy log, bytes read)."""
    if i >= end:
        raise ZstdError("truncated FSE table description")
    value = int.from_bytes(data[i:min(end, i + 512)], "little")
    avail = (min(end, i + 512) - i) * 8
    pos = 0

    def bits(n):
        nonlocal pos
        if pos + n > avail:
            raise ZstdError("truncated FSE table description")
        v = (value >> pos) & ((1 << n) - 1)
        pos += n
        return v

    log = bits(4) + 5
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} over {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts: List[int] = []
    while remaining > 1:
        if len(counts) > max_symbol:
            raise ZstdError("FSE table description has too many symbols")
        peek_mask = threshold - 1
        low = (value >> pos) & peek_mask
        top = 2 * threshold - 1 - remaining
        if low < top:
            count = low
            bits(nbits - 1)
        else:
            count = bits(nbits) & (2 * threshold - 1)
            if count >= threshold:
                count -= top
        count -= 1
        remaining -= abs(count)
        if remaining < 1:
            raise ZstdError("FSE counts over the table size")
        counts.append(count)
        if count == 0:
            while True:
                rep = bits(2)
                counts.extend([0] * rep)
                if rep != 3:
                    break
            if len(counts) > max_symbol + 1:
                raise ZstdError("FSE table description has too many symbols")
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1:
        raise ZstdError("FSE counts do not sum to the table size")
    return counts, log, (pos + 7) // 8


def _build_fse(counts: List[int], log: int):
    """(symbol, nb_bits, base) per state: the decoding table of RFC 8878
    4.1.1."""
    size = 1 << log
    symbol = [0] * size
    high = size - 1
    next_state = [0] * len(counts)
    for s, c in enumerate(counts):
        if c == -1:
            symbol[high] = s
            high -= 1
            next_state[s] = 1
        else:
            next_state[s] = c
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbol[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos != 0:
        raise ZstdError("corrupt FSE table")
    table = []
    for u in range(size):
        s = symbol[u]
        ns = next_state[s]
        next_state[s] += 1
        nb = log - (ns.bit_length() - 1)
        table.append((s, nb, (ns << nb) - size))
    return table, log


def _rle_table(symbol: int):
    return [(symbol, 0, 0)], 0


_LL_DEFAULT = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2,
               1, 1, 1, 1, 1, -1, -1, -1, -1]
_ML_DEFAULT = [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1]
_OF_DEFAULT = [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
               -1, -1, -1]
_PREDEFINED = {}

LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048,
                             4096, 8192, 16384, 32768, 65536]
LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027,
                                2051, 4099, 8195, 16387, 32771, 65539]
ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]


def _predefined(kind: str):
    if kind not in _PREDEFINED:
        counts, log = {"ll": (_LL_DEFAULT, 6), "ml": (_ML_DEFAULT, 6), "of": (_OF_DEFAULT, 5)}[kind]
        _PREDEFINED[kind] = _build_fse(counts, log)
    return _PREDEFINED[kind]


# ---------------------------------------------------------------------------
# Huffman literals
# ---------------------------------------------------------------------------

def _huffman_weights(data: bytes, i: int, end: int) -> Tuple[List[int], int]:
    """The tree description at ``data[i:]``: (weights of symbols 0..n-2,
    bytes read); the last weight is implied."""
    if i >= end:
        raise ZstdError("truncated Huffman tree description")
    head = data[i]
    if head >= 128:  # direct 4-bit weights
        n = head - 127
        size = (n + 1) // 2
        if i + 1 + size > end:
            raise ZstdError("truncated Huffman weights")
        w = []
        for k in range(n):
            byte = data[i + 1 + k // 2]
            w.append(byte >> 4 if k % 2 == 0 else byte & 15)
        return w, 1 + size
    if i + 1 + head > end:
        raise ZstdError("truncated Huffman weights")
    counts, log, used = _read_ncount(data, i + 1, i + 1 + head, 255, 6)
    table, _ = _build_fse(counts, log)
    br = _Backward(data, i + 1 + used, i + 1 + head)
    s1, s2 = br.read(log), br.read(log)
    w: List[int] = []
    while True:
        if len(w) > 255:
            raise ZstdError("too many Huffman weights")
        sym, nb, base = table[s1]
        w.append(sym)
        s1 = base + br.read(nb)
        if br.overflowed:
            w.append(table[s2][0])
            break
        sym, nb, base = table[s2]
        w.append(sym)
        s2 = base + br.read(nb)
        if br.overflowed:
            w.append(table[s1][0])
            break
    return w, 1 + head


def _build_huffman(weights: List[int]):
    """(table of (symbol, nb_bits) indexed by max_bits peeked bits, max_bits)."""
    if any(x > 11 for x in weights):
        raise ZstdError("Huffman weight over 11")
    total = sum(1 << (x - 1) for x in weights if x)
    if total == 0:
        raise ZstdError("empty Huffman tree")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1) or max_bits > 11:
        raise ZstdError("Huffman weights do not complete a tree")
    weights = weights + [rest.bit_length()]
    table = [None] * (1 << max_bits)
    pos = 0
    for w in range(1, max_bits + 1):
        for s, x in enumerate(weights):
            if x == w:
                span = 1 << (w - 1)
                entry = (s, max_bits + 1 - w)
                table[pos:pos + span] = [entry] * span
                pos += span
    return table, max_bits


def _huffman_stream(data: bytes, start: int, end: int, huf, n: int, out: bytearray) -> None:
    table, max_bits = huf
    pos = _Backward(data, start, end).pos
    mask = (1 << max_bits) - 1
    for _ in range(n):
        p = pos - max_bits
        if p >= 0:
            b = start + (p >> 3)
            sym, nb = table[(int.from_bytes(data[b:b + 3], "little") >> (p & 7)) & mask]
        elif pos > 0:
            low = int.from_bytes(data[start:start + 3], "little") & ((1 << pos) - 1)
            sym, nb = table[(low << -p) & mask]
        else:
            raise ZstdError("Huffman stream overrun")
        out.append(sym)
        pos -= nb
    if pos != 0:
        raise ZstdError("Huffman stream not consumed exactly")


# ---------------------------------------------------------------------------
# frames and blocks
# ---------------------------------------------------------------------------

class _State:
    def __init__(self):
        self.huf = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.rep = [1, 4, 8]


def _literals(data: bytes, i: int, end: int, st: _State) -> Tuple[bytes, int]:
    b0 = data[i]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):
        if fmt in (0, 2):
            size, i = b0 >> 3, i + 1
        elif fmt == 1:
            size, i = (b0 >> 4) + (data[i + 1] << 4), i + 2
        else:
            size, i = (b0 >> 4) + (data[i + 1] << 4) + (data[i + 2] << 12), i + 3
        if kind == 0:
            if i + size > end:
                raise ZstdError("truncated raw literals")
            return bytes(data[i:i + size]), i + size
        if i >= end:
            raise ZstdError("truncated RLE literals")
        return bytes([data[i]]) * size, i + 1
    if fmt in (0, 1):
        h = int.from_bytes(data[i:i + 3], "little")
        regen, comp, streams, i = (h >> 4) & 0x3FF, (h >> 14) & 0x3FF, 1 if fmt == 0 else 4, i + 3
    elif fmt == 2:
        h = int.from_bytes(data[i:i + 4], "little")
        regen, comp, streams, i = (h >> 4) & 0x3FFF, h >> 18, 4, i + 4
    else:
        h = int.from_bytes(data[i:i + 5], "little")
        regen, comp, streams, i = (h >> 4) & 0x3FFFF, h >> 22, 4, i + 5
    if i + comp > end:
        raise ZstdError("truncated compressed literals")
    stop = i + comp
    if kind == 2:
        weights, used = _huffman_weights(data, i, stop)
        st.huf = _build_huffman(weights)
        i += used
    elif st.huf is None:
        raise ZstdError("treeless literals without an earlier Huffman table")
    out = bytearray()
    if streams == 1:
        _huffman_stream(data, i, stop, st.huf, regen, out)
    else:
        if i + 6 > stop:
            raise ZstdError("truncated jump table")
        s1, s2, s3 = struct.unpack_from("<3H", data, i)
        i += 6
        bounds = [i, i + s1, i + s1 + s2, i + s1 + s2 + s3, stop]
        if bounds[3] > stop:
            raise ZstdError("corrupt jump table")
        each = (regen + 3) // 4
        for k in range(4):
            _huffman_stream(data, bounds[k], bounds[k + 1], st.huf,
                            each if k < 3 else regen - 3 * each, out)
    if len(out) != regen:
        raise ZstdError("literals of the wrong size")
    return bytes(out), stop


def _table(data: bytes, i: int, end: int, mode: int, kind: str, st: _State):
    max_symbol, max_log = {"ll": (35, 9), "of": (31, 8), "ml": (52, 9)}[kind]
    if mode == 0:
        st.tables[kind] = _predefined(kind)
    elif mode == 1:
        if i >= end:
            raise ZstdError("truncated RLE table")
        if data[i] > max_symbol:
            raise ZstdError("RLE symbol out of range")
        st.tables[kind] = _rle_table(data[i])
        i += 1
    elif mode == 2:
        counts, log, used = _read_ncount(data, i, end, max_symbol, max_log)
        st.tables[kind] = _build_fse(counts, log)
        i += used
    elif st.tables[kind] is None:
        raise ZstdError("repeated table without an earlier one")
    return i


def _block(data: bytes, i: int, end: int, out: bytearray, st: _State, window: int) -> None:
    lits, i = _literals(data, i, end, st)
    if i >= end:
        raise ZstdError("truncated sequences section")
    b0 = data[i]
    if b0 == 0:
        nseq, i = 0, i + 1
    elif b0 < 128:
        nseq, i = b0, i + 1
    elif b0 < 255:
        nseq, i = ((b0 - 128) << 8) + data[i + 1], i + 2
    else:
        nseq, i = data[i + 1] + (data[i + 2] << 8) + 0x7F00, i + 3
    if nseq == 0:
        out += lits
        return
    if i >= end:
        raise ZstdError("truncated sequences section")
    modes = data[i]
    if modes & 3:
        raise ZstdError("reserved bits set in the sequence modes")
    i += 1
    i = _table(data, i, end, modes >> 6, "ll", st)
    i = _table(data, i, end, (modes >> 4) & 3, "of", st)
    i = _table(data, i, end, (modes >> 2) & 3, "ml", st)
    (ll_t, ll_log), (of_t, of_log), (ml_t, ml_log) = (st.tables[k] for k in ("ll", "of", "ml"))
    br = _Backward(data, i, end)
    sll, sof, sml = br.read(ll_log), br.read(of_log), br.read(ml_log)
    rep = st.rep
    lp = 0
    for n in range(nseq):
        ll_code, ll_nb, ll_base = ll_t[sll]
        of_code, of_nb, of_base = of_t[sof]
        ml_code, ml_nb, ml_base = ml_t[sml]
        if of_code > 31 or ll_code > 35 or ml_code > 52:
            raise ZstdError("sequence code out of range")
        of_val = (1 << of_code) + br.read(of_code)
        ml = ML_BASE[ml_code] + br.read(ML_BITS[ml_code])
        ll = LL_BASE[ll_code] + br.read(LL_BITS[ll_code])
        if of_val > 3:
            off = of_val - 3
            rep = [off, rep[0], rep[1]]
        else:
            idx = of_val + (ll == 0)
            if idx == 1:
                off = rep[0]
            elif idx == 2:
                off = rep[1]
                rep = [off, rep[0], rep[2]]
            elif idx == 3:
                off = rep[2]
                rep = [off, rep[0], rep[1]]
            else:
                off = rep[0] - 1
                if off == 0:
                    raise ZstdError("zero offset")
                rep = [off, rep[0], rep[1]]
        if n != nseq - 1:
            sll = ll_base + br.read(ll_nb)
            sml = ml_base + br.read(ml_nb)
            sof = of_base + br.read(of_nb)
        if br.overflowed:
            raise ZstdError("sequence bitstream overrun")
        if lp + ll > len(lits):
            raise ZstdError("literal length past the literals")
        out += lits[lp:lp + ll]
        lp += ll
        if off > len(out) or off > window:
            raise ZstdError("match offset before the start of the window")
        start = len(out) - off
        if off >= ml:
            out += out[start:start + ml]
        else:  # an overlapping copy repeats the last ``off`` bytes
            chunk = out[start:]
            reps, tail = divmod(ml, off)
            out += chunk * reps + chunk[:tail]
    if not br.done:
        raise ZstdError("sequence bitstream not consumed exactly")
    st.rep = rep
    out += lits[lp:]


def frame_content_size(data: bytes) -> Optional[int]:
    """The first frame's declared content size, or None where it has none."""
    if len(data) < 5 or struct.unpack_from("<I", data)[0] != MAGIC:
        raise ZstdError("not a zstd frame")
    return _header(data, 4)[1]


def _header(data: bytes, i: int):
    fhd = data[i]
    i += 1
    single, checksum, dict_flag, fcs_flag = (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3, fhd >> 6
    if fhd & 8:
        raise ZstdError("reserved bit set in the frame header")
    window = None
    if not single:
        wd = data[i]
        i += 1
        exp, mant = (wd >> 3) + 10, wd & 7
        window = (1 << exp) + ((1 << exp) // 8) * mant
    if dict_flag:
        dict_size = (0, 1, 2, 4)[dict_flag]
        if int.from_bytes(data[i:i + dict_size], "little"):
            raise ZstdError("frames with a dictionary are not supported")
        i += dict_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    size = None
    if fcs_size:
        if i + fcs_size > len(data):
            raise ZstdError("truncated frame header")
        size = int.from_bytes(data[i:i + fcs_size], "little") + (256 if fcs_size == 2 else 0)
    i += fcs_size
    if window is None:
        window = size
    return i, size, window, checksum


def decompress_py(data: bytes) -> bytes:
    """Every frame of ``data`` decompressed and concatenated (skippable
    frames skipped)."""
    try:
        return _frames(bytes(data))
    except (IndexError, struct.error) as e:  # a field read past the end of the input
        raise ZstdError(f"truncated frame: {e}") from e


def _frames(data: bytes) -> bytes:
    result = bytearray()
    i = 0
    if not data:
        raise ZstdError("empty input")
    while i < len(data):
        if len(data) - i < 8:
            raise ZstdError("truncated frame")
        magic = struct.unpack_from("<I", data, i)[0]
        if magic & 0xFFFFFFF0 == 0x184D2A50:  # skippable
            i += 8 + struct.unpack_from("<I", data, i + 4)[0]
            if i > len(data):
                raise ZstdError("truncated skippable frame")
            continue
        if magic != MAGIC:
            raise ZstdError("not a zstd frame")
        i, size, window, checksum = _header(data, i + 4)
        out = bytearray()
        st = _State()
        while True:
            if i + 3 > len(data):
                raise ZstdError("truncated block header")
            h = int.from_bytes(data[i:i + 3], "little")
            i += 3
            last, btype, bsize = h & 1, (h >> 1) & 3, h >> 3
            if btype == 0:
                if i + bsize > len(data):
                    raise ZstdError("truncated raw block")
                out += data[i:i + bsize]
                i += bsize
            elif btype == 1:
                if i >= len(data):
                    raise ZstdError("truncated RLE block")
                out += bytes([data[i]]) * bsize
                i += 1
            elif btype == 2:
                if i + bsize > len(data):
                    raise ZstdError("truncated compressed block")
                _block(data, i, i + bsize, out, st, window or (1 << 62))
                i += bsize
            else:
                raise ZstdError("reserved block type")
            if size is not None and len(out) > size:
                raise ZstdError("frame larger than its declared size")
            if last:
                break
        if size is not None and len(out) != size:
            raise ZstdError("frame smaller than its declared size")
        if checksum:
            if i + 4 > len(data):
                raise ZstdError("truncated checksum")
            if struct.unpack_from("<I", data, i)[0] != xxh64(bytes(out)) & 0xFFFFFFFF:
                raise ZstdError("content checksum mismatch")
            i += 4
        result += out
    return bytes(result)


def decoder() -> str:
    """Which decoder :func:`decompress` uses: ``native`` or ``python``, with
    the native host ops' status."""
    from . import native

    return ("native" if native.available() else "python") + f" (host ops: {native.status()})"


def decompress(data: bytes, size: Optional[int] = None) -> bytes:
    """``data``'s frames decompressed, by the native decoder where the native
    host ops are in use, else by :func:`decompress_py`. ``size``, where the
    caller knows it (a zarr chunk's bytes), sizes the native output."""
    from . import native

    out = native.zstd_decompress(data, size)
    return decompress_py(data) if out is None else out


def compress(data) -> bytes:
    """``data`` as one zstd frame: a 128 KiB window, the content size in 4
    bytes (8 from 4 GiB on), raw blocks of at most :data:`RAW_BLOCK` bytes,
    no checksum."""
    view = memoryview(data).cast("B")
    n = len(view)
    wide = n >= 1 << 32
    parts = [struct.pack("<IBB", MAGIC, 0xC0 if wide else 0x80, 0x38),
             struct.pack("<Q" if wide else "<I", n)]
    i = 0
    while True:
        b = min(RAW_BLOCK, n - i)
        parts += [struct.pack("<I", (b << 3) | (i + b == n))[:3], view[i:i + b]]
        i += b
        if i >= n:
            return b"".join(parts)
