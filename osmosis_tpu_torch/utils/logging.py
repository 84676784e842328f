"""Structured run logger (port of ``osmosis_tpu/utils/logging.py``).

Text lines go to stdout and ``<dir>/log.txt``; key-value rows accumulate
into ``<dir>/progress.csv`` and ``progress.json``, with an optional
TensorBoard event sink (``tb/``). ``format_strs`` picks the sinks among
stdout, log, json, csv and tensorboard. In a multi-process run each rank
but the first writes its own files, named with ``rank_suffix``
(``log-rank001.txt``, ``progress-rank001.csv``, ...). When a later row
brings new keys the CSV is rewritten with the wider header and old rows
padded, so rows never misalign.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Any, Dict, Optional, Sequence


def _tb_varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            out += bytes([b])
            return out


def _tb_field(num: int, wire: int, payload: bytes) -> bytes:
    return _tb_varint((num << 3) | wire) + payload


def _tb_masked_crc(data: bytes) -> int:
    # the TFRecord mask over zlib's crc32 (the standard library has no
    # crc32c): the framing is the reader's, the check value is not
    crc = zlib.crc32(data) & 0xFFFFFFFF
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


class TensorBoardWriter:
    """A tfevents writer of scalar summaries with no dependency: each row is
    an Event{wall_time, step, summary=Summary{value=[{tag, simple_value}]}}
    protobuf encoded by hand and framed as a TFRecord."""

    def __init__(self, dir: str):
        os.makedirs(dir, exist_ok=True)
        path = os.path.join(dir, f"events.out.tfevents.{int(time.time())}.osmosis")
        self._f = open(path, "ab")
        self.step = 1

    def _write_event(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _tb_masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _tb_masked_crc(payload)))
        self._f.flush()

    def writekvs(self, kvs: Dict[str, Any]):
        values = b""
        for k, v in sorted(kvs.items()):
            try:
                fv = float(v)
            except (TypeError, ValueError):
                continue  # a scalar sink: non-numeric values are skipped
            tag = k.encode()
            value_msg = _tb_field(1, 2, _tb_varint(len(tag)) + tag)  # tag
            value_msg += _tb_field(2, 5, struct.pack("<f", fv))  # simple_value
            values += _tb_field(1, 2, _tb_varint(len(value_msg)) + value_msg)
        if not values:
            return
        ev = _tb_field(1, 1, struct.pack("<d", time.time()))  # wall_time
        ev += _tb_field(2, 0, _tb_varint(self.step))  # step
        ev += _tb_field(5, 2, _tb_varint(len(values)) + values)  # summary
        self._write_event(ev)
        self.step += 1

    def close(self):
        self._f.close()


class RunLogger:
    def __init__(self, dir: Optional[str] = None,
                 format_strs: Optional[Sequence[str]] = None,
                 rank_suffix: str = ""):
        self.dir = dir
        self._file = None
        self._kv: Dict[str, Any] = {}
        self._csv_keys: Optional[list] = None
        self._tb: Optional[TensorBoardWriter] = None
        self._suffix = rank_suffix
        self._formats = tuple(("stdout", "log", "json", "csv") if format_strs is None
                              else format_strs)
        if dir is not None:
            os.makedirs(dir, exist_ok=True)
            if "log" in self._formats:
                self._file = open(os.path.join(dir, f"log{rank_suffix}.txt"), "a")
            if "tensorboard" in self._formats:
                self._tb = TensorBoardWriter(os.path.join(dir, f"tb{rank_suffix}"))

    def log(self, *args):
        msg = " ".join(str(a) for a in args)
        if "stdout" in self._formats:
            print(msg)
        if self._file:
            self._file.write(msg + "\n")
            self._file.flush()

    def logkv(self, key: str, value: Any):
        self._kv[key] = value

    def _write_csv(self, row: Dict[str, Any]):
        csv_path = os.path.join(self.dir, f"progress{self._suffix}.csv")
        new_keys = [k for k in row if self._csv_keys is None or k not in self._csv_keys]
        if self._csv_keys is None:
            self._csv_keys = list(row)
            with open(csv_path, "a") as f:
                f.write(",".join(self._csv_keys) + "\n")
        elif new_keys:
            self._csv_keys = self._csv_keys + new_keys
            lines = []
            if os.path.exists(csv_path):
                with open(csv_path) as f:
                    lines = f.read().splitlines()[1:]
            with open(csv_path, "w") as f:
                f.write(",".join(self._csv_keys) + "\n")
                pad = "," * len(new_keys)
                for ln in lines:
                    f.write(ln + pad + "\n")
        with open(csv_path, "a") as f:
            f.write(",".join(str(row.get(k, "")) for k in self._csv_keys) + "\n")

    def dumpkvs(self):
        if not self._kv or self.dir is None:
            self._kv = {}
            return
        row = dict(self._kv, _time=time.time())
        if "json" in self._formats:
            with open(os.path.join(self.dir, f"progress{self._suffix}.json"), "a") as f:
                f.write(json.dumps(row, default=str) + "\n")
        if "csv" in self._formats:
            self._write_csv(row)
        if self._tb is not None:
            self._tb.writekvs(self._kv)
        self._kv = {}

    def close(self):
        if self._file:
            self._file.close()
            self._file = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None


_CURRENT: Optional[RunLogger] = None


def configure(dir: Optional[str] = None, format_strs: Optional[Sequence[str]] = None,
              rank_suffix: str = "") -> RunLogger:
    """A new logger, which :func:`get_current` and :func:`log` then use."""
    global _CURRENT
    _CURRENT = RunLogger(dir, format_strs=format_strs, rank_suffix=rank_suffix)
    return _CURRENT


def get_current() -> RunLogger:
    """The logger :func:`configure` made last, or one to stdout only."""
    global _CURRENT
    if _CURRENT is None:
        _CURRENT = RunLogger(None)
    return _CURRENT


def log(*args):
    get_current().log(*args)
