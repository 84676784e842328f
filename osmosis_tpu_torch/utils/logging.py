"""Structured run logger (port of ``osmosis_tpu/utils/logging.py``, without
its TensorBoard sink).

Text lines go to stdout and ``<dir>/log.txt``; key-value rows accumulate
into ``<dir>/progress.csv`` and ``progress.json``. When a later row brings
new keys the CSV is rewritten with the wider header and old rows padded, so
rows never misalign.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class RunLogger:
    def __init__(self, dir: Optional[str] = None):
        self.dir = dir
        self._file = None
        self._kv: Dict[str, Any] = {}
        self._csv_keys: Optional[list] = None
        if dir is not None:
            os.makedirs(dir, exist_ok=True)
            self._file = open(os.path.join(dir, "log.txt"), "a")

    def log(self, *args):
        msg = " ".join(str(a) for a in args)
        print(msg)
        if self._file:
            self._file.write(msg + "\n")
            self._file.flush()

    def logkv(self, key: str, value: Any):
        self._kv[key] = value

    def _write_csv(self, row: Dict[str, Any]):
        csv_path = os.path.join(self.dir, "progress.csv")
        new_keys = [k for k in row if self._csv_keys is None or k not in self._csv_keys]
        if self._csv_keys is None:
            self._csv_keys = list(row)
            with open(csv_path, "a") as f:
                f.write(",".join(self._csv_keys) + "\n")
        elif new_keys:
            self._csv_keys = self._csv_keys + new_keys
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
        with open(os.path.join(self.dir, "progress.json"), "a") as f:
            f.write(json.dumps(row, default=str) + "\n")
        self._write_csv(row)
        self._kv = {}

    def close(self):
        if self._file:
            self._file.close()
            self._file = None
