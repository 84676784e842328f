"""Durable mid-chain checkpoint and resume for guided chains (port of
``osmosis_tpu/utils/chainjournal.py``).

``chain_checkpoint: True`` persists every completed restart or global chain
of an image, and the chain in flight at every ``progress_segments``
boundary (x_t, phi, its optimizer state, the x0 snapshot buffer, the ltsp
eps history and the traces so far), so a killed run re-entered with
``resume: True`` continues the image from the last boundary. Chain noise is
keyed on (seed, t, i), so the resumed chain gives the bits of an
uninterrupted one.

State lives under ``<run_dir>/.chain_state/<image>/`` and is deleted when
the image is done. Each file is an npz of raw byte buffers plus a JSON
manifest of the structure, loaded with ``allow_pickle=False``: loading builds
only tensors, numpy arrays, JSON scalars and containers, and the one
whitelisted ``GuidedResult``. Tensors (bf16 included) are stored as their
bytes with a dtype name and come back as CPU tensors. Every file carries a
config fingerprint; stale or corrupt files are treated as absent.

Fault injection for tests: ``OSMOSIS_TPU_CRASH_AFTER_SEGMENTS=N`` makes the
restore pipeline raise after the N-th boundary save in the process.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_FORMAT_VERSION = 2  # the JAX package's npz+manifest format, with tensors added


def _encode(obj: Any, arrays: Dict[str, np.ndarray]):
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, bool):
        return {"t": "bool", "v": obj}
    if isinstance(obj, int):
        return {"t": "int", "v": obj}
    if isinstance(obj, float):
        return {"t": "float", "v": obj}
    if isinstance(obj, str):
        return {"t": "str", "v": obj}
    if isinstance(obj, torch.Tensor):
        t = obj.detach().to("cpu").contiguous()
        key = f"a{len(arrays)}"
        arrays[key] = t.reshape(-1).view(torch.uint8).numpy().copy()
        return {"t": "tensor", "k": key, "d": str(t.dtype).split(".")[1],
                "s": list(t.shape)}
    if isinstance(obj, (np.ndarray, np.generic)):
        arr = np.ascontiguousarray(obj)
        key = f"a{len(arrays)}"
        arrays[key] = np.frombuffer(arr.tobytes(), np.uint8)
        return {"t": "arr", "k": key, "d": str(arr.dtype), "s": list(arr.shape)}
    if isinstance(obj, (list, tuple)):
        return {"t": "tuple" if isinstance(obj, tuple) else "list",
                "v": [_encode(x, arrays) for x in obj]}
    if isinstance(obj, dict):
        return {"t": "dict", "v": [[_encode(k, arrays), _encode(v, arrays)]
                                   for k, v in obj.items()]}
    if type(obj).__name__ == "GuidedResult" and dataclasses.is_dataclass(obj):
        return {"t": "GuidedResult",
                "v": {f.name: _encode(getattr(obj, f.name), arrays)
                      for f in dataclasses.fields(obj)}}
    raise TypeError(f"chainjournal cannot serialize {type(obj)!r}")


def _decode(node, npz):
    t = node["t"]
    if t == "none":
        return None
    if t in ("bool", "int", "float", "str"):
        return node["v"]
    if t == "tensor":
        dtype = getattr(torch, node["d"])
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"not a torch dtype: {node['d']!r}")
        raw = torch.from_numpy(np.array(npz[node["k"]], np.uint8))
        return raw.view(dtype).reshape(node["s"])
    if t == "arr":
        raw = npz[node["k"]]
        return np.frombuffer(bytearray(raw.tobytes()), np.dtype(node["d"])).reshape(node["s"])
    if t == "list":
        return [_decode(x, npz) for x in node["v"]]
    if t == "tuple":
        return tuple(_decode(x, npz) for x in node["v"])
    if t == "dict":
        return {_decode(k, npz): _decode(v, npz) for k, v in node["v"]}
    if t == "GuidedResult":
        from ..diffusion.guided import GuidedResult  # the whitelisted dataclass

        return GuidedResult(**{k: _decode(v, npz) for k, v in node["v"].items()})
    raise ValueError(f"unknown manifest node type {t!r}")


def _atomic_save(path: str, fingerprint: str, payload: Any) -> None:
    arrays: Dict[str, np.ndarray] = {}
    manifest = {"version": _FORMAT_VERSION, "fp": fingerprint,
                "payload": _encode(payload, arrays)}
    arrays["__manifest__"] = np.frombuffer(json.dumps(manifest).encode("utf-8"), np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic on POSIX: a crash never leaves half a file


def _load(path: str, fingerprint: str) -> Optional[Any]:
    try:
        with np.load(path, allow_pickle=False) as npz:
            manifest = json.loads(npz["__manifest__"].tobytes().decode("utf-8"))
            if manifest.get("version") != _FORMAT_VERSION or manifest.get("fp") != fingerprint:
                return None  # another config or format: stale
            return _decode(manifest["payload"], npz)
    except Exception:  # truncated, corrupt or foreign files count as absent
        return None


class ChainJournal:
    """Per-image durable state under <run_dir>/.chain_state/<image>/:

        chain_<tryk>_<gii>.npz   completed chain results (GuidedResult)
        partial.npz              the state of the chain in flight
    """

    def __init__(self, run_dir: str, image_name: str, fingerprint: str):
        self.dir = os.path.join(run_dir, ".chain_state", image_name)
        self.fp = fingerprint
        for attempt in range(3):
            try:
                os.makedirs(self.dir, exist_ok=True)
                break
            except FileNotFoundError:  # another rank's clear() took the empty parent
                if attempt == 2:
                    raise

    def _chain_path(self, try_k: int, global_ii: int) -> str:
        return os.path.join(self.dir, f"chain_{try_k}_{global_ii}.npz")

    def save_chain(self, try_k: int, global_ii: int, res: Any) -> None:
        _atomic_save(self._chain_path(try_k, global_ii), self.fp, res)

    def load_chains(self) -> Dict[Tuple[int, int], Any]:
        out: Dict[Tuple[int, int], Any] = {}
        for name in sorted(os.listdir(self.dir)):
            if not (name.startswith("chain_") and name.endswith(".npz")):
                continue
            try:
                try_k, gii = (int(x) for x in name[6:-4].split("_"))
            except ValueError:
                continue
            payload = _load(os.path.join(self.dir, name), self.fp)
            if payload is not None:
                out[(try_k, gii)] = payload
        return out

    @property
    def _partial_path(self) -> str:
        return os.path.join(self.dir, "partial.npz")

    def save_partial(self, tag: Tuple[int, int], state: Dict[str, Any]) -> None:
        _atomic_save(self._partial_path, self.fp, {"tag": tuple(tag), "state": state})

    def load_partial(self, tag: Tuple[int, int]) -> Optional[Dict[str, Any]]:
        payload = _load(self._partial_path, self.fp)
        if payload is None or tuple(payload.get("tag", ())) != tuple(tag):
            return None
        return payload["state"]

    def clear_partial(self) -> None:
        try:
            os.remove(self._partial_path)
        except FileNotFoundError:
            pass

    def clear(self) -> None:
        """The image is done: remove its state, and the parent when empty."""
        shutil.rmtree(self.dir, ignore_errors=True)
        try:
            os.rmdir(os.path.dirname(self.dir))
        except OSError:
            pass
