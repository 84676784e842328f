"""Build and load the port's CUDA C++ kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into its own shared library with
a plain C interface, loaded with ``ctypes``. Nothing is built at import: the
first call that needs a library builds it into ``osmosis_tpu_torch/_build/``
(listed in ``.gitignore``), keyed by a hash of the source and the flags, so a
changed source is rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "..", "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels of osmosis_tpu_torch are built from source at first use"
        )
    return found


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.abspath(os.path.join(BUILD_DIR, f"lib{name}-{digest}.so"))


def build(name: str) -> float:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns seconds spent."""
    out = _lib_path(name)
    if os.path.exists(out):
        return 0.0
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return time.perf_counter() - t0


def build_all(names: Sequence[str] = None) -> Dict[str, float]:
    """Build every source at once, one nvcc per source, all started together."""
    if names is None:
        names = sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = {n: pool.submit(build, n) for n in names}
        return {n: f.result() for n, f in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(_lib_path(name))
            lib.osm_error_string.argtypes = [ctypes.c_int]
            lib.osm_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.osm_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {code} ({msg})")
