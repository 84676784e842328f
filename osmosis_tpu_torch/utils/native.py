"""ctypes bindings for the port's native host ops (``utils/csrc/host_ops.cc``;
port of ``osmosis_tpu/utils/native.py``).

Nothing is built at import: the first call builds the library with the first
C++ compiler that can (``$CXX``, then ``g++``, then the system's) into
``osmosis_tpu_torch/_build/`` (listed in ``.gitignore``), keyed by a hash of
the source, the compiler, the flags and the target that ``-march=native``
resolves to on this machine, so a changed source, flag or machine builds
anew. Every entry
point returns None (False for the PNG writer) where the library is not in
use, and its callers then take their numpy path: where ``OSMOSIS_TPU_NO_NATIVE``
is set, or where no toolchain can build it (``status()`` then holds the
build's error). ``available()`` says which path is active.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "host_ops.cc")
BUILD_DIR = os.path.abspath(os.path.join(os.path.dirname(SRC), "..", "..", "_build"))
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-Wall", "-std=c++17", "-shared")
NO_NATIVE_ENV = "OSMOSIS_TPU_NO_NATIVE"

_lock = threading.Lock()
_state = {"tried": False, "lib": None, "path": None, "error": None}


def compilers():
    """The C++ compilers to try, in order: ``$CXX``, ``g++`` on PATH, the
    system's ``/usr/bin/g++``, ``c++``; each once, by its resolved path."""
    found = []
    for name in (os.environ.get("CXX"), "g++", "/usr/bin/g++", "c++"):
        path = shutil.which(name) if name else None
        if path and path not in found:
            found.append(path)
    return found


def _native_target(cxx: str) -> str:
    """What ``-march=native`` means here: the compiler's expanded cc1plus
    line, whose -march/-mtune/-m flags name this machine's CPU."""
    proc = subprocess.run([cxx, "-march=native", "-###", "-E", "-x", "c++", os.devnull],
                          capture_output=True, text=True, timeout=60)
    return " ".join(ln for ln in proc.stderr.splitlines() if "cc1" in ln)


def lib_path(cxx: Optional[str] = None) -> str:
    """Where the library that ``cxx`` (the first compiler by default) builds
    from this source, with these flags, for this machine lives."""
    cxx = cxx or compilers()[0]
    with open(SRC, "rb") as f:
        key = f.read() + " ".join((cxx,) + CXX_FLAGS).encode() + _native_target(cxx).encode()
    return os.path.join(BUILD_DIR, f"libhost_ops-{hashlib.sha256(key).hexdigest()[:16]}.so")


def _compile(cxx: str) -> str:
    out = lib_path(cxx)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SRC, "-lz"], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed to build {os.path.basename(SRC)} (exit "
                           f"{proc.returncode}):\n{proc.stderr.strip()}")
    os.replace(tmp, out)
    return out


def build() -> str:
    """Compile the library with the first compiler that can (unless it
    exists); returns its path. Raises with every compiler's output where
    none can (no zlib headers, say)."""
    errors = []
    for cxx in compilers():
        try:
            return _compile(cxx)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            errors.append(str(e))
    raise RuntimeError("no C++ compiler built the native host ops:\n" + "\n".join(
        errors or ["no g++ or $CXX on PATH"]))


def _bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.preprocess_rgb_u8.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p]
    lib.preprocess_rgb_u8.restype = None
    lib.percentile_minmax_norm.argtypes = [f32p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                                           ctypes.c_float, ctypes.c_float, f32p]
    lib.percentile_minmax_norm.restype = None
    lib.apply_colormap_lut.argtypes = [f32p, ctypes.c_int, f32p, f32p]
    lib.apply_colormap_lut.restype = None
    lib.png_write_rgb8.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int]
    lib.png_write_rgb8.restype = ctypes.c_int
    lib.zstd_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t, u8p, ctypes.c_size_t]
    lib.zstd_decompress.restype = ctypes.c_longlong
    lib.zstd_last_error.argtypes = []
    lib.zstd_last_error.restype = ctypes.c_char_p
    lib.crc32c.argtypes = [u8p, ctypes.c_size_t]
    lib.crc32c.restype = ctypes.c_uint32
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call; None where
    ``OSMOSIS_TPU_NO_NATIVE`` is set or the build failed."""
    if os.environ.get(NO_NATIVE_ENV):
        return None
    with _lock:
        if not _state["tried"]:
            _state["tried"] = True
            try:
                _state["path"] = build()
                _state["lib"] = _bind(_state["path"])
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _state["error"] = f"{type(e).__name__}: {e}"
        return _state["lib"]


def available() -> bool:
    """Is the native path active (built, loaded and not switched off)?"""
    return _load() is not None


def status() -> str:
    """Which host path is active, and why, for a run's header."""
    if _load() is not None:
        return f"native ({os.path.basename(_state['path'])})"
    if os.environ.get(NO_NATIVE_ENV):
        return f"numpy ({NO_NATIVE_ENV} is set)"
    return f"numpy (the native library did not build: {_state['error']})"


def build_error() -> Optional[str]:
    """The build's error where it failed, else None."""
    _load()
    return _state["error"]


def preprocess_rgb_u8(img: np.ndarray, size: int) -> Optional[np.ndarray]:
    """u8 [H, W, 3] -> f32 [size, size, 3] in [-1, 1] (small side resized to
    ``size``, half-pixel bilinear, centre crop); None where not native."""
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, dtype=np.uint8)
    out = np.empty((size, size, 3), dtype=np.float32)
    lib.preprocess_rgb_u8(img, img.shape[0], img.shape[1], size, out)
    return out


def percentile_minmax_norm(arr: np.ndarray, p_low: float, p_high: float,
                           vmin: float = 0.0, vmax: float = 1.0) -> Optional[np.ndarray]:
    """Clip to the [p_low, p_high] quantiles, then min-max to [vmin, vmax];
    None where not native."""
    lib = _load()
    if lib is None:
        return None
    flat = np.ascontiguousarray(arr, dtype=np.float32).ravel()
    out = np.empty_like(flat)
    lib.percentile_minmax_norm(flat, flat.size, p_low, p_high, vmin, vmax, out)
    return out.reshape(np.shape(arr))


def depth_to_color(depth01: np.ndarray, lut256: Optional[np.ndarray] = None
                   ) -> Optional[np.ndarray]:
    """[H, W] in [0, 1] -> [H, W, 3] through the 256-entry ``lut256`` (viridis
    by default); None where not native."""
    lib = _load()
    if lib is None:
        return None
    if lut256 is None:
        from ..data.colormap import VIRIDIS as lut256
    flat = np.ascontiguousarray(depth01, dtype=np.float32).ravel()
    out = np.empty((flat.size, 3), dtype=np.float32)
    lib.apply_colormap_lut(flat, flat.size, np.ascontiguousarray(lut256, dtype=np.float32), out)
    return out.reshape(np.shape(depth01) + (3,))


def png_write_rgb8(path: str, rgb: np.ndarray) -> bool:
    """Write u8 [H, W, 3] as an 8-bit RGB PNG; False where not native (or
    where the write failed)."""
    lib = _load()
    if lib is None:
        return False
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {rgb.shape}")
    return lib.png_write_rgb8(os.fsencode(path), rgb, rgb.shape[0], rgb.shape[1]) == 0


def zstd_decompress(data: bytes, size: Optional[int] = None) -> Optional[bytes]:
    """Every zstd frame of ``data`` decompressed (``utils/zstd.py``'s
    contract) into a buffer of ``size`` bytes, or of the first frame's
    declared size, growing where neither says; None where not native.
    Raises ``utils.zstd.ZstdError`` on a corrupt frame."""
    lib = _load()
    if lib is None:
        return None
    from .zstd import ZstdError, frame_content_size

    data = bytes(data)
    cap = size
    if cap is None:
        try:
            cap = frame_content_size(data)
        except ZstdError:
            cap = None
        if cap is None:
            cap = 4 * len(data) + (1 << 16)
    while True:
        out = np.empty(max(cap, 1), dtype=np.uint8)
        n = lib.zstd_decompress(data, len(data), out, out.size)
        if n >= 0:
            return out[:n].tobytes()
        if n == -1:
            raise ZstdError(lib.zstd_last_error().decode())
        if size is not None:
            raise ZstdError(f"the frames hold more than the {size} bytes expected")
        cap *= 2


def _u8(data) -> np.ndarray:
    """A byte buffer (bytes, bytearray, memoryview, a C-contiguous array) as
    a flat uint8 array over the same memory."""
    return np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)


def crc32c(data) -> Optional[int]:
    """The CRC-32C of ``data`` (``utils/ocdbt.crc32c_py``'s value); None
    where not native."""
    lib = _load()
    if lib is None:
        return None
    src = _u8(data)
    return int(lib.crc32c(src, src.size))
