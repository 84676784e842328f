"""Output post-processing: normalization, depth colormaps, grids, PNG I/O.

Numpy re-implementations of the reference's torch helpers
(osmosis_utils/utils.py:21-159,748-763; torchvision make_grid usage in
osmosis_sampling.py:338-353). All functions take NHWC / HWC float arrays.
A port of ``osmosis_tpu/data/postprocess.py``: the percentile norm, the
depth colormap and the RGB PNG writer run in the native host ops
(:mod:`osmosis_tpu_torch.utils.native`) where they are built, else in numpy
and PIL; the viridis table is embedded
(:mod:`osmosis_tpu_torch.data.colormap`) instead of matplotlib's.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
from PIL import Image

from ..utils import native
from .colormap import VIRIDIS


def min_max_norm_range(
    img: np.ndarray, vmin: float = 0.0, vmax: float = 1.0
) -> np.ndarray:
    """Global min-max normalization (utils.py:46-76)."""
    img_min, img_max = img.min(), img.max()
    if img_min == img_max:
        return np.zeros_like(img)
    scale = (vmax - vmin) / (img_max - img_min)
    return (img - img_min) * scale + vmin


def min_max_norm_range_percentile(
    img: np.ndarray,
    vmin: float = 0.0,
    vmax: float = 1.0,
    percent_low: float = 0.0,
    percent_high: float = 1.0,
) -> np.ndarray:
    """Percentile clip then min-max normalize (utils.py:79-114)."""
    out = native.percentile_minmax_norm(
        np.asarray(img, np.float32), percent_low, percent_high, vmin, vmax
    )
    if out is not None:
        return out
    lo = np.quantile(img, percent_low)
    hi = np.quantile(img, percent_high)
    clipped = np.clip(img, lo, hi)
    return min_max_norm_range(clipped, vmin, vmax)


def clip01(img: np.ndarray) -> np.ndarray:
    return np.clip(img, 0.0, 1.0)


def to_01(img: np.ndarray) -> np.ndarray:
    """[-1,1] → [0,1]."""
    return 0.5 * (img + 1.0)


def depth_to_color(depth_01: np.ndarray) -> np.ndarray:
    """[H,W] (or [H,W,1]) depth in [0,1] → RGB through viridis
    (utils.py:748-763); NaN and values below 0 take the first colour."""
    d = np.squeeze(np.asarray(depth_01, np.float32))
    if d.ndim != 2:
        raise ValueError(f"expected 2-D depth, got {d.shape}")
    out = native.depth_to_color(d, VIRIDIS)
    if out is not None:
        return out
    d = np.where(d >= 0, np.minimum(d, 1.0), 0.0).astype(np.float32)
    return VIRIDIS[np.minimum((d * 256.0).astype(np.int64), 255)]


def make_grid(
    images: List[np.ndarray], nrow: int = 8, padding: int = 2, pad_value: float = 0.0
) -> np.ndarray:
    """torchvision.utils.make_grid equivalent for HWC float images in [0,1]."""
    n = len(images)
    h, w, c = images[0].shape
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    grid = np.full(
        (padding + nrows * (h + padding), padding + ncol * (w + padding), c),
        pad_value,
        dtype=np.float32,
    )
    for i, im in enumerate(images):
        r, col = divmod(i, ncol)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[y : y + h, x : x + w] = im
    return grid


def save_png(img01: np.ndarray, path: str):
    """HWC (or HW) float [0,1] → 8-bit PNG.

    ATOMIC: writes to a temp file then os.replace — the per-image resume
    contract (restore.py skip-if-output-exists) keys on file EXISTENCE, so
    a process killed mid-write must never leave a truncated PNG under the
    final name (see tests/test_multihost.py crash-then-resume)."""
    arr = (np.clip(np.nan_to_num(img01), 0.0, 1.0) * 255.0).round().astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    if arr.ndim == 3 and arr.shape[-1] == 3 and native.png_write_rgb8(tmp, arr):
        os.replace(tmp, path)
        return
    Image.fromarray(arr).save(tmp, format="PNG")
    os.replace(tmp, path)
