"""Preprocessing: resize small side → center crop → normalize to [-1,1].

Reference builds `ToTensor → Resize(256) → CenterCrop(256²) → Normalize(.5,.5)`
(osmosis_sampling.py:46-49) with torchvision's tensor-path Resize (pure
half-pixel bilinear). A port of ``osmosis_tpu/data/transforms.py``: the
native host ops (:mod:`osmosis_tpu_torch.utils.native`, fused resize, crop
and normalize) where they are built, else the numpy path, which gives the
same values.
"""

from __future__ import annotations

from typing import Union

import numpy as np
from PIL import Image

from ..utils import native


def _small_side_dims(h: int, w: int, size: int):
    """torchvision 0.14.1 ``_compute_resized_output_size`` semantics (the
    version the reference pins, environment.yml): the long side TRUNCATES —
    ``int(size * long / short)`` — it does NOT round. A one-pixel size
    difference here shifts the center crop half a pixel and pollutes every
    real-weights comparison at the input."""
    short, long = (w, h) if w <= h else (h, w)
    new_short, new_long = size, int(size * long / short)
    return (new_long, new_short) if w <= h else (new_short, new_long)


def bilinear_resize_u8(arr: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Half-pixel-center bilinear resize, u8 [H,W,C] → f32 [new_h,new_w,C]."""
    h, w = arr.shape[:2]
    fy = (np.arange(new_h) + 0.5) * (h / new_h) - 0.5
    fx = (np.arange(new_w) + 0.5) * (w / new_w) - 0.5
    y0 = np.floor(fy).astype(int)
    x0 = np.floor(fx).astype(int)
    wy = (fy - y0)[:, None, None]
    wx = (fx - x0)[None, :, None]
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    y0 = np.clip(y0, 0, h - 1)
    x0 = np.clip(x0, 0, w - 1)
    a = arr.astype(np.float32)
    top = a[y0][:, x0] * (1 - wx) + a[y0][:, x1] * wx
    bot = a[y1][:, x0] * (1 - wx) + a[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    """[H,W,C] center crop to size×size (pads with zeros if smaller)."""
    h, w = arr.shape[:2]
    if h < size or w < size:
        pad_h, pad_w = max(0, size - h), max(0, size - w)
        arr = np.pad(
            arr,
            ((pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2), (0, 0)),
        )
        h, w = arr.shape[:2]
    # torchvision 0.14.1 F.center_crop: int(round(diff / 2.0)) — Python's
    # banker's rounding, NOT floor division (they differ when diff ≡ 3 mod 4)
    top = int(round((h - size) / 2.0))
    left = int(round((w - size) / 2.0))
    return arr[top : top + size, left : left + size]


def preprocess_image(img: Union[Image.Image, np.ndarray], size: int = 256) -> np.ndarray:
    """Image → float32 [size,size,3] in [-1,1], resized + center-cropped."""
    if isinstance(img, Image.Image):
        if img.mode != "RGB":
            img = img.convert("RGB")
        arr = np.asarray(img, dtype=np.uint8)
    else:
        arr = np.asarray(img)
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)

    out = native.preprocess_rgb_u8(arr, size)
    if out is not None:
        return out

    h, w = arr.shape[:2]
    new_h, new_w = _small_side_dims(h, w, size)
    resized = bilinear_resize_u8(arr, new_h, new_w)
    cropped = center_crop(resized, size)
    return (cropped / 255.0 * 2.0 - 1.0).astype(np.float32)


def degamma(y, gamma: float = 2.2):
    """Optional input linearization for haze images
    (osmosis_sampling.py:173-175): y ← 2·((y+1)/2)^2.2 − 1, on a numpy
    array or a tensor."""
    y01 = 0.5 * (y + 1.0)
    return 2.0 * y01 ** gamma - 1.0
