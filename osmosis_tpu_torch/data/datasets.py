"""Host-side image datasets (reference: osmosis_utils/data.py).

Decode happens on the host (PIL with an OpenCV fallback for odd formats,
data.py:25-31); the resize/crop/normalize pipeline is in
:mod:`osmosis_tpu_torch.data.transforms`. Natural sort is implemented
locally (the reference uses the natsort package, data.py:19). A copy of
``osmosis_tpu/data/datasets.py``.
"""

from __future__ import annotations

import glob
import os
import re
from typing import List

import numpy as np
from PIL import Image


def natsorted(items) -> List[str]:
    """Natural ("human") sort: image2 < image10."""

    def key(s):
        return [int(p) if p.isdigit() else p.lower() for p in re.split(r"(\d+)", str(s))]

    return sorted(items, key=key)


def _load_image(path: str) -> Image.Image:
    """PIL decode with cv2 fallback for formats PIL rejects; 16-bit images
    come back scaled by //255 like the reference (data.py:25-31)."""
    try:
        img = Image.open(path)
        img.load()
        return img
    except Exception:
        import cv2

        arr = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        arr = arr // 255
        return Image.fromarray(arr.astype(np.uint8))


class ImagesFolder:
    """Flat image-folder dataset (data.py:15-36). Yields (PIL image, filename)."""

    def __init__(self, root_dir: str, transform=None):
        self.root_dir = root_dir
        self.images_list = natsorted(os.listdir(root_dir))
        self.transform = transform

    def __len__(self):
        return len(self.images_list)

    def __getitem__(self, idx: int):
        image = _load_image(os.path.join(self.root_dir, self.images_list[idx]))
        if self.transform is not None:
            image = self.transform(image)
        return image, self.images_list[idx]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class ImagesFolderGT:
    """Input + GT rgb + GT depth triples for the simulation set
    (data.py:73-109). uint16 depth maps are scaled //256 to uint8 then
    converted to RGB (data.py:93-98)."""

    def __init__(self, root_dir: str, gt_rgb_dir: str, gt_depth_dir: str, transform=None):
        self.images_list = natsorted(glob.glob(os.path.join(root_dir, "*.*")))
        self.gt_rgb_list = natsorted(glob.glob(os.path.join(gt_rgb_dir, "*.*")))
        self.gt_depth_list = natsorted(glob.glob(os.path.join(gt_depth_dir, "*.*")))
        self.transform = transform

    def __len__(self):
        return len(self.gt_rgb_list)

    def __getitem__(self, idx: int):
        image_name = os.path.basename(self.images_list[idx])
        image = _load_image(self.images_list[idx])
        gt_rgb = _load_image(self.gt_rgb_list[idx])

        import cv2

        depth_arr = cv2.imread(self.gt_depth_list[idx], cv2.IMREAD_UNCHANGED)
        if depth_arr.dtype == np.uint16:
            gt_depth = Image.fromarray((depth_arr // 256).astype(np.uint8))
        else:
            gt_depth = Image.fromarray(depth_arr)
        gt_depth = gt_depth.convert(mode="RGB")

        if self.transform is not None:
            image = self.transform(image)
            gt_rgb = self.transform(gt_rgb)
            gt_depth = self.transform(gt_depth)
        return [image, gt_rgb, gt_depth], image_name

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
