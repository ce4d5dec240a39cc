"""Eval image transform: port of the eval half of
``slak_tpu/data/transforms.py`` (the timm recipe the reference uses,
``datasets.py:75-96``): resize the shorter side to size / crop_pct
(bicubic) and center crop, or a straight warp-resize when size >= 384 (the
ERF protocol's 1024^2), then float32 [0, 1] and the ImageNet (or
inception) mean and std. PIL is imported where an image is resized, so the
module imports without it; the train transforms are still to port.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# timm's inception/default stats, selected by the reference's
# --imagenet_default_mean_and_std false (datasets.py:55-60)
INCEPTION_MEAN = np.array([0.5, 0.5, 0.5], np.float32)
INCEPTION_STD = np.array([0.5, 0.5, 0.5], np.float32)
DEFAULT_CROP_PCT = 0.875


def center_crop_resize(img, size: int, crop_pct: float = DEFAULT_CROP_PCT):
    """Eval path on a PIL image: resize the shorter side to size/crop_pct,
    center crop size^2; warp-resize for size >= 384 (datasets.py:75-96)."""
    from PIL import Image
    if size >= 384:
        return img.resize((size, size), Image.BICUBIC)
    scale_size = int(math.floor(size / crop_pct))
    w, h = img.size
    if w <= h:
        nw, nh = scale_size, int(round(scale_size * h / w))
    else:
        nh, nw = scale_size, int(round(scale_size * w / h))
    img = img.resize((nw, nh), Image.BICUBIC)
    left, top = (nw - size) // 2, (nh - size) // 2
    return img.crop((left, top, left + size, top + size))


def normalize(arr: np.ndarray, mean: np.ndarray = IMAGENET_MEAN,
              std: np.ndarray = IMAGENET_STD) -> np.ndarray:
    """uint8 HWC -> normalized float32 HWC."""
    return (arr.astype(np.float32) / 255.0 - mean) / std


class EvalTransform:
    """PIL image -> normalized float32 (size, size, 3)."""

    def __init__(self, size: int = 224,
                 crop_pct: Optional[float] = DEFAULT_CROP_PCT,
                 imagenet_mean_and_std: bool = True):
        self.size = size
        self.crop_pct = crop_pct if crop_pct is not None else DEFAULT_CROP_PCT
        self.mean = IMAGENET_MEAN if imagenet_mean_and_std else INCEPTION_MEAN
        self.std = IMAGENET_STD if imagenet_mean_and_std else INCEPTION_STD

    def __call__(self, img) -> np.ndarray:
        if img.mode != "RGB":
            img = img.convert("RGB")
        img = center_crop_resize(img, self.size, self.crop_pct)
        return normalize(np.asarray(img), self.mean, self.std)
