"""Host image transforms: port of ``slak_tpu/data/transforms.py``, the
timm recipe the reference uses (``datasets.py:50-96``,
``timm1/data/transforms_factory.py:45-134``).

train: RandomResizedCrop(scale (0.08, 1), ratio (3/4, 4/3), bicubic)
       -> hflip 0.5 -> RandAugment(rand-m9-mstd0.5-inc1)
       [-> ColorJitter(0.4) only when RandAugment is off, as timm]
       -> float32 [0, 1] -> the ImageNet (or inception) mean and std.
       Without RandAugment and colour jitter, at bicubic, the crop,
       resample, flip and normalize run as one pass of the native host
       library (``data/native.py``), else through PIL
       (:meth:`TrainTransform.host_path` says which).
eval:  resize the shorter side to size / crop_pct (bicubic) and center
       crop, or a straight warp-resize when size >= 384 (the ERF
       protocol's 1024^2).

Random erasing and mixup run on the device (``data/random_erasing.py``,
``data/mixup.py``). The draws come from
:func:`~slak_tpu_torch.data.host_rng.host_rng`, so under the same
``random`` seed the bytes are ``slak_tpu``'s. PIL is imported where an
image is touched, so the module imports without it.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from slak_tpu_torch.data.auto_augment import rand_augment_from_config
from slak_tpu_torch.data.host_rng import host_rng

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# timm's inception/default stats, selected by the reference's
# --imagenet_default_mean_and_std false (datasets.py:55-60)
INCEPTION_MEAN = np.array([0.5, 0.5, 0.5], np.float32)
INCEPTION_STD = np.array([0.5, 0.5, 0.5], np.float32)
DEFAULT_CROP_PCT = 0.875


RESAMPLE = ("bicubic", "bilinear", "random")


def _pick_resample(interpolation: str):
    """timm's --train_interpolation: 'random' draws bilinear or bicubic
    per image (timm1/data/transforms.py RandomResizedCropAndInterpolation)."""
    from PIL import Image
    if interpolation == "random":
        return host_rng().choice((Image.BILINEAR, Image.BICUBIC))
    if interpolation not in RESAMPLE:
        raise ValueError(f"interpolation {interpolation!r}: one of "
                         f"{'/'.join(RESAMPLE)}")
    return Image.BICUBIC if interpolation == "bicubic" else Image.BILINEAR


def sample_rrc_box(w: int, h: int, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """torchvision RandomResizedCrop box sampling (10 attempts, center
    fallback). Returns (left, top, cw, ch)."""
    rng = host_rng()
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            return rng.randint(0, w - cw), rng.randint(0, h - ch), cw, ch
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    return (w - cw) // 2, (h - ch) // 2, cw, ch


def random_resized_crop(img, size: int, scale=(0.08, 1.0),
                        ratio=(3 / 4, 4 / 3), interpolation: str = "bicubic"):
    """torchvision RandomResizedCrop on a PIL image."""
    resample = _pick_resample(interpolation)
    left, top, cw, ch = sample_rrc_box(*img.size, scale, ratio)
    return img.resize((size, size), resample,
                      box=(left, top, left + cw, top + ch))


def color_jitter(img, amount: float = 0.4):
    """torchvision ColorJitter(brightness, contrast, saturation) with equal
    amounts, in random order."""
    from PIL import ImageEnhance
    rng = host_rng()
    ops = [ImageEnhance.Brightness, ImageEnhance.Contrast,
           ImageEnhance.Color]
    rng.shuffle(ops)
    for cls in ops:
        img = cls(img).enhance(rng.uniform(max(0.0, 1 - amount), 1 + amount))
    return img


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


class TrainTransform:
    """PIL image -> normalized float32 (size, size, 3).

    With ``use_native`` (default), no RandAugment, no colour jitter and
    bicubic, the crop, resample, flip and normalize run fused in the
    native host library; else (or without the library) through PIL, with
    RandAugment and colour jitter on uint8 in between."""

    def __init__(self, size: int = 224, hflip: float = 0.5,
                 auto_augment: Optional[str] = "rand-m9-mstd0.5-inc1",
                 color_jitter_amount: Optional[float] = 0.4,
                 scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 use_native: bool = True, interpolation: str = "bicubic",
                 imagenet_mean_and_std: bool = True):
        self.size = size
        self.hflip = hflip
        self.aa = rand_augment_from_config(auto_augment) \
            if auto_augment else None
        # timm: colour jitter only when RandAugment is off
        self.cj = color_jitter_amount if (color_jitter_amount
                                          and not auto_augment) else None
        self.scale, self.ratio = scale, ratio
        self.interpolation = interpolation
        self.mean = IMAGENET_MEAN if imagenet_mean_and_std else INCEPTION_MEAN
        self.std = IMAGENET_STD if imagenet_mean_and_std else INCEPTION_STD
        self.use_native = use_native

    def _native_ok(self) -> bool:
        return (self.use_native and self.aa is None and self.cj is None
                and self.interpolation == "bicubic")

    def host_path(self) -> str:
        """"native" when images go through the native library's fused
        pass, "pil" when through PIL."""
        from slak_tpu_torch.data import native
        return "native" if self._native_ok() and native.get_lib() \
            is not None else "pil"

    def __call__(self, img) -> np.ndarray:
        from PIL import Image
        if img.mode != "RGB":
            img = img.convert("RGB")
        rng = host_rng()
        flip = bool(self.hflip and rng.random() < self.hflip)

        if self._native_ok():
            from slak_tpu_torch.data import native
            box = sample_rrc_box(*img.size, self.scale, self.ratio)
            out = native.rrc_normalize(np.asarray(img), box, self.size, flip,
                                       self.mean, self.std)
            if out is not None:
                return out

        img = random_resized_crop(img, self.size, self.scale, self.ratio,
                                  self.interpolation)
        if flip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if self.aa is not None:
            img = self.aa(img)
        if self.cj is not None:
            img = color_jitter(img, self.cj)
        return normalize(np.asarray(img), self.mean, self.std)


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
