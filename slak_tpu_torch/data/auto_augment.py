"""RandAugment: port of ``slak_tpu/data/auto_augment.py``, the host-side
PIL implementation of the policy the reference trains with,
``rand-m9-mstd0.5-inc1`` (README.md:104; spec in the vendored
``timm1/data/auto_augment.py:588-860``). The draws come from
:func:`~slak_tpu_torch.data.host_rng.host_rng`, so under the same
``random`` seed it gives ``slak_tpu``'s bytes.

Semantics replicated:
  * 2 ops per image, each applied with prob 0.5;
  * magnitude 9 jittered per-op by N(0, 0.5), clipped to [0, 10];
  * ``inc1``: the *increasing-severity* transform list, where
    Posterize/Solarize/Color/Contrast/Brightness/Sharpness get stronger (not
    weaker) as magnitude grows;
  * geometric ops fill with neutral gray (128, 128, 128).

PIL is imported where an op runs, so the module imports without it.
"""

from __future__ import annotations

import numpy as np

from slak_tpu_torch.data.host_rng import host_rng

_FILL = (128, 128, 128)
_MAX_LEVEL = 10.0


def _randomly_negate(v: float) -> float:
    return -v if host_rng().random() > 0.5 else v


# --- op implementations ------------------------------------------------------

def auto_contrast(img, _):
    from PIL import ImageOps
    return ImageOps.autocontrast(img)


def equalize(img, _):
    from PIL import ImageOps
    return ImageOps.equalize(img)


def invert(img, _):
    from PIL import ImageOps
    return ImageOps.invert(img)


def rotate(img, m):
    from PIL import Image
    deg = _randomly_negate((m / _MAX_LEVEL) * 30.0)
    return img.rotate(deg, resample=Image.BILINEAR, fillcolor=_FILL)


def posterize_inc(img, m):
    from PIL import ImageOps
    bits = 4 - int((m / _MAX_LEVEL) * 4)
    return ImageOps.posterize(img, max(bits, 1))


def solarize_inc(img, m):
    from PIL import ImageOps
    thr = 256 - int((m / _MAX_LEVEL) * 256)
    return ImageOps.solarize(img, thr)


def solarize_add(img, m):
    from PIL import Image
    add = int((m / _MAX_LEVEL) * 110)
    arr = np.asarray(img).astype(np.int32)
    out = np.where(arr < 128, np.clip(arr + add, 0, 255), arr)
    return Image.fromarray(out.astype(np.uint8))


def _enhance_inc(name):
    def op(img, m):
        from PIL import ImageEnhance
        factor = 1.0 + _randomly_negate((m / _MAX_LEVEL) * 0.9)
        return getattr(ImageEnhance, name)(img).enhance(max(factor, 0.0))
    op.__name__ = name.lower() + "_inc"
    return op


def _affine(img, coeffs):
    from PIL import Image
    return img.transform(img.size, Image.AFFINE, coeffs,
                         resample=Image.BILINEAR, fillcolor=_FILL)


def shear_x(img, m):
    v = _randomly_negate((m / _MAX_LEVEL) * 0.3)
    return _affine(img, (1, v, 0, 0, 1, 0))


def shear_y(img, m):
    v = _randomly_negate((m / _MAX_LEVEL) * 0.3)
    return _affine(img, (1, 0, 0, v, 1, 0))


def translate_x_rel(img, m):
    v = _randomly_negate((m / _MAX_LEVEL) * 0.45) * img.size[0]
    return _affine(img, (1, 0, v, 0, 1, 0))


def translate_y_rel(img, m):
    v = _randomly_negate((m / _MAX_LEVEL) * 0.45) * img.size[1]
    return _affine(img, (1, 0, 0, 0, 1, v))


# the increasing-severity list (timm _RAND_INCREASING_TRANSFORMS)
RAND_INCREASING_OPS = [
    auto_contrast,
    equalize,
    invert,
    rotate,
    posterize_inc,
    solarize_inc,
    solarize_add,
    _enhance_inc("Color"),
    _enhance_inc("Contrast"),
    _enhance_inc("Brightness"),
    _enhance_inc("Sharpness"),
    shear_x,
    shear_y,
    translate_x_rel,
    translate_y_rel,
]


class RandAugment:
    """``rand-m{M}-mstd{S}-inc1`` with N ops per image."""

    def __init__(self, num_ops: int = 2, magnitude: float = 9.0,
                 mstd: float = 0.5, prob: float = 0.5):
        self.num_ops = num_ops
        self.magnitude = magnitude
        self.mstd = mstd
        self.prob = prob

    def __call__(self, img):
        rng = host_rng()
        ops = rng.choices(RAND_INCREASING_OPS, k=self.num_ops)
        for op in ops:
            if rng.random() > self.prob:
                continue
            m = self.magnitude
            if self.mstd > 0:
                m = rng.gauss(m, self.mstd)
            m = min(max(m, 0.0), _MAX_LEVEL)
            img = op(img, m)
        return img


def rand_augment_from_config(config: str) -> RandAugment:
    """Parse a timm-style config string, e.g. ``rand-m9-mstd0.5-inc1``."""
    parts = config.split("-")
    if parts[0] != "rand":
        raise ValueError(f"not a RandAugment config: {config!r}")
    kw = dict(num_ops=2, magnitude=9.0, mstd=0.5)
    for p in parts[1:]:
        if p.startswith("mstd"):
            kw["mstd"] = float(p[4:])
        elif p.startswith("m"):
            kw["magnitude"] = float(p[1:])
        elif p.startswith("n"):
            kw["num_ops"] = int(p[1:])
        elif p.startswith("inc"):
            pass  # increasing list is the only one we ship
        elif p.startswith("p"):
            kw["prob"] = float(p[1:])
    return RandAugment(**kw)
