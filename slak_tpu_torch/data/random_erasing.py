"""Random erasing on the device: port of ``slak_tpu/data/random_erasing.py``
(timm's ``RandomErasing``, ``timm1/data/random_erasing.py:26-110``; recipe
p = 0.25, mode 'pixel', count 1, after normalization).

Per image, with probability p, a rectangle whose area is U(0.02, 1/3) of
the image's and whose log aspect is U(log 0.3, log 10/3) is filled with
per-pixel normal noise ('pixel'), one normal draw per channel ('rand') or
zeros ('const'). As in ``slak_tpu``, one draw is clipped to the image
(timm retries up to 10 times). The draws come from an explicit
``torch.Generator`` on the batch's device: :func:`draw_erase` makes them,
:func:`erase_apply` erases with given draws.
"""

from __future__ import annotations

import dataclasses
import math

import torch

ERASE_MODES = ("pixel", "rand", "const")


@dataclasses.dataclass(frozen=True)
class RandomErasingConfig:
    prob: float = 0.25
    min_area: float = 0.02
    max_area: float = 1.0 / 3.0
    min_aspect: float = 0.3
    max_aspect: float = 1.0 / 0.3
    count: int = 1
    mode: str = "pixel"

    def __post_init__(self):
        if self.mode not in ERASE_MODES:
            raise ValueError(f"random-erasing mode {self.mode!r}: one of "
                             f"{'/'.join(ERASE_MODES)}")


@dataclasses.dataclass
class EraseDraws:
    """(N,) ``apply`` (bool), ``top``, ``left``, ``eh``, ``ew`` (int64)
    and the fill, broadcastable to the (N, H, W, C) batch."""
    apply: torch.Tensor
    top: torch.Tensor
    left: torch.Tensor
    eh: torch.Tensor
    ew: torch.Tensor
    fill: torch.Tensor


def _rand(gen, shape, device):
    return torch.rand(shape, generator=gen, device=gen.device).to(device)


def draw_erase(gen: torch.Generator, shape, cfg: RandomErasingConfig,
               device) -> EraseDraws:
    """One erasing round's draws for a batch of ``shape`` (N, H, W, C)."""
    n, h, w, c = shape
    apply = _rand(gen, (n,), device) < cfg.prob
    target = (h * w) * (cfg.min_area + (cfg.max_area - cfg.min_area)
                        * _rand(gen, (n,), device))
    lo, hi = math.log(cfg.min_aspect), math.log(cfg.max_aspect)
    ar = torch.exp(lo + (hi - lo) * _rand(gen, (n,), device))
    eh = torch.sqrt(target * ar).long().clamp(1, h)
    ew = torch.sqrt(target / ar).long().clamp(1, w)
    top = torch.floor(_rand(gen, (n,), device).double()
                      * (h - eh).clamp(min=1)).long()
    left = torch.floor(_rand(gen, (n,), device).double()
                       * (w - ew).clamp(min=1)).long()
    if cfg.mode == "pixel":
        fill = torch.randn(shape, generator=gen, device=gen.device)
    elif cfg.mode == "rand":
        fill = torch.randn((n, 1, 1, c), generator=gen, device=gen.device)
    else:
        fill = torch.zeros((n, 1, 1, c), device=gen.device)
    return EraseDraws(apply, top, left, eh, ew, fill.to(device))


def erase_apply(images: torch.Tensor, d: EraseDraws) -> torch.Tensor:
    """The batch with each applied image's box filled from ``d.fill``."""
    _, h, w, _ = images.shape
    dev = images.device
    rows = torch.arange(h, device=dev)[None, :, None]
    cols = torch.arange(w, device=dev)[None, None, :]
    top, left = d.top[:, None, None], d.left[:, None, None]
    box = ((rows >= top) & (rows < top + d.eh[:, None, None])
           & (cols >= left) & (cols < left + d.ew[:, None, None])
           & d.apply[:, None, None])
    return torch.where(box[..., None], d.fill.to(images.dtype), images)


def random_erasing(gen: torch.Generator, images: torch.Tensor,
                   cfg: RandomErasingConfig = RandomErasingConfig()
                   ) -> torch.Tensor:
    """images (N, H, W, C), already normalized -> the erased batch."""
    for _ in range(cfg.count):
        images = erase_apply(images, draw_erase(gen, images.shape, cfg,
                                                images.device))
    return images
