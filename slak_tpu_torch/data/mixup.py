"""Mixup / CutMix with soft targets on the device: port of
``slak_tpu/data/mixup.py`` (timm's ``Mixup``, ``timm1/data/mixup.py:
90-218``, applied in the reference's engine, ``engine.py:49-50``; recipe
mixup 0.8, cutmix 1.0, switch_prob 0.5, label smoothing 0.1).

Images are the loader's NHWC batch on the device. The draws come from an
explicit ``torch.Generator`` on the batch's device and stay there (no host
round trip, no sync): :func:`draw_mix` makes them, :func:`mix_apply`
mixes with given draws, so a test can hand both packages the same lam and
box. All three timm modes:
  * 'batch': one (lam, use_cutmix, box) for the whole batch;
  * 'elem': per sample, the partner of sample i being N-1-i;
  * 'pair': per pair (i, N-1-i), the first half's draws mirrored onto the
    second half (an odd middle sample keeps lam 1).
Beta draws are Marsaglia-Tsang gamma draws (16 tries a value, all drawn
at once; the chance that none is accepted is below 1e-20 at the recipe's
alphas), X / (X + Y).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

MODES = ("batch", "pair", "elem")
_GAMMA_TRIES = 16


@dataclasses.dataclass(frozen=True)
class MixupConfig:
    mixup_alpha: float = 0.8
    cutmix_alpha: float = 1.0
    # timm --cutmix_minmax: boxes by side fraction ~ U(minmax) per axis
    # (rand_bbox_minmax, mixup.py:48-74), lam from the exact box area
    cutmix_minmax: Optional[Tuple[float, float]] = None
    prob: float = 1.0              # mixup_prob: apply mixing at all
    switch_prob: float = 0.5       # cutmix rather than mixup
    mode: str = "batch"
    label_smoothing: float = 0.1
    num_classes: int = 1000

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mixup mode {self.mode!r}: one of "
                             f"{'/'.join(MODES)}")

    @property
    def enabled(self) -> bool:
        return (self.mixup_alpha > 0 or self.cutmix_alpha > 0
                or self.cutmix_minmax is not None)

    @property
    def cutmix_enabled(self) -> bool:
        return self.cutmix_alpha > 0 or self.cutmix_minmax is not None


@dataclasses.dataclass
class MixDraws:
    """Per-sample draws, all (N,) on the batch's device: ``apply``,
    ``use_cutmix`` (bool), ``lam_mix`` (float32), ``box`` (N, 4) int64
    rows (y1, y2, x1, x2)."""
    apply: torch.Tensor
    use_cutmix: torch.Tensor
    lam_mix: torch.Tensor
    box: torch.Tensor


def one_hot(labels: torch.Tensor, num_classes: int, on: float,
            off: float) -> torch.Tensor:
    """timm mixup.py:14-19."""
    oh = torch.nn.functional.one_hot(labels.long(), num_classes).float()
    return oh * on + (1.0 - oh) * off


def mixup_target(labels: torch.Tensor, num_classes: int, lam,
                 smoothing: float) -> torch.Tensor:
    """timm mixup.py:22-27: lam * y + (1 - lam) * y_flipped, smoothed;
    ``lam`` a scalar or per sample (N,)."""
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    y1 = one_hot(labels, num_classes, on, off)
    y2 = one_hot(labels.flip(0), num_classes, on, off)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=y1.device)
    if lam.ndim:
        lam = lam.reshape(-1, 1)
    return y1 * lam + y2 * (1.0 - lam)


def _rand(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device).to(device)


def _randint(gen, low, high, shape, device) -> torch.Tensor:
    """Uniform ints in [low, high) (tensors or numbers, broadcast)."""
    u = _rand(gen, shape, device).double()
    low = torch.as_tensor(low, device=device)
    high = torch.as_tensor(high, device=device)
    return low + torch.floor(u * (high - low)).long()


def _gamma(gen, alpha: float, shape, device) -> torch.Tensor:
    """Gamma(alpha, 1) by Marsaglia-Tsang; alpha < 1 through
    Gamma(alpha + 1) * U^(1 / alpha)."""
    a = alpha if alpha >= 1.0 else alpha + 1.0
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    tries = tuple(shape) + (_GAMMA_TRIES,)
    z = torch.randn(tries, generator=gen, device=gen.device).to(device)
    u = _rand(gen, tries, device)
    v = (1.0 + c * z) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                    + d * torch.log(v.clamp(min=1e-30)))
    first = torch.argmax(ok.int(), dim=-1, keepdim=True)
    g = torch.where(ok.any(-1), (d * v).gather(-1, first)[..., 0],
                    torch.full(tuple(shape), d, device=device))
    if alpha < 1.0:
        g = g * _rand(gen, shape, device) ** (1.0 / alpha)
    return g


def _beta(gen, alpha: float, shape, device) -> torch.Tensor:
    x = _gamma(gen, alpha, shape, device)
    y = _gamma(gen, alpha, shape, device)
    return (x / (x + y)).float()


def _boxes(gen, h: int, w: int, lam_cut: torch.Tensor,
           cfg: MixupConfig) -> torch.Tensor:
    """(M, 4) boxes (y1, y2, x1, x2): side ratio sqrt(1 - lam), centre
    uniform, clipped (cutmix_bbox_and_lam, mixup.py:77-87); or with
    ``cutmix_minmax`` sides ~ U(minmax), the box inside the image."""
    m, dev = lam_cut.shape[0], lam_cut.device
    if cfg.cutmix_minmax is not None:
        lo, hi = cfg.cutmix_minmax
        cut_h = _randint(gen, int(h * lo), max(int(h * hi), int(h * lo) + 1),
                         (m,), dev)
        cut_w = _randint(gen, int(w * lo), max(int(w * hi), int(w * lo) + 1),
                         (m,), dev)
        y1 = _randint(gen, 0, (h - cut_h).clamp(min=1), (m,), dev)
        x1 = _randint(gen, 0, (w - cut_w).clamp(min=1), (m,), dev)
        return torch.stack([y1, y1 + cut_h, x1, x1 + cut_w], 1)
    ratio = torch.sqrt(1.0 - lam_cut)
    cut_h = (h * ratio).long()
    cut_w = (w * ratio).long()
    cy = _randint(gen, 0, h, (m,), dev)
    cx = _randint(gen, 0, w, (m,), dev)
    return torch.stack([(cy - cut_h // 2).clamp(0, h),
                        (cy + cut_h // 2).clamp(0, h),
                        (cx - cut_w // 2).clamp(0, w),
                        (cx + cut_w // 2).clamp(0, w)], 1)


def draw_mix(gen: torch.Generator, n: int, h: int, w: int,
             cfg: MixupConfig, device) -> MixDraws:
    """This batch's draws per ``cfg.mode`` (batch: one draw for all)."""
    m = {"batch": 1, "elem": n, "pair": n // 2}[cfg.mode]
    apply = _rand(gen, (m,), device) < cfg.prob
    switch = _rand(gen, (m,), device) < cfg.switch_prob
    use_cutmix = switch | (cfg.mixup_alpha <= 0) if cfg.cutmix_enabled \
        else torch.zeros(m, dtype=torch.bool, device=device)
    ones = torch.ones(m, device=device)
    lam_mix = _beta(gen, cfg.mixup_alpha, (m,), device) \
        if cfg.mixup_alpha > 0 else ones
    lam_cut = _beta(gen, cfg.cutmix_alpha, (m,), device) \
        if cfg.cutmix_alpha > 0 else ones
    box = _boxes(gen, h, w, lam_cut, cfg)
    if cfg.mode == "batch":
        def full(v):
            return v.expand((n,) + v.shape[1:])
    elif cfg.mode == "pair":
        def full(v):
            pad = torch.zeros((n - 2 * m,) + v.shape[1:], dtype=v.dtype,
                              device=device)
            return torch.cat([v, pad, v.flip(0)], 0)
    else:
        def full(v):
            return v
    return MixDraws(full(apply), full(use_cutmix), full(lam_mix), full(box))


def mix_apply(images: torch.Tensor, labels: torch.Tensor, d: MixDraws,
              cfg: MixupConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mix (N, H, W, C) images with their flipped partners by the draws:
    mixup where not ``use_cutmix``, the partner's box pasted where it is,
    lam corrected to the box's area; unchanged where not ``apply``.
    Returns (mixed images, soft targets (N, num_classes))."""
    n, h, w, _ = images.shape
    dev = images.device
    flipped = images.flip(0)
    lamv = torch.where(d.use_cutmix, 1.0, d.lam_mix)[:, None, None, None]
    mixed_m = images * lamv + flipped * (1.0 - lamv)
    rows = torch.arange(h, device=dev)[None, :, None]
    cols = torch.arange(w, device=dev)[None, None, :]
    y1, y2, x1, x2 = (d.box[:, k, None, None] for k in range(4))
    in_box = ((rows >= y1) & (rows < y2) & (cols >= x1) & (cols < x2)
              & d.use_cutmix[:, None, None])
    mixed = torch.where(in_box[..., None], flipped, mixed_m)
    area = ((d.box[:, 1] - d.box[:, 0]) * (d.box[:, 3] - d.box[:, 2])).float()
    lam = torch.where(d.use_cutmix, 1.0 - area / (h * w), d.lam_mix)
    lam = torch.where(d.apply, lam, 1.0)
    mixed = torch.where(d.apply[:, None, None, None], mixed, images)
    targets = mixup_target(labels, cfg.num_classes, lam, cfg.label_smoothing)
    return mixed.to(images.dtype), targets


def mixup_cutmix(gen: torch.Generator, images: torch.Tensor,
                 labels: torch.Tensor, cfg: MixupConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixup / CutMix per ``cfg.mode``: images (N, H, W, C) float, labels
    (N,) int -> (mixed images, soft targets (N, num_classes))."""
    n, h, w, _ = images.shape
    return mix_apply(images, labels,
                     draw_mix(gen, n, h, w, cfg, images.device), cfg)
