"""ResNet-D KD teacher (``resnet50d``, ``resnet26d``): port of
``slak_tpu/models/resnet.py`` under timm's names (the deep stem
``conv1.{0,1,3,4,6}`` and ``bn1``; ``layer{i}.{j}.{conv1, bn1, conv2, bn2,
conv3, bn3, downsample.{1,2}}``; ``fc``).

Eval BN with the running statistics. Convs pad k // 2 on each side
(``resnet.py:93-101``); the max pool pads 1 on each side (``:116-118``).
The ResNet-D shortcut's average pool is XLA's ``"SAME"`` window sum
divided by st^2 (``:131-136``), reproduced as an explicit zero pad by
XLA's rule (the low side total // 2) and an average over the full window:
on an odd map the edge windows count the padding, where torch's
``AvgPool2d(ceil_mode=True, count_include_pad=False)`` would not. The
feature is the last stage's output, (N, H, W, C).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from slak_tpu_torch.models.zoo import Teacher, bn_eval, dense

NAMES = ("resnet50d", "resnet26d")
STEM_STRIDES = (2, 1, 1)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    layers: Tuple[int, ...] = (3, 4, 6, 3)   # resnet50
    width: int = 64
    num_classes: int = 1000
    expansion: int = 4


def conv(x: torch.Tensor, c: nn.Conv2d, stride: int = 1) -> torch.Tensor:
    """Bias-free conv in x's dtype, k // 2 padding on each side."""
    kh, kw = c.weight.shape[-2:]
    return F.conv2d(x, c.weight.to(x.dtype), None, stride, (kh // 2, kw // 2))


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA "SAME" padding (low, high) of one axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def avg_pool_same(x: torch.Tensor, st: int) -> torch.Tensor:
    """``reduce_window(add, (st, st), "SAME") / st^2`` on NCHW."""
    ph, pw = same_pads(x.shape[2], st, st), same_pads(x.shape[3], st, st)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.avg_pool2d(x, st, st)


class _Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, expansion: int,
                 downsample: bool):
        super().__init__()
        cout = planes * expansion
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        if downsample:
            self.downsample = nn.Sequential(
                nn.Identity(), nn.Conv2d(cin, cout, 1, bias=False),
                nn.BatchNorm2d(cout))

    def forward(self, x, st: int):
        y = F.relu(bn_eval(conv(x, self.conv1), self.bn1))
        y = F.relu(bn_eval(conv(y, self.conv2, st), self.bn2))
        y = bn_eval(conv(y, self.conv3), self.bn3)
        sc = x
        if hasattr(self, "downsample"):
            if st > 1:
                sc = avg_pool_same(sc, st)
            sc = bn_eval(conv(sc, self.downsample[1]), self.downsample[2])
        return F.relu(sc + y)


class ResNet(Teacher):
    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.conv1 = nn.Sequential(
            nn.Conv2d(3, w // 2, 3, 2, 1, bias=False), nn.BatchNorm2d(w // 2),
            nn.ReLU(), nn.Conv2d(w // 2, w // 2, 3, 1, 1, bias=False),
            nn.BatchNorm2d(w // 2), nn.ReLU(),
            nn.Conv2d(w // 2, w, 3, 1, 1, bias=False))
        self.bn1 = nn.BatchNorm2d(w)
        cin = w
        for i, depth in enumerate(cfg.layers):
            planes = w * 2 ** i
            blocks = []
            for j in range(depth):
                blocks.append(_Bottleneck(cin, planes, cfg.expansion, j == 0))
                cin = planes * cfg.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(cin, cfg.num_classes)

    @property
    def feature_channels(self) -> int:
        return self.cfg.width * 8 * self.cfg.expansion

    def forward(self, x):
        """(N, H, W, 3) -> (logits, last stage's feature (N, h, w, C))."""
        x = x.permute(0, 3, 1, 2)
        stem = self.conv1
        for c, bn, st in zip((stem[0], stem[3], stem[6]),
                             (stem[1], stem[4], self.bn1), STEM_STRIDES):
            x = F.relu(bn_eval(conv(x, c, st), bn))
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(4):
            for j, blk in enumerate(getattr(self, f"layer{i + 1}")):
                x = blk(x, (1 if i == 0 else 2) if j == 0 else 1)
        feature = x.permute(0, 2, 3, 1)
        logits = dense(x.mean((2, 3)), self.fc).float()
        return logits, feature


def resnet50d(**kw) -> ResNet:
    return ResNet(ResNetConfig(**kw))


def resnet26d(**kw) -> ResNet:
    kw.setdefault("layers", (2, 2, 2, 2))
    return ResNet(ResNetConfig(**kw))
