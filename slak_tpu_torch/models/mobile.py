"""Mobile-family KD teachers, MobileNetV3-Large and EfficientNet: port of
``slak_tpu/models/mobile.py`` under timm's names (``conv_stem``, ``bn1``;
``blocks.{s}.{i}``: an inverted residual ``{conv_pw, bn1, conv_dw, bn2,
se.conv_reduce, se.conv_expand, conv_pwl, bn3}`` where the block expands,
else a depthwise-separable ``{conv_dw, bn1, se.*, conv_pw, bn2}``;
``conv_head``, ``bn2`` (EfficientNet's head), ``classifier``).

The JAX model keeps one flat block list; the port groups it into stages,
a new stage where a block's output channels differ from the one before
(timm's stages for the three configurations here). Every conv pads as
XLA's ``"SAME"`` (``mobile.py:160-164``): an explicit ``F.pad`` by XLA's
rule (the low side total // 2, so (0, 1) for a 3x3 stride-2 conv of an
even map), then an unpadded conv; torch's ``padding=k // 2`` would pad
(1, 1) there. The SE variants and the head follow ``MobileConfig``
(``:79-104``). ``tf_efficientnet_b3_ns`` scales b0's widths only, as the
JAX function does (its ``repeat`` is always 1). The feature is the last
block's output, (N, H, W, C).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from slak_tpu_torch.models.resnet import same_pads
from slak_tpu_torch.models.zoo import Teacher, bn_eval, dense

NAMES = ("mobilenetv3_large_100", "efficientnet_b0", "tf_efficientnet_b3_ns")


def hard_swish(x):
    return x * F.relu6(x + 3.0) / 6.0


def hard_sigmoid(x):
    return F.relu6(x + 3.0) / 6.0


ACTS = {"relu": F.relu, "hswish": hard_swish, "swish": F.silu,
        "sigmoid": torch.sigmoid, "hard_sigmoid": hard_sigmoid}


def make_divisible(v: float, divisor: int = 8) -> int:
    """timm's make_divisible (round_limit 0.9)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


# block spec: (expand_ratio, cout, kernel, stride, se_ratio, act)
MOBILENETV3_LARGE = (
    (1, 16, 3, 1, 0.0, "relu"),
    (4, 24, 3, 2, 0.0, "relu"), (3, 24, 3, 1, 0.0, "relu"),
    (3, 40, 5, 2, 0.25, "relu"), (3, 40, 5, 1, 0.25, "relu"),
    (3, 40, 5, 1, 0.25, "relu"),
    (6, 80, 3, 2, 0.0, "hswish"), (2.5, 80, 3, 1, 0.0, "hswish"),
    (2.3, 80, 3, 1, 0.0, "hswish"), (2.3, 80, 3, 1, 0.0, "hswish"),
    (6, 112, 3, 1, 0.25, "hswish"), (6, 112, 3, 1, 0.25, "hswish"),
    (6, 160, 5, 2, 0.25, "hswish"), (6, 160, 5, 1, 0.25, "hswish"),
    (6, 160, 5, 1, 0.25, "hswish"),
)

EFFICIENTNET_B0 = (
    (1, 16, 3, 1, 0.25, "swish"),
    (6, 24, 3, 2, 0.25, "swish"), (6, 24, 3, 1, 0.25, "swish"),
    (6, 40, 5, 2, 0.25, "swish"), (6, 40, 5, 1, 0.25, "swish"),
    (6, 80, 3, 2, 0.25, "swish"), (6, 80, 3, 1, 0.25, "swish"),
    (6, 80, 3, 1, 0.25, "swish"),
    (6, 112, 5, 1, 0.25, "swish"), (6, 112, 5, 1, 0.25, "swish"),
    (6, 112, 5, 1, 0.25, "swish"),
    (6, 192, 5, 2, 0.25, "swish"), (6, 192, 5, 1, 0.25, "swish"),
    (6, 192, 5, 1, 0.25, "swish"), (6, 192, 5, 1, 0.25, "swish"),
    (6, 320, 3, 1, 0.25, "swish"),
)


@dataclasses.dataclass(frozen=True)
class MobileConfig:
    blocks: Tuple = MOBILENETV3_LARGE
    stem_ch: int = 16
    head_ch: int = 1280
    num_classes: int = 1000
    stem_act: str = "hswish"
    # EfficientNet: SE reduces from the block input's channels, divisor 1,
    # the block's act, a sigmoid gate; MobileNetV3: from the expanded
    # channels, divisor 8, ReLU, a hard-sigmoid gate
    se_from_block_in: bool = False
    se_divisor: int = 8
    se_act: str = "relu"            # 'relu' | 'block' (the block's act)
    se_gate: str = "hard_sigmoid"   # 'hard_sigmoid' | 'sigmoid'
    # MobileNetV3: pool, then a biased 1x1 conv and the act, no BN;
    # EfficientNet: conv, BN, act, then pool
    head_after_pool: bool = True

    def se_channels(self, cin: int, mid: int, se_ratio: float) -> int:
        base = cin if self.se_from_block_in else mid
        return make_divisible(base * se_ratio, self.se_divisor)


def conv_same(x: torch.Tensor, c: nn.Conv2d, stride: int = 1,
              groups: int = 1) -> torch.Tensor:
    """Bias-free conv in x's dtype with XLA's "SAME" padding."""
    kh, kw = c.weight.shape[-2:]
    ph = same_pads(x.shape[2], kh, stride)
    pw = same_pads(x.shape[3], kw, stride)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, c.weight.to(x.dtype), None, stride, 0, 1, groups)


def conv_bias(x: torch.Tensor, c: nn.Conv2d) -> torch.Tensor:
    """``_conv(x, p) + p["b"]``: the 1x1 conv in x's dtype, then the
    float32 bias (promoting a bf16 product to float32)."""
    return conv_same(x, c) + c.bias[:, None, None]


class _SE(nn.Module):
    def __init__(self, c: int, rd: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(c, rd, 1)
        self.conv_expand = nn.Conv2d(rd, c, 1)


def _block(cfg: MobileConfig, cin: int, spec) -> nn.Module:
    exp, cout, k, stride, se, _ = spec
    mid = int(round(cin * exp))
    b = nn.Module()
    if mid != cin:
        b.conv_pw = nn.Conv2d(cin, mid, 1, bias=False)
        b.bn1 = nn.BatchNorm2d(mid)
        b.conv_dw = nn.Conv2d(mid, mid, k, stride, groups=mid, bias=False)
        b.bn2 = nn.BatchNorm2d(mid)
    else:
        b.conv_dw = nn.Conv2d(mid, mid, k, stride, groups=mid, bias=False)
        b.bn1 = nn.BatchNorm2d(mid)
    if se > 0:
        b.se = _SE(mid, cfg.se_channels(cin, mid, se))
    if mid != cin:
        b.conv_pwl = nn.Conv2d(mid, cout, 1, bias=False)
        b.bn3 = nn.BatchNorm2d(cout)
    else:
        b.conv_pw = nn.Conv2d(mid, cout, 1, bias=False)
        b.bn2 = nn.BatchNorm2d(cout)
    return b


def stage_groups(blocks) -> List[int]:
    """Stage lengths: a new stage where the output channels change."""
    out: List[int] = []
    prev = None
    for spec in blocks:
        if spec[1] != prev:
            out.append(0)
            prev = spec[1]
        out[-1] += 1
    return out


class MobileNet(Teacher):
    def __init__(self, cfg: MobileConfig):
        super().__init__()
        self.cfg = cfg
        self.conv_stem = nn.Conv2d(3, cfg.stem_ch, 3, 2, bias=False)
        self.bn1 = nn.BatchNorm2d(cfg.stem_ch)
        cin, i = cfg.stem_ch, 0
        stages = []
        for n in stage_groups(cfg.blocks):
            blocks = []
            for spec in cfg.blocks[i:i + n]:
                blocks.append(_block(cfg, cin, spec))
                cin = spec[1]
            stages.append(nn.ModuleList(blocks))
            i += n
        self.blocks = nn.ModuleList(stages)
        self.conv_head = nn.Conv2d(cin, cfg.head_ch, 1,
                                   bias=cfg.head_after_pool)
        if not cfg.head_after_pool:
            self.bn2 = nn.BatchNorm2d(cfg.head_ch)
        self.classifier = nn.Linear(cfg.head_ch, cfg.num_classes)

    @property
    def feature_channels(self) -> int:
        return self.cfg.blocks[-1][1]

    def flat_blocks(self):
        return [b for stage in self.blocks for b in stage]

    def forward(self, x):
        """(N, H, W, 3) -> (logits, last block's feature (N, h, w, C))."""
        cfg = self.cfg
        act0 = ACTS[cfg.stem_act]
        x = x.permute(0, 3, 1, 2)
        x = act0(bn_eval(conv_same(x, self.conv_stem, 2), self.bn1))
        for spec, b in zip(cfg.blocks, self.flat_blocks()):
            stride, act = spec[3], ACTS[spec[5]]
            shortcut = y = x
            expands = hasattr(b, "conv_pwl")
            if expands:
                y = act(bn_eval(conv_same(y, b.conv_pw), b.bn1))
            y = act(bn_eval(conv_same(y, b.conv_dw, stride, y.shape[1]),
                            b.bn2 if expands else b.bn1))
            if hasattr(b, "se"):
                se_act = act if cfg.se_act == "block" else ACTS[cfg.se_act]
                s = y.mean((2, 3), keepdim=True)
                s = se_act(conv_bias(s, b.se.conv_reduce))
                s = conv_bias(s, b.se.conv_expand)
                y = y * ACTS[cfg.se_gate](s).to(y.dtype)
            if expands:
                y = bn_eval(conv_same(y, b.conv_pwl), b.bn3)
            else:
                y = bn_eval(conv_same(y, b.conv_pw), b.bn2)
            if stride == 1 and shortcut.shape[1] == y.shape[1]:
                y = y + shortcut
            x = y
        feature = x.permute(0, 2, 3, 1)
        if cfg.head_after_pool:
            x = x.mean((2, 3), keepdim=True)
            pooled = act0(conv_bias(x, self.conv_head))[:, :, 0, 0]
        else:
            x = act0(bn_eval(conv_same(x, self.conv_head), self.bn2))
            pooled = x.mean((2, 3))
        logits = dense(pooled, self.classifier).float()
        return logits, feature


def mobilenetv3_large_100(**kw) -> MobileNet:
    return MobileNet(MobileConfig(**kw))


def _effnet_kw(kw):
    kw.setdefault("se_from_block_in", True)
    kw.setdefault("se_divisor", 1)
    kw.setdefault("se_act", "block")
    kw.setdefault("se_gate", "sigmoid")
    kw.setdefault("head_after_pool", False)
    kw.setdefault("stem_act", "swish")
    return kw


def efficientnet_b0(**kw) -> MobileNet:
    kw.setdefault("blocks", EFFICIENTNET_B0)
    kw.setdefault("stem_ch", 32)
    return MobileNet(MobileConfig(**_effnet_kw(kw)))


def tf_efficientnet_b3_ns(**kw) -> MobileNet:
    """b0 with its widths scaled by 1.2 (timm's channel rounding); the
    depths stay b0's, as in the JAX function."""
    def rnd(c):
        c = c * 1.2
        new = max(8, int(c + 4) // 8 * 8)
        if new < 0.9 * c:
            new += 8
        return new

    kw.setdefault("blocks", tuple((e, rnd(c), k, s, se, a)
                                  for e, c, k, s, se, a in EFFICIENTNET_B0))
    kw.setdefault("stem_ch", 40)
    kw.setdefault("head_ch", 1536)
    return MobileNet(MobileConfig(**_effnet_kw(kw)))
