"""Semantic-segmentation head: UperNet (PSP + FPN fuse) with an FCN
auxiliary head, port of ``slak_tpu/downstream/segmentation.py`` (the mmseg
decoder of the reference's ADE20K configs,
``segmentation/configs/upernet_slak_tiny_512_80k_ade20k_ss.py:24-45``:
UPerHead pool scales (1, 2, 3, 6), 512 channels, FCNHead on stage 2 with
loss weight 0.4).

NCHW throughout. The convolutions run in the features' dtype (the weights
rounded to it, as the JAX ``_conv`` does), with a bias and a ReLU but on
the two classifiers. Resizes follow ``jax.image.resize``: half-pixel
bilinear, which equals ``F.interpolate(align_corners=False)`` when it
enlarges; when it shrinks JAX antialiases, so :func:`_resize` takes
``antialias=True``'s weights there. A resize is two matrix products (one a
axis), so that its backward is deterministic. The PSP scales that divide
the map pool by block means; the others (3 and 6 on a 16^2 map, stage 4
of a 512^2 crop) through :func:`_adaptive_pool`.

The fuse output's dropout is per sample (a (N, 1, 1, 1) mask, as the JAX
head draws it): from ``generator``, or given as ``dropout_keep``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class UperNetConfig:
    in_channels: Tuple[int, ...] = (124, 249, 499, 998)  # dims * 1.3
    channels: int = 512
    pool_scales: Tuple[int, ...] = (1, 2, 3, 6)
    num_classes: int = 150
    aux_in_index: int = 2
    aux_channels: int = 256
    aux_loss_weight: float = 0.4
    dropout: float = 0.1


def _conv_module(kh, cin, cout) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kh, 1, kh // 2)


def _conv(x, conv: nn.Conv2d, relu: bool = True):
    y = F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                 padding=conv.padding)
    return F.relu(y) if relu else y


@functools.lru_cache(maxsize=64)
def _resize_matrix(n_in: int, n_out: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """(n_out, n_in): the half-pixel linear resize along one axis, the
    weights ``F.interpolate(align_corners=False)`` gives the basis vectors,
    antialiased where it shrinks."""
    # the basis images two columns wide: the antialiased resize of one
    # column wide images does not resize along H
    eye = torch.eye(n_in, dtype=torch.float64)[:, None, :, None].expand(
        n_in, 1, n_in, 2)
    m = F.interpolate(eye, (n_out, 2), mode="bilinear", align_corners=False,
                      antialias=n_out < n_in)[:, 0, :, 0]
    return m.t().to(dtype=dtype, device=device).contiguous()


def _resize(x, h: int, w: int):
    """Half-pixel bilinear resize of NCHW x to (h, w), antialiased along
    an axis it shrinks (``jax.image.resize(..., "bilinear")``): one
    product a axis with :func:`_resize_matrix`'s weights, whose backward
    (matrix products again) is deterministic, as an interpolation's
    scattered backward is not on the card."""
    if (h, w) == tuple(x.shape[2:]):
        return x
    ah = _resize_matrix(x.shape[2], h, x.dtype, x.device)
    aw = _resize_matrix(x.shape[3], w, x.dtype, x.device)
    return torch.matmul(torch.matmul(ah, x), aw.t())


def _adaptive_pool(x, scale: int):
    """The pool to (scale, scale) of a map ``scale`` does not divide: an
    antialiased linear resize, as ``jax.image.resize(..., "linear")``."""
    return _resize(x, scale, scale)


class UperNet(nn.Module):
    """The head's parameters under ``init_upernet``'s names; the forward is
    :func:`upernet_forward`."""

    def __init__(self, cfg: UperNetConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.channels
        cin = cfg.in_channels
        self.psp = nn.ModuleList(_conv_module(1, cin[-1], c)
                                 for _ in cfg.pool_scales)
        self.psp_bottleneck = _conv_module(
            3, cin[-1] + c * len(cfg.pool_scales), c)
        self.lateral = nn.ModuleList(_conv_module(1, ci, c)
                                     for ci in cin[:-1])
        self.fpn_out = nn.ModuleList(_conv_module(3, c, c)
                                     for _ in cin[:-1])
        self.fuse = _conv_module(3, c * len(cin), c)
        self.classifier = _conv_module(1, c, cfg.num_classes)
        self.aux_conv = _conv_module(3, cin[cfg.aux_in_index],
                                     cfg.aux_channels)
        self.aux_classifier = _conv_module(1, cfg.aux_channels,
                                           cfg.num_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """He-normal weights (std sqrt(2 / fan_in)), zero biases, as
        ``init_upernet``."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    fan = m.weight[0].numel()
                    m.weight.normal_(0.0, (2.0 / fan) ** 0.5,
                                     generator=generator)
                    m.bias.zero_()
        return self


def init_upernet(cfg: UperNetConfig, generator: Optional[torch.Generator]
                 = None, device=None) -> UperNet:
    head = UperNet(cfg).reset_parameters(generator)
    return head.to(device) if device is not None else head


def upernet_forward(head: UperNet, feats: Sequence[torch.Tensor], *,
                    train: bool = False,
                    generator: Optional[torch.Generator] = None,
                    dropout_keep: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """feats: the multi-scale NCHW stage features. Returns (main logits,
    aux logits) at stage 0's resolution. In train mode with a dropout
    rate the fuse output keeps each sample with probability 1 - rate:
    ``dropout_keep`` ((N,) bool) or a draw from ``generator``."""
    cfg = head.cfg
    x4 = feats[-1]
    h4, w4 = x4.shape[2], x4.shape[3]

    psp_outs: List[torch.Tensor] = [x4]
    for scale, conv in zip(cfg.pool_scales, head.psp):
        if h4 % scale == 0 and w4 % scale == 0:
            pooled = x4.reshape(x4.shape[0], x4.shape[1], scale, h4 // scale,
                                scale, w4 // scale).mean((3, 5))
        else:
            pooled = _adaptive_pool(x4, scale)
        psp_outs.append(_resize(_conv(pooled, conv), h4, w4))
    psp = _conv(torch.cat(psp_outs, 1), head.psp_bottleneck)

    laterals = [_conv(f, c) for f, c in zip(feats[:-1], head.lateral)]
    laterals.append(psp)
    for i in range(len(laterals) - 1, 0, -1):
        hi, wi = laterals[i - 1].shape[2:]
        laterals[i - 1] = laterals[i - 1] + _resize(laterals[i], hi, wi)
    outs = [_conv(laterals[i], head.fpn_out[i])
            for i in range(len(laterals) - 1)]
    outs.append(psp)

    h0, w0 = feats[0].shape[2], feats[0].shape[3]
    fused = _conv(torch.cat([_resize(o, h0, w0) for o in outs], 1),
                  head.fuse)
    if train and cfg.dropout > 0 and (generator is not None
                                      or dropout_keep is not None):
        keep_p = 1.0 - cfg.dropout
        if dropout_keep is None:
            dropout_keep = torch.rand((fused.shape[0],), generator=generator,
                                      device=generator.device) < keep_p
        mask = dropout_keep.to(fused.device).reshape(-1, 1, 1, 1)
        fused = torch.where(mask, fused / keep_p, torch.zeros_like(fused))
    logits = _conv(fused, head.classifier, relu=False)

    aux = _conv(feats[cfg.aux_in_index], head.aux_conv)
    aux_logits = _resize(_conv(aux, head.aux_classifier, relu=False), h0, w0)
    return logits, aux_logits


def seg_loss(logits, aux_logits, labels, cfg: UperNetConfig,
             ignore_index: int = 255) -> torch.Tensor:
    """Per-pixel cross entropy (+ aux_loss_weight x the aux head's), the
    logits resized to the labels' (N, H, W) and taken in fp32; pixels
    labelled ``ignore_index`` count for nothing."""
    h, w = labels.shape[1], labels.shape[2]
    valid = labels != ignore_index
    lab = torch.where(valid, labels, torch.zeros_like(labels)).long()
    n_valid = valid.sum().clamp(min=1)

    def ce(lg):
        lp = F.log_softmax(_resize(lg, h, w).float(), dim=1)
        nll = -lp.gather(1, lab[:, None])[:, 0]
        return (nll * valid).sum() / n_valid

    return ce(logits) + cfg.aux_loss_weight * ce(aux_logits)
