"""Cascade Mask R-CNN on the SLaK backbone: port of
``slak_tpu/downstream/detection.py`` (the reference's mmdet stack,
``detection/configs/_base_/models/cascade_mask_rcnn_slak_fpn.py`` with the
SLaK override ``cascade_mask_rcnn_slak_tiny_..._3x_coco_in1k.py:15-27,
135-141``).

Components, NCHW, in the features' dtype:
  * FPN neck: lateral 1x1 + top-down nearest 2x (repeat + crop) + 3x3
    smoothing, P6 = every other pixel of P5 (the stride-2 window-1 max
    pool).
  * RPN head: shared 3x3 conv + ReLU, sigmoid class logit and 4 deltas
    for each of 3 anchors (scale 8, ratios 0.5 / 1 / 2, strides 4-64).
  * MaxIoU assigner and random sampler as masks (the JAX package's fixed
    shapes); the sampler's uniforms come from a ``torch.Generator`` or
    are given (``draws``), so a test can feed the JAX package's.
  * RoIAlign in torch (no torchvision): aligned bilinear (offset -0.5),
    a fixed 2 x 2 sample grid a bin. A RoI is aligned on its mapped FPN
    level only; the JAX package aligns it on every level and keeps its
    level's by a 0 / 1 weight, which gives the same numbers.
  * 3-stage cascade of 4conv1fc box heads with train-mode BatchNorm
    (``ops/batchnorm.py``; the running stats update in the modules'
    buffers), GIoU x 10 on decoded boxes, class-specific regression,
    per-stage target stds, IoU thresholds (.5 / .6 / .7) and stage
    weights (1 / .5 / .25).
  * FCN mask head: convs + 2x transposed conv + per-class logits, BCE on
    28 x 28 RoI-aligned targets at every stage. The transposed conv is
    ``F.conv_transpose2d`` with mmdet's weight layout (in, out, kh, kw);
    ``lax.conv_transpose`` of an HWIO kernel does not flip it, so
    ``utils/convert.cascade_from_jax`` flips the JAX kernel.
  * Greedy NMS over a precomputed ``iou > thr`` matrix, a torch loop over
    the boxes in score order.

Sorts are stable, as ``jnp.argsort``; the RPN's top-k is a stable
descending sort, so equal scores keep the lower index first, as
``lax.top_k``. Flattened RoI features are (C, h, w)-major (the port's box
heads' ``fc`` takes them so; the converter reorders the JAX (h, w, C)
rows).

Training entry: :func:`cascade_loss`; inference: :func:`cascade_predict`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from slak_tpu_torch.models.layers import trunc_normal_
from slak_tpu_torch.ops.batchnorm import batch_norm, batch_norm_train

EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class DetHeadConfig:
    """Cascade R-CNN head hyper-parameters (reference config values)."""
    in_channels: Tuple[int, ...] = (124, 249, 499, 998)
    fpn_channels: int = 256
    num_classes: int = 80
    anchor_scales: Tuple[int, ...] = (8,)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    strides: Tuple[int, ...] = (4, 8, 16, 32, 64)
    stage_stds: Tuple[Tuple[float, ...], ...] = (
        (0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1),
        (0.033, 0.033, 0.067, 0.067))
    stage_iou_thr: Tuple[float, ...] = (0.5, 0.6, 0.7)
    stage_loss_weights: Tuple[float, ...] = (1.0, 0.5, 0.25)
    num_shared_convs: int = 4         # ConvFCBBoxHead 4conv1fc
    fc_out: int = 1024
    roi_size: int = 7
    mask_roi_size: int = 14
    mask_size: int = 28
    mask_convs: int = 4
    rpn_sample: int = 256
    rpn_pos_fraction: float = 0.5
    rcnn_sample: int = 512
    rcnn_pos_fraction: float = 0.25
    num_proposals: int = 512          # post-NMS proposals kept
    rpn_nms_iou: float = 0.7
    finest_scale: int = 56            # SingleRoIExtractor level mapping
    giou_weight: float = 10.0
    rpn_smoothl1_beta: float = 1.0 / 9.0


# ---------------------------------------------------------------------------
# box utilities
# ---------------------------------------------------------------------------


def box_area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]).clamp(min=0) * \
        (b[..., 3] - b[..., 1]).clamp(min=0)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (..., Na, 4), b: (..., Nb, 4) -> (..., Na, Nb)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / union.clamp(min=EPS)


def box_giou_pairwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matched pairs: a, b (..., 4) -> GIoU (...)."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a) + box_area(b) - inter
    iou = inter / union.clamp(min=EPS)
    elt = torch.minimum(a[..., :2], b[..., :2])
    erb = torch.maximum(a[..., 2:], b[..., 2:])
    ewh = (erb - elt).clamp(min=0)
    enc = ewh[..., 0] * ewh[..., 1]
    return iou - (enc - union) / enc.clamp(min=EPS)


def _stds(stds, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(stds, dtype=like.dtype, device=like.device)


def delta_encode(rois: torch.Tensor, gts: torch.Tensor,
                 stds: Sequence[float]) -> torch.Tensor:
    """DeltaXYWHBBoxCoder.encode (means 0)."""
    pw = (rois[..., 2] - rois[..., 0]).clamp(min=EPS)
    ph = (rois[..., 3] - rois[..., 1]).clamp(min=EPS)
    px = (rois[..., 0] + rois[..., 2]) * 0.5
    py = (rois[..., 1] + rois[..., 3]) * 0.5
    gw = (gts[..., 2] - gts[..., 0]).clamp(min=EPS)
    gh = (gts[..., 3] - gts[..., 1]).clamp(min=EPS)
    gx = (gts[..., 0] + gts[..., 2]) * 0.5
    gy = (gts[..., 1] + gts[..., 3]) * 0.5
    d = torch.stack([(gx - px) / pw, (gy - py) / ph,
                     torch.log(gw / pw), torch.log(gh / ph)], -1)
    return d / _stds(stds, d)


def delta_decode(rois: torch.Tensor, deltas: torch.Tensor,
                 stds: Sequence[float],
                 max_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """DeltaXYWHBBoxCoder.decode (wh ratio clipped at 16/1000), boxes
    clipped to ``max_hw`` when given."""
    d = deltas * _stds(stds, deltas)
    max_ratio = abs(math.log(16.0 / 1000.0))
    dw = d[..., 2].clamp(-max_ratio, max_ratio)
    dh = d[..., 3].clamp(-max_ratio, max_ratio)
    pw = rois[..., 2] - rois[..., 0]
    ph = rois[..., 3] - rois[..., 1]
    px = (rois[..., 0] + rois[..., 2]) * 0.5
    py = (rois[..., 1] + rois[..., 3]) * 0.5
    gx = px + pw * d[..., 0]
    gy = py + ph * d[..., 1]
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    out = torch.stack([gx - gw * 0.5, gy - gh * 0.5,
                       gx + gw * 0.5, gy + gh * 0.5], -1)
    if max_hw is not None:
        h, w = max_hw
        out = torch.stack([out[..., 0].clamp(0, w), out[..., 1].clamp(0, h),
                           out[..., 2].clamp(0, w), out[..., 3].clamp(0, h)],
                          -1)
    return out


def make_anchors(feat_hw: Sequence[Tuple[int, int]], cfg: DetHeadConfig,
                 device=None) -> List[torch.Tensor]:
    """Per-level anchors (Hi * Wi * A, 4) in (row, column, anchor) order,
    centred at (x + 0.5) * stride."""
    out = []
    for (h, w), stride in zip(feat_hw, cfg.strides):
        base = []
        for r in cfg.anchor_ratios:
            for s in cfg.anchor_scales:
                bw = stride * s / (r ** 0.5)
                bh = stride * s * (r ** 0.5)
                base.append([-bw / 2, -bh / 2, bw / 2, bh / 2])
        base = torch.tensor(base, dtype=torch.float32, device=device)
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) \
            * stride
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) \
            * stride
        cy, cx = torch.meshgrid(ys, xs, indexing="ij")
        ctr = torch.stack([cx, cy, cx, cy], -1).reshape(-1, 1, 4)
        out.append((ctr + base[None]).reshape(-1, 4))
    return out


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float,
              k_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS; ``boxes`` (K, 4) sorted by descending score already
    (scores -inf mark boxes that take no part). Returns (keep_idx (k_out,),
    valid (k_out,)): the kept boxes' indices first, in score order. A
    torch loop over the K boxes, each suppressing the later boxes it
    overlaps above ``iou_thr`` unless an earlier one suppressed it."""
    k = boxes.shape[0]
    live = scores > -math.inf
    over = torch.triu(box_iou(boxes, boxes) > iou_thr, diagonal=1) \
        & live[:, None]
    supp = torch.zeros(k, dtype=torch.bool, device=boxes.device)
    for i in range(k):
        supp |= over[i] & ~supp[i]
    keep = ~supp & live
    ar = torch.arange(k, device=boxes.device)
    pos = torch.where(keep, ar, torch.full_like(ar, k))
    order = torch.argsort(pos, stable=True)[:k_out]
    return order, keep[order]


# ---------------------------------------------------------------------------
# RoIAlign
# ---------------------------------------------------------------------------


def roi_align(feat: torch.Tensor, rois: torch.Tensor, out_size: int,
              stride: int, samples: int = 2) -> torch.Tensor:
    """Aligned bilinear RoIAlign on one level. feat: (N, C, H, W); rois:
    (R, 5) as (batch index, x1, y1, x2, y2) in image coordinates. Returns
    (R, C, out_size, out_size): the mean of samples x samples points a
    bin; a point outside (-1, H) x (-1, W) reads 0, the corners' indices
    are clamped to the map."""
    n, c, h, w = feat.shape
    r = rois.shape[0]
    bidx = rois[:, 0].long()
    b = rois[:, 1:] / float(stride)
    bw = (b[:, 2] - b[:, 0]).clamp(min=EPS)
    bh = (b[:, 3] - b[:, 1]).clamp(min=EPS)
    g = out_size * samples
    ar = torch.arange(g, dtype=b.dtype, device=b.device) + 0.5
    fx = b[:, 0, None] + ar[None] * (bw[:, None] / g) - 0.5
    fy = b[:, 1, None] + ar[None] * (bh[:, None] / g) - 0.5
    y0, x0 = torch.floor(fy), torch.floor(fx)
    wy = (fy - y0)[:, :, None, None]                   # (R, g, 1, 1)
    wx = (fx - x0)[:, None, :, None]                   # (R, 1, g, 1)
    ok = (((fy > -1) & (fy < h))[:, :, None]
          & ((fx > -1) & (fx < w))[:, None, :])[..., None]
    y0i = y0.long().clamp(0, h - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    x0i = x0.long().clamp(0, w - 1)
    x1i = (x0i + 1).clamp(0, w - 1)
    flat = feat.permute(0, 2, 3, 1).reshape(n * h * w, c)
    base = (bidx * (h * w))[:, None, None]

    def corner(yi, xi):
        idx = base + yi[:, :, None] * w + xi[:, None, :]
        return flat[idx.reshape(-1)].reshape(r, g, g, c)

    val = corner(y0i, x0i) * (1 - wy) * (1 - wx)
    val = val + corner(y0i, x1i) * (1 - wy) * wx
    val = val + corner(y1i, x0i) * wy * (1 - wx)
    val = val + corner(y1i, x1i) * wy * wx
    val = torch.where(ok, val, torch.zeros((), dtype=val.dtype,
                                           device=val.device))
    val = val.reshape(r, out_size, samples, out_size, samples, c)
    return val.mean((2, 4)).permute(0, 3, 1, 2)


def map_roi_levels(rois: torch.Tensor, num_levels: int,
                   finest: int) -> torch.Tensor:
    """SingleRoIExtractor level mapping: floor(log2(sqrt(area) / finest))
    clamped to the levels."""
    scale = torch.sqrt(box_area(rois[:, 1:]).clamp(min=EPS))
    lvl = torch.floor(torch.log2(scale / finest + EPS))
    return lvl.clamp(0, num_levels - 1).long()


def extract_roi_features(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                         out_size: int, cfg: DetHeadConfig) -> torch.Tensor:
    """Multi-level RoIAlign: each RoI aligned on its mapped level only."""
    lvls = map_roi_levels(rois, len(feats), cfg.finest_scale)
    f0 = feats[0]
    out = torch.zeros((rois.shape[0], f0.shape[1], out_size, out_size),
                      dtype=f0.dtype, device=f0.device)
    for i, f in enumerate(feats):
        idx = torch.nonzero(lvls == i).reshape(-1)
        if idx.numel():
            out = out.index_copy(0, idx, roi_align(f, rois[idx], out_size,
                                                   cfg.strides[i]))
    return out


# ---------------------------------------------------------------------------
# modules and parameter init
# ---------------------------------------------------------------------------


def _conv_module(k: int, cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, 1, k // 2)


class FPN(nn.Module):
    def __init__(self, cfg: DetHeadConfig):
        super().__init__()
        fc = cfg.fpn_channels
        self.lateral = nn.ModuleList(_conv_module(1, c, fc)
                                     for c in cfg.in_channels)
        self.out = nn.ModuleList(_conv_module(3, fc, fc)
                                 for _ in cfg.in_channels)


class RPNHead(nn.Module):
    def __init__(self, cfg: DetHeadConfig):
        super().__init__()
        fc, a = cfg.fpn_channels, len(cfg.anchor_ratios)
        self.conv = _conv_module(3, fc, fc)
        self.cls = _conv_module(1, fc, a)
        self.reg = _conv_module(1, fc, 4 * a)


class BBoxHead(nn.Module):
    """ConvFCBBoxHead 4conv1fc with BN after each conv."""

    def __init__(self, cfg: DetHeadConfig):
        super().__init__()
        fc = cfg.fpn_channels
        self.convs = nn.ModuleList(_conv_module(3, fc, fc)
                                   for _ in range(cfg.num_shared_convs))
        self.bn = nn.ModuleList(nn.BatchNorm2d(fc)
                                for _ in range(cfg.num_shared_convs))
        self.fc = nn.Linear(fc * cfg.roi_size * cfg.roi_size, cfg.fc_out)
        self.cls = nn.Linear(cfg.fc_out, cfg.num_classes + 1)
        self.reg = nn.Linear(cfg.fc_out, 4 * cfg.num_classes)


class MaskHead(nn.Module):
    """FCNMaskHead: convs, a 2x2 stride-2 transposed conv, class logits."""

    def __init__(self, cfg: DetHeadConfig):
        super().__init__()
        fc = cfg.fpn_channels
        self.convs = nn.ModuleList(_conv_module(3, fc, fc)
                                   for _ in range(cfg.mask_convs))
        self.deconv = nn.ConvTranspose2d(fc, fc, 2, 2)
        self.logits = _conv_module(1, fc, cfg.num_classes)


class CascadeHead(nn.Module):
    """Neck, RPN, the cascade's box heads and the mask head, under
    ``init_cascade``'s names."""

    def __init__(self, cfg: DetHeadConfig):
        super().__init__()
        self.cfg = cfg
        self.fpn = FPN(cfg)
        self.rpn = RPNHead(cfg)
        self.stages = nn.ModuleList(BBoxHead(cfg) for _ in cfg.stage_stds)
        self.mask = MaskHead(cfg)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Truncated-normal weights (std 0.01; the box regressors 0.001),
        zero biases, unit BN with unit running variance, as
        ``init_cascade``."""
        with torch.no_grad():
            for name, m in self.named_modules():
                if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d,
                                  nn.Linear)):
                    std = 0.001 if name.endswith(".reg") and isinstance(
                        m, nn.Linear) else 0.01
                    trunc_normal_(m.weight, std, generator)
                    m.bias.zero_()
                elif isinstance(m, nn.BatchNorm2d):
                    m.reset_parameters()
        return self


def init_cascade(cfg: DetHeadConfig, generator: Optional[torch.Generator]
                 = None, device=None) -> CascadeHead:
    head = CascadeHead(cfg).reset_parameters(generator)
    return head.to(device) if device is not None else head


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------


def _conv(x, conv: nn.Conv2d):
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                    padding=conv.padding)


def fpn_forward(fpn: FPN, feats: Sequence[torch.Tensor],
                cfg: DetHeadConfig) -> List[torch.Tensor]:
    """4 backbone stages -> P2..P6 at cfg.fpn_channels."""
    lat = [_conv(f, c) for f, c in zip(feats, fpn.lateral)]
    for i in range(len(lat) - 1, 0, -1):
        h, w = lat[i - 1].shape[2:]
        up = lat[i].repeat_interleave(2, 2).repeat_interleave(2, 3)
        lat[i - 1] = lat[i - 1] + up[:, :, :h, :w]
    outs = [_conv(x, c) for x, c in zip(lat, fpn.out)]
    outs.append(outs[-1][:, :, ::2, ::2])
    return outs


def rpn_forward(rpn: RPNHead, feats: Sequence[torch.Tensor]):
    """Shared RPN tower over the levels -> (cls (N, sum HWA), reg (N,
    sum HWA, 4)), in make_anchors' order."""
    cls_all, reg_all = [], []
    for f in feats:
        h = F.relu(_conv(f, rpn.conv))
        c = _conv(h, rpn.cls).permute(0, 2, 3, 1)
        r = _conv(h, rpn.reg).permute(0, 2, 3, 1)
        n = c.shape[0]
        cls_all.append(c.reshape(n, -1))
        reg_all.append(r.reshape(n, -1, 4))
    return torch.cat(cls_all, 1), torch.cat(reg_all, 1)


def bbox_head_forward(head: BBoxHead, roi_feat: torch.Tensor, train: bool,
                      cfg: DetHeadConfig):
    """ConvFCBBoxHead (4 conv + 1 fc): (cls logits (R, nc + 1), deltas
    (R, nc, 4)); train-mode BN updates its running stats in place."""
    y = roi_feat
    for conv, bn in zip(head.convs, head.bn):
        y = _conv(y, conv)
        if train:
            y = batch_norm_train(y, bn.weight, bn.bias, bn.running_mean,
                                 bn.running_var)
        else:
            y = batch_norm(y, bn.weight, bn.bias, bn.running_mean,
                           bn.running_var)
        y = F.relu(y)
    y = y.reshape(y.shape[0], -1)
    y = F.relu(F.linear(y, head.fc.weight.to(y.dtype)) + head.fc.bias)
    cls = F.linear(y, head.cls.weight.to(y.dtype)) + head.cls.bias
    reg = F.linear(y, head.reg.weight.to(y.dtype)) + head.reg.bias
    return cls, reg.reshape(-1, cfg.num_classes, 4)


def mask_head_forward(mask: MaskHead, roi_feat: torch.Tensor) -> torch.Tensor:
    """FCNMaskHead: (R, C, 14, 14) -> (R, num_classes, 28, 28) logits."""
    y = roi_feat
    for conv in mask.convs:
        y = F.relu(_conv(y, conv))
    y = F.conv_transpose2d(y, mask.deconv.weight.to(y.dtype), None, 2)
    y = F.relu(y + mask.deconv.bias.to(y.dtype)[:, None, None])
    return _conv(y, mask.logits)


# ---------------------------------------------------------------------------
# assignment + sampling (MaxIoUAssigner / RandomSampler as masks)
# ---------------------------------------------------------------------------


def assign_max_iou(boxes: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_valid: torch.Tensor, pos_thr: float, neg_thr: float,
                   match_low_quality: bool, min_pos_iou: float):
    """Returns (pos (B,), neg (B,), matched_gt (B,) int64)."""
    iou = box_iou(boxes, gt_boxes) * gt_valid[None, :]
    best = iou.amax(1)
    arg = iou.argmax(1)
    pos = best >= pos_thr
    neg = best < neg_thr
    if match_low_quality:
        gt_best = iou.amax(0)
        is_gt_best = (iou == gt_best[None, :]) & (iou >= min_pos_iou) \
            & gt_valid[None, :].bool()
        lq = is_gt_best.any(1)
        arg = torch.where(lq & ~pos, is_gt_best.to(torch.uint8).argmax(1),
                          arg)
        pos = pos | lq
        neg = neg & ~pos
    return pos, neg & ~pos, arg


def _ranks(x: torch.Tensor) -> torch.Tensor:
    return torch.argsort(torch.argsort(x, stable=True), stable=True)


def random_sample(pos: torch.Tensor, neg: torch.Tensor, num: int,
                  pos_fraction: float,
                  generator: Optional[torch.Generator] = None,
                  uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]]
                  = None):
    """RandomSampler as masks: (pos_sel, neg_sel), at most ``num`` in all
    and ``num * pos_fraction`` positives, each picked by the rank of its
    uniform among its kind. ``uniforms`` (u_pos, u_neg), each the shape
    of ``pos``, or two draws from ``generator``. Returns the masks and the
    uniforms."""
    if uniforms is None:
        uniforms = tuple(torch.rand(pos.shape, generator=generator,
                                    device=generator.device).to(pos.device)
                         for _ in range(2))
    r1, r2 = uniforms
    max_pos = int(num * pos_fraction)
    two = torch.full_like(r1, 2.0)
    pos_sel = pos & (_ranks(torch.where(pos, r1, two)) < max_pos)
    n_pos = pos_sel.sum()
    neg_sel = neg & (_ranks(torch.where(neg, r2, two)) < num - n_pos)
    return pos_sel, neg_sel, uniforms


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _smooth_l1(x: torch.Tensor, beta: float) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def _bce_logits(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))


def rpn_loss(cls: torch.Tensor, reg: torch.Tensor, anchors: torch.Tensor,
             gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
             cfg: DetHeadConfig, generator=None, uniforms=None):
    """One image's RPN loss (BCE + SmoothL1 beta 1/9): (cls loss, reg
    loss, the sampler's uniforms)."""
    pos, neg, arg = assign_max_iou(anchors, gt_boxes, gt_valid, pos_thr=0.7,
                                   neg_thr=0.3, match_low_quality=True,
                                   min_pos_iou=0.3)
    pos_s, neg_s, u = random_sample(pos, neg, cfg.rpn_sample,
                                    cfg.rpn_pos_fraction, generator,
                                    uniforms)
    sampled = (pos_s | neg_s).float()
    n = sampled.sum().clamp(min=1.0)
    loss_cls = (_bce_logits(cls, pos_s.float()) * sampled).sum() / n
    target = delta_encode(anchors, gt_boxes[arg], (1.0, 1.0, 1.0, 1.0))
    l1 = _smooth_l1(reg - target, cfg.rpn_smoothl1_beta).sum(-1)
    loss_reg = (l1 * pos_s).sum() / n
    return loss_cls, loss_reg, u


def _softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(logits, -1) - logits.gather(1, labels[:, None])[:,
                                                                           0]


# ---------------------------------------------------------------------------
# proposals
# ---------------------------------------------------------------------------


def rpn_proposals(cls: torch.Tensor, reg: torch.Tensor,
                  anchors: torch.Tensor, img_hw: Tuple[int, int],
                  cfg: DetHeadConfig) -> torch.Tensor:
    """One image: top-k, decode, NMS -> (num_proposals, 4); empty slots
    repeat the best box (fixed shape)."""
    k_pre = min(cls.shape[0], 2 * cfg.num_proposals)
    score, idx = torch.sort(cls, descending=True, stable=True)
    score, idx = score[:k_pre], idx[:k_pre]
    boxes = delta_decode(anchors[idx], reg[idx], (1, 1, 1, 1), img_hw)
    keep, valid = nms_fixed(boxes, score, cfg.rpn_nms_iou, cfg.num_proposals)
    out = boxes[keep]
    return torch.where(valid[:, None], out, out[0])


def _rois(boxes: torch.Tensor) -> torch.Tensor:
    """(N, B, 4) boxes -> (N * B, 5) rois with the image index first."""
    n, b = boxes.shape[:2]
    bidx = torch.arange(n, dtype=boxes.dtype, device=boxes.device)
    return torch.cat([bidx[:, None].expand(n, b).reshape(-1, 1),
                      boxes.reshape(-1, 4)], 1)


# ---------------------------------------------------------------------------
# full training loss
# ---------------------------------------------------------------------------


def cascade_loss(head: CascadeHead, feats: Sequence[torch.Tensor],
                 gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                 gt_valid: torch.Tensor, gt_masks: torch.Tensor,
                 img_hw: Tuple[int, int], cfg: DetHeadConfig,
                 train: bool = True,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Dict[str, List]] = None,
                 proposals=None):
    """End-to-end Cascade Mask R-CNN loss.

    feats: the 4 NCHW backbone stage outputs. gt_boxes (N, G, 4) xyxy,
    gt_labels (N, G) in [0, num_classes), gt_valid (N, G) {0, 1},
    gt_masks (N, G, Hm, Wm) binary over the whole image. The samplers'
    uniforms come from ``draws`` ({"rpn": [(u_pos, u_neg) an image],
    "s0": [...], ...}) where given, else from ``generator`` in that order
    (the RPN's images, then each stage's). ``proposals``, where given,
    replace the boxes a stage starts from: (N, P, 4) the RPN's, or a list
    of them for the first stages (the RPN's losses are still computed).

    Returns (total, {loss name: value}, {"proposals": the RPN's,
    "stage_proposals": the boxes each stage started from, "draws": the
    uniforms used}); the box heads' BN running stats update in place (the
    JAX function returns them as ``new_state``)."""
    n = gt_boxes.shape[0]
    fpn = fpn_forward(head.fpn, feats, cfg)
    rpn_cls, rpn_reg = rpn_forward(head.rpn, fpn)
    anchors = torch.cat(make_anchors([f.shape[2:] for f in fpn], cfg,
                                     rpn_cls.device), 0)
    draws = {} if draws is None else draws
    used: Dict[str, List] = {}

    def uniforms(key, i):
        got = draws.get(key)
        return None if got is None else got[i]

    l_cls, l_reg, used["rpn"] = [], [], []
    for i in range(n):
        c, r, u = rpn_loss(rpn_cls[i], rpn_reg[i], anchors, gt_boxes[i],
                           gt_valid[i], cfg, generator, uniforms("rpn", i))
        l_cls.append(c)
        l_reg.append(r)
        used["rpn"].append(u)
    losses = {"rpn_cls": torch.stack(l_cls).mean(),
              "rpn_reg": torch.stack(l_reg).mean()}

    with torch.no_grad():
        rpn_props = torch.stack([rpn_proposals(rpn_cls[i], rpn_reg[i],
                                               anchors, img_hw, cfg)
                                 for i in range(n)])
    fed = [] if proposals is None else (
        list(proposals) if isinstance(proposals, (list, tuple))
        else [proposals])
    props = rpn_props
    stage_props = []

    total = losses["rpn_cls"] + losses["rpn_reg"]
    nc = cfg.num_classes
    img = torch.arange(n, device=gt_boxes.device)[:, None]
    g_slots = gt_masks.shape[1]
    gm_flat = gt_masks.reshape(n * g_slots, 1, *gt_masks.shape[2:])
    scale_y = gt_masks.shape[2] / img_hw[0]
    for si in range(len(cfg.stage_stds)):
        sw = cfg.stage_loss_weights[si]
        stds = cfg.stage_stds[si]
        thr = cfg.stage_iou_thr[si]
        if si < len(fed):
            props = fed[si]
        stage_props.append(props)
        boxes_all = torch.cat([props, gt_boxes], 1)
        pos_s, neg_s, arg, used[f"s{si}"] = [], [], [], []
        for i in range(n):
            p, q, a = assign_max_iou(boxes_all[i], gt_boxes[i], gt_valid[i],
                                     thr, thr, False, thr)
            ps, ns, u = random_sample(p, q, cfg.rcnn_sample,
                                      cfg.rcnn_pos_fraction, generator,
                                      uniforms(f"s{si}", i))
            pos_s.append(ps)
            neg_s.append(ns)
            arg.append(a)
            used[f"s{si}"].append(u)
        pos_s, neg_s, arg = (torch.stack(t) for t in (pos_s, neg_s, arg))

        rois = _rois(boxes_all)
        roi_feat = extract_roi_features(fpn[:4], rois, cfg.roi_size, cfg)
        cls, reg = bbox_head_forward(head.stages[si], roi_feat, train, cfg)
        r_all = torch.arange(rois.shape[0], device=rois.device)

        sampled = (pos_s | neg_s).reshape(-1).float()
        posf = pos_s.reshape(-1).float()
        n_s = sampled.sum().clamp(min=1.0)
        labels = torch.where(pos_s, gt_labels[img, arg],
                             torch.full_like(arg, nc)).reshape(-1)
        loss_cls = (_softmax_ce(cls, labels) * sampled).sum() / n_s
        reg_sel = reg[r_all, labels.clamp(0, nc - 1)]
        decoded = delta_decode(rois[:, 1:], reg_sel, stds, img_hw)
        tgt = gt_boxes[img, arg].reshape(-1, 4)
        giou = 1.0 - box_giou_pairwise(decoded, tgt)
        loss_reg = cfg.giou_weight * (giou * posf).sum() / n_s
        losses[f"s{si}_cls"] = loss_cls
        losses[f"s{si}_reg"] = loss_reg
        total = total + sw * (loss_cls + loss_reg)

        mask_feat = extract_roi_features(fpn[:4], rois, cfg.mask_roi_size,
                                         cfg)
        mlogits = mask_head_forward(head.mask, mask_feat)
        msel = mlogits[r_all, labels.clamp(0, nc - 1)]
        # targets: RoIAlign the matched gt mask (image i's slot arg) to
        # mask_size
        with torch.no_grad():
            mrois = torch.cat([(img * g_slots + arg).reshape(-1, 1).to(
                rois.dtype), rois[:, 1:] * scale_y], 1)
            mt = (roi_align(gm_flat, mrois, cfg.mask_size, 1)[:, 0]
                  >= 0.5).float()
        n_pos = posf.sum().clamp(min=1.0)
        loss_mask = (_bce_logits(msel, mt).mean((1, 2)) * posf).sum() / n_pos
        losses[f"s{si}_mask"] = loss_mask
        total = total + sw * loss_mask

        if si < len(cfg.stage_stds) - 1:
            with torch.no_grad():
                pred_cls = cls[:, :nc].argmax(-1)
                refined = delta_decode(rois[:, 1:], reg[r_all, pred_cls],
                                       stds, img_hw)
                props = refined.reshape(n, -1, 4)[:, :props.shape[1]]

    return total, losses, {"proposals": rpn_props,
                           "stage_proposals": stage_props, "draws": used}


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------


@torch.no_grad()
def cascade_predict(head: CascadeHead, feats: Sequence[torch.Tensor],
                    img_hw: Tuple[int, int], cfg: DetHeadConfig,
                    max_dets: int = 100, score_thr: float = 0.05,
                    nms_iou: float = 0.5):
    """Fixed-shape inference: (boxes (N, D, 4), scores (N, D), labels
    (N, D), masks (N, D, 28, 28)) with D = max_dets (or the proposals'
    count, where it is smaller); empty slots score 0.
    The stages' softmax scores are averaged, boxes come from the last
    stage; each box keeps its best class and NMS runs once with the
    boxes offset by class."""
    n = feats[0].shape[0]
    fpn = fpn_forward(head.fpn, feats, cfg)
    rpn_cls, rpn_reg = rpn_forward(head.rpn, fpn)
    anchors = torch.cat(make_anchors([f.shape[2:] for f in fpn], cfg,
                                     rpn_cls.device), 0)
    boxes = torch.stack([rpn_proposals(rpn_cls[i], rpn_reg[i], anchors,
                                       img_hw, cfg) for i in range(n)])
    nc = cfg.num_classes
    scores_sum = 0.0
    for si in range(len(cfg.stage_stds)):
        rois = _rois(boxes)
        roi_feat = extract_roi_features(fpn[:4], rois, cfg.roi_size, cfg)
        cls, reg = bbox_head_forward(head.stages[si], roi_feat, False, cfg)
        scores_sum = scores_sum + torch.softmax(cls, -1)
        pred_cls = cls[:, :nc].argmax(-1)
        r_all = torch.arange(rois.shape[0], device=rois.device)
        boxes = delta_decode(rois[:, 1:], reg[r_all, pred_cls],
                             cfg.stage_stds[si], img_hw).reshape(n, -1, 4)
    scores = (scores_sum / len(cfg.stage_stds)).reshape(n, -1, nc + 1)

    out = []
    for i in range(n):
        cls_score = scores[i][:, :nc]
        best, lbl = cls_score.amax(-1), cls_score.argmax(-1)
        best = torch.where(best > score_thr, best, torch.zeros_like(best))
        order = torch.argsort(-best, stable=True)
        bx, best, lbl = boxes[i][order], best[order], lbl[order]
        off = lbl.to(bx.dtype)[:, None] * float(max(img_hw))
        keep, valid = nms_fixed(
            bx + off, torch.where(best > 0, best,
                                  torch.full_like(best, -math.inf)),
            nms_iou, max_dets)
        fb = bx[keep]
        fs = torch.where(valid, best[keep], torch.zeros_like(best[keep]))
        fl = lbl[keep]
        rois = torch.cat([torch.zeros_like(fb[:, :1]), fb], 1)
        mf = extract_roi_features([f[i:i + 1] for f in fpn[:4]], rois,
                                  cfg.mask_roi_size, cfg)
        ml = mask_head_forward(head.mask, mf)
        d_all = torch.arange(fl.shape[0], device=fl.device)
        out.append((fb, fs, fl, torch.sigmoid(ml[d_all, fl])))
    return tuple(torch.stack(t) for t in zip(*out))
