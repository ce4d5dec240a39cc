"""Knowledge-distillation losses: port of ``slak_tpu/kd/losses.py`` (the
reference's ``NKDLoss``, engine_kd.py:18-63; vanilla KD, engine_kd.py:65-74;
feature distillation with SmoothL1 / MSE, engine_kd.py:105-117,146-172;
Masked Generative Distillation, main_KD.py:42-108).

Every loss computes in float32 as the JAX functions do. Features are
(N, H, W, C), the JAX layout; a student's NCHW stage output passes as its
``permute(0, 2, 3, 1)`` view. Where a feature map's size differs from the
teacher's, it is resized as ``jax.image.resize(..., "bilinear")`` resizes:
``F.interpolate`` bilinear with ``antialias=True`` (without it a downsample
differs), in float32.

MGD's channel mask is ``jax.random.uniform`` in the JAX package, a stream
the port cannot reproduce: :func:`mgd_loss` draws it from a
``torch.Generator`` (:func:`mgd_mask`: the global batch's draw inside
``models.layers.global_batch_shard``, each shard keeping its rows) and
:func:`mgd_loss_masked` computes the loss for a given mask.

MGD's parameters are an ``nn.ModuleDict`` of ``nn.Conv2d`` (OIHW weights):
``gen1`` and ``gen2`` (3x3, teacher channels) and, where the channels
differ, ``align`` (1x1, student to teacher channels); every conv pads as
XLA's ``"SAME"`` at stride 1.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from slak_tpu_torch.models.layers import batch_shard


def _label_of(targets: torch.Tensor) -> torch.Tensor:
    """Soft targets (mixup's) -> argmax label (engine_kd.py:31-34); the
    first index on ties, as ``jnp.argmax``."""
    if targets.ndim > 1:
        return torch.argmax(targets, dim=1)
    return targets.long()


def nkd_loss(logit_s: torch.Tensor, logit_t: torch.Tensor,
             targets: torch.Tensor, temp: float = 1.0,
             alpha: float = 1.0) -> torch.Tensor:
    """NKD ('Rethinking Knowledge Distillation via Cross-Entropy'): a CE
    term on the target class weighted by the teacher's probability there,
    and the non-target distributions distilled at ``temp`` after the label
    logit is pushed down by 1000."""
    label = _label_of(targets)
    idx = label[:, None]
    ls32, lt32 = logit_s.float(), logit_t.float()
    y_i = F.softmax(ls32, dim=1)
    t_i = F.softmax(lt32, dim=1)
    y_t = y_i.gather(1, idx)
    w_t = t_i.gather(1, idx).detach()

    mask = F.one_hot(label, logit_s.shape[1]).float()
    ls = ls32 - 1000.0 * mask
    lt = lt32 - 1000.0 * mask
    T_i = F.softmax(lt / temp, dim=1)
    S_i = F.softmax(ls / temp, dim=1)
    T_t = T_i.gather(1, idx)
    S_t = S_i.gather(1, idx)
    np_t = T_i / (1.0 - T_t)
    np_s = S_i / (1.0 - S_t)
    at_label = mask > 0
    np_t = torch.where(at_label, torch.zeros_like(np_t), np_t)
    np_s = torch.where(at_label, torch.ones_like(np_s), np_s)

    soft_loss = -(w_t * torch.log(y_t)).mean()
    dist = (np_t * torch.log(np_s)).sum(dim=1).mean()
    return soft_loss - alpha * (temp ** 2) * dist


def _ce(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    lp = F.log_softmax(logits.float(), dim=1)
    return -lp.gather(1, label[:, None]).mean()


def kd_loss(logit_s: torch.Tensor, targets: torch.Tensor,
            logit_t: torch.Tensor, temp: float = 1.0, hard: bool = False,
            alpha: float = 0.1) -> torch.Tensor:
    """Vanilla KD: KL(student/T || teacher/T) T^2 alpha + CE (1 - alpha);
    ``hard`` distills the teacher's argmax labels, 50/50 with the CE."""
    label = _label_of(targets)
    if hard:
        y_t = torch.argmax(logit_t, dim=1)
        return 0.5 * _ce(logit_s, label) + 0.5 * _ce(logit_s, y_t)
    lp_s = F.log_softmax(logit_s.float() / temp, dim=1)
    p_t = F.softmax(logit_t.float() / temp, dim=1)
    # F.kl_div(log_q, p, "batchmean") = mean_n sum_c p (log p - log_q)
    kl = (p_t * (torch.log(torch.clamp(p_t, min=1e-30)) - lp_s)).sum(
        dim=1).mean()
    return kl * temp * temp * alpha + _ce(logit_s, label) * (1.0 - alpha)


def smooth_l1(x: torch.Tensor, y: torch.Tensor,
              beta: float = 2.0) -> torch.Tensor:
    """torch ``nn.SmoothL1Loss(beta)`` in float32 (engine_kd.py:105-106)."""
    d = (x.float() - y.float()).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).mean()


def mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x.float() - y.float()).square().mean()


def resize_bilinear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(N, H, W, C) -> (N, h, w, C) as ``jax.image.resize(..., "bilinear")``
    (half-pixel centres, a triangle filter widened by the scale when
    downsampling), computed in float32, returned in x's dtype."""
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=tuple(hw),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def fd_loss(feat_s: torch.Tensor, feat_t: torch.Tensor,
            loss_type: str = "smoothL1") -> torch.Tensor:
    """Feature distillation on (N, H, W, C) final-stage features; the
    teacher's feature carries no gradient (engine_kd.py:146-172)."""
    feat_t = feat_t.detach()
    if feat_s.shape[1:3] != feat_t.shape[1:3]:
        feat_s = resize_bilinear(feat_s, feat_t.shape[1:3])
    if loss_type == "smoothL1":
        return smooth_l1(feat_s, feat_t)
    if loss_type == "MSE":
        return mse(feat_s, feat_t)
    raise ValueError(loss_type)


# --- MGD (main_KD.py:42-108) -------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MGDConfig:
    alpha_mgd: float = 7e-5
    lambda_mgd: float = 0.5


def he_conv(cin: int, cout: int, k: int,
            generator: Optional[torch.Generator] = None) -> nn.Conv2d:
    """A k x k conv with N(0, 2 / fan_in) weights and a zero bias (the JAX
    package's init of the KD heads), drawn on the CPU from ``generator``."""
    conv = nn.Conv2d(cin, cout, k, padding=k // 2)
    with torch.no_grad():
        nn.init.normal_(conv.weight, 0.0, math.sqrt(2.0 / (k * k * cin)),
                        generator=generator)
        conv.bias.zero_()
    return conv


def mgd_init(generator: Optional[torch.Generator], student_channels: int,
             teacher_channels: int) -> nn.ModuleDict:
    """Trainable MGD parameters: the 3x3-ReLU-3x3 generation head and,
    where the channels differ, a 1x1 align conv."""
    tc = teacher_channels
    p = nn.ModuleDict({"gen1": he_conv(tc, tc, 3, generator),
                       "gen2": he_conv(tc, tc, 3, generator)})
    if student_channels != teacher_channels:
        p["align"] = he_conv(student_channels, tc, 1, generator)
    return p


def conv_same(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """NCHW stride-1 conv in x's dtype with XLA's "SAME" padding (odd
    kernels: k // 2 on each side), plus the bias."""
    y = F.conv2d(x, conv.weight.to(x.dtype), None, 1, "same")
    return y + conv.bias.to(y.dtype)[:, None, None]


def mgd_mask(generator: Optional[torch.Generator], n: int, c: int,
             lambda_mgd: float, device=None) -> torch.Tensor:
    """MGD's (n, c) channel mask, 0 where a uniform draw is below
    ``lambda_mgd``, else 1 (float32). Inside ``global_batch_shard`` the
    draw is the global batch's and this shard keeps its n rows."""
    index, count = batch_shard()
    dev = device if generator is None else generator.device
    u = torch.rand((n * count, c), generator=generator, device=dev)
    keep = torch.where(u < lambda_mgd, 0.0, 1.0)
    return keep[index * n:(index + 1) * n].to(device)


def mgd_loss_masked(params: nn.ModuleDict, feat_s: torch.Tensor,
                    feat_t: torch.Tensor, mask: torch.Tensor,
                    cfg: MGDConfig = MGDConfig()) -> torch.Tensor:
    """Masked Generative Distillation with the channel ``mask`` (n, C)
    given: the masked (aligned) student feature through the generation
    head against the teacher's, the squared error summed over everything
    and divided by n, times ``alpha_mgd``."""
    feat_t = feat_t.detach()
    n, h, w, _ = feat_t.shape
    if feat_s.shape[1:3] != (h, w):
        feat_s = resize_bilinear(feat_s, (h, w))
    x = feat_s.permute(0, 3, 1, 2)
    if "align" in params:
        x = conv_same(x, params["align"])
    masked = x * mask.reshape(n, -1, 1, 1).to(x.dtype)
    gen = F.relu(conv_same(masked, params["gen1"]))
    gen = conv_same(gen, params["gen2"])
    dis = (gen.float() - feat_t.permute(0, 3, 1, 2).float()).square().sum() \
        / n
    return dis * cfg.alpha_mgd


def mgd_loss(generator: Optional[torch.Generator], params: nn.ModuleDict,
             feat_s: torch.Tensor, feat_t: torch.Tensor,
             cfg: MGDConfig = MGDConfig()) -> torch.Tensor:
    """:func:`mgd_loss_masked` with the mask drawn from ``generator``."""
    c = params["gen1"].weight.shape[1]
    mask = mgd_mask(generator, feat_t.shape[0], c, cfg.lambda_mgd,
                    feat_s.device)
    return mgd_loss_masked(params, feat_s, feat_t, mask, cfg)
