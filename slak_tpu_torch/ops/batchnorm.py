"""Eval BatchNorm and its fold into a per-channel affine.

Port of ``slak_tpu/ops/batchnorm.py`` (eval half): PyTorch ``BatchNorm2d``
semantics, eps 1e-5. Train-mode BN (batch statistics, running-stat
updates, the conv-epilogue sums) comes with the training slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

BN_EPS = 1e-5


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor,
               eps: float = BN_EPS, caxis: int = 1) -> torch.Tensor:
    """Eval-mode batch norm over channel axis ``caxis`` (1 for NCHW)."""
    shape = [1] * x.ndim
    shape[caxis] = -1
    inv = torch.rsqrt(running_var.float() + eps)
    y = ((x.float() - running_mean.float().reshape(shape))
         * (inv * scale.float()).reshape(shape) + bias.float().reshape(shape))
    return y.to(x.dtype)


def fold_bn(scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
            var: torch.Tensor, eps: float = BN_EPS
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold eval-mode BN into (mult, add): t = gamma/sqrt(var+eps),
    y = x*t + (beta - mean*t) (reference ``fuse_bn``, models/SLaK.py:49-58).
    """
    t = scale * torch.rsqrt(var.float() + eps)
    return t, bias - mean * t
