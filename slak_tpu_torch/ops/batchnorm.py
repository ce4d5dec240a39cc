"""BatchNorm (eval and train) and its eval fold into a per-channel affine.

Port of ``slak_tpu/ops/batchnorm.py``: PyTorch ``BatchNorm2d`` semantics,
momentum 0.1, eps 1e-5; the batch variance that normalizes is the biased
one, the running variance is updated with the unbiased one. Train mode
takes its statistics from the batch (:func:`batch_norm_train`) or from the
per-channel sums the stats-fused conv kernel emits
(:func:`batch_norm_from_sums`); both return the output in x's dtype and
update the running buffers in place (outside autograd), the port's
counterpart of the JAX functions' returned running stats.
"""

from __future__ import annotations

from typing import Tuple

import torch

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


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


def _cvec(v: torch.Tensor, ndim: int, caxis: int) -> torch.Tensor:
    shape = [1] * ndim
    shape[caxis] = -1
    return v.reshape(shape)


def _normalize(x, mean, mean_sq, count, scale, bias, running_mean,
               running_var, momentum, eps, caxis):
    """y = (x - mean) * rsqrt(var + eps) * scale + bias with the biased
    batch variance, in x's dtype; running stats updated in place with the
    unbiased one."""
    var = mean_sq - mean.square()
    inv = torch.rsqrt(var + eps)
    nd = x.ndim
    y = ((x.float() - _cvec(mean, nd, caxis)) * _cvec(inv * scale, nd, caxis)
         + _cvec(bias, nd, caxis))
    with torch.no_grad():
        unbiased = var * (count / max(count - 1, 1))
        running_mean.mul_(1 - momentum).add_(momentum * mean)
        running_var.mul_(1 - momentum).add_(momentum * unbiased)
    return y.to(x.dtype)


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor,
                     momentum: float = BN_MOMENTUM, eps: float = BN_EPS,
                     caxis: int = 1) -> torch.Tensor:
    """Train-mode batch norm over every axis but ``caxis``; fp32
    statistics ``mean(x)`` and ``mean(x^2)`` as in ``slak_tpu``."""
    caxis %= x.ndim
    axes = tuple(a for a in range(x.ndim) if a != caxis)
    xf = x.float()
    count = x.numel() // x.shape[caxis]
    return _normalize(x, xf.mean(axes), xf.square().mean(axes), count, scale,
                      bias, running_mean, running_var, momentum, eps, caxis)


def batch_norm_from_sums(x: torch.Tensor, s1: torch.Tensor,
                         s2: torch.Tensor, count: int, scale: torch.Tensor,
                         bias: torch.Tensor, running_mean: torch.Tensor,
                         running_var: torch.Tensor,
                         momentum: float = BN_MOMENTUM, eps: float = BN_EPS,
                         caxis: int = 1) -> torch.Tensor:
    """:func:`batch_norm_train` from the per-channel fp32 sums
    ``s1 = sum(x)``, ``s2 = sum(x^2)`` over the ``count`` reduced elements
    (the conv kernel's stats epilogue); gradients flow into s1 and s2."""
    return _normalize(x, s1 / count, s2 / count, count, scale, bias,
                      running_mean, running_var, momentum, eps, caxis % x.ndim)


def fold_bn(scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
            var: torch.Tensor, eps: float = BN_EPS
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold eval-mode BN into (mult, add): t = gamma/sqrt(var+eps),
    y = x*t + (beta - mean*t) (reference ``fuse_bn``, models/SLaK.py:49-58).
    """
    t = scale * torch.rsqrt(var.float() + eps)
    return t, bias - mean * t
