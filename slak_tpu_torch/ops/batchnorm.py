"""BatchNorm (eval and train) and its eval fold into a per-channel affine.

Port of ``slak_tpu/ops/batchnorm.py``: PyTorch ``BatchNorm2d`` semantics,
momentum 0.1, eps 1e-5; the batch variance that normalizes is the biased
one, the running variance is updated with the unbiased one. Train mode
takes its statistics from the batch (:func:`batch_norm_train`) or from the
per-channel sums the stats-fused conv kernel emits
(:func:`batch_norm_from_sums`); both return the output in x's dtype and
update the running buffers in place (outside autograd), the port's
counterpart of the JAX functions' returned running stats.
:func:`running_stats_frozen` skips that update, for a rematerialized
block's recompute (its first pass made it).

SyncBN (the reference's ``nn.SyncBatchNorm`` on every branch BN): given a
process ``group`` (the counterpart of the JAX functions' ``axis_name``),
the per-channel fp32 ``mean`` and ``mean_sq`` are averaged over the group
before they normalize, and the count of the unbiased running variance is
the group's. The average goes through :func:`all_reduce_sum`, which sums
in the forward and sums the incoming gradients in the backward, so each
rank's statistics receive every rank's share of their gradient (the
stats-fused conv's backward, ``dy + ds1 + 2 y ds2``, reads them). With
``group=None`` nothing is reduced.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Tuple

import torch
import torch.distributed as dist

BN_EPS = 1e-5
BN_MOMENTUM = 0.1

# per thread: the autograd engine recomputes a checkpointed block on the
# thread that runs the backward
_FROZEN = threading.local()


@contextlib.contextmanager
def running_stats_frozen(frozen: bool = True):
    """Inside, train-mode batch norm leaves the running stats as they are
    (the output, from the batch's statistics, is unchanged)."""
    before = getattr(_FROZEN, "on", False)
    _FROZEN.on = frozen
    try:
        yield
    finally:
        _FROZEN.on = before


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


class _AllReduceSum(torch.autograd.Function):
    """The sum over a process group, in both directions."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(dx, group=ctx.group)
        return dx, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """sum over the ranks of ``group`` of x, differentiable: the gradient
    of each rank's x is the sum of every rank's incoming gradient."""
    return _AllReduceSum.apply(x, group)


def _normalize(x, mean, mean_sq, count, scale, bias, running_mean,
               running_var, momentum, eps, caxis, group=None):
    """y = (x - mean) * rsqrt(var + eps) * scale + bias with the biased
    batch variance, in x's dtype; running stats updated in place with the
    unbiased one. With ``group``, mean and mean_sq are first averaged
    over it (one all-reduce of both) and count is the group's."""
    if group is not None:
        n = dist.get_world_size(group)
        both = all_reduce_sum(torch.stack([mean, mean_sq]), group) / n
        mean, mean_sq, count = both[0], both[1], count * n
    var = mean_sq - mean.square()
    inv = torch.rsqrt(var + eps)
    nd = x.ndim
    y = ((x.float() - _cvec(mean, nd, caxis)) * _cvec(inv * scale, nd, caxis)
         + _cvec(bias, nd, caxis))
    if getattr(_FROZEN, "on", False):
        return y.to(x.dtype)
    with torch.no_grad():
        unbiased = var * (count / max(count - 1, 1))
        running_mean.mul_(1 - momentum).add_(momentum * mean)
        running_var.mul_(1 - momentum).add_(momentum * unbiased)
    return y.to(x.dtype)


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor,
                     momentum: float = BN_MOMENTUM, eps: float = BN_EPS,
                     caxis: int = 1, group=None) -> torch.Tensor:
    """Train-mode batch norm over every axis but ``caxis``; fp32
    statistics ``mean(x)`` and ``mean(x^2)`` as in ``slak_tpu``, averaged
    over ``group`` when one is given (SyncBN)."""
    caxis %= x.ndim
    axes = tuple(a for a in range(x.ndim) if a != caxis)
    xf = x.float()
    count = x.numel() // x.shape[caxis]
    return _normalize(x, xf.mean(axes), xf.square().mean(axes), count, scale,
                      bias, running_mean, running_var, momentum, eps, caxis,
                      group)


def batch_norm_from_sums(x: torch.Tensor, s1: torch.Tensor,
                         s2: torch.Tensor, count: int, scale: torch.Tensor,
                         bias: torch.Tensor, running_mean: torch.Tensor,
                         running_var: torch.Tensor,
                         momentum: float = BN_MOMENTUM, eps: float = BN_EPS,
                         caxis: int = 1, group=None) -> torch.Tensor:
    """:func:`batch_norm_train` from the per-channel fp32 sums
    ``s1 = sum(x)``, ``s2 = sum(x^2)`` over the ``count`` reduced elements
    (the conv kernel's stats epilogue); gradients flow into s1 and s2.
    ``count`` is this rank's; ``group`` as in :func:`batch_norm_train`."""
    return _normalize(x, s1 / count, s2 / count, count, scale, bias,
                      running_mean, running_var, momentum, eps, caxis % x.ndim,
                      group)


def fold_bn(scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
            var: torch.Tensor, eps: float = BN_EPS
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold eval-mode BN into (mult, add): t = gamma/sqrt(var+eps),
    y = x*t + (beta - mean*t) (reference ``fuse_bn``, models/SLaK.py:49-58).
    """
    t = scale * torch.rsqrt(var.float() + eps)
    return t, bias - mean * t
