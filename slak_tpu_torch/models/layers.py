"""Shared model layers: LayerNorm, GELU, DropPath, initializers.

Port of ``slak_tpu/models/layers.py``:
  * LayerNorm eps 1e-6 with fp32 statistics, over the channel axis of a
    channels-last tensor or of a channels-first (NCHW) one (the reference's
    ``channels_first`` LayerNorm, models/SLaK.py:237-261).
  * GELU is the exact erf formulation (``nn.GELU()`` default).
  * trunc_normal_ with timm's absolute bounds [-2, 2] at std 0.02, drawn
    from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

LN_EPS = 1e-6


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS, dim: int = -1) -> torch.Tensor:
    """LayerNorm over axis ``dim`` with fp32 statistics; returns x.dtype."""
    xf = x.float()
    mean = xf.mean(dim, keepdim=True)
    var = (xf - mean).square().mean(dim, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    shape = [1] * x.ndim
    shape[dim] = -1
    y = y * scale.float().reshape(shape) + bias.float().reshape(shape)
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def drop_path(x: torch.Tensor, rate: float, generator=None,
              train: bool = False) -> torch.Tensor:
    """Stochastic depth per sample (batch axis 0); the identity in eval.
    The keep draws come from ``generator`` (on its own device) when given,
    as the train step's explicit generator, else from torch's default."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    dev = x.device if generator is None else generator.device
    mask = (torch.rand(shape, generator=generator, device=dev) < keep
            ).to(x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x))


def trunc_normal_(t: torch.Tensor, std: float = 0.02,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """In place: N(0, std) truncated to the absolute bounds [-2, 2]."""
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0, 2.0,
                                           generator=generator)
