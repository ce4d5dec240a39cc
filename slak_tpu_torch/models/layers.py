"""Shared model layers: LayerNorm, GELU, DropPath, initializers.

Port of ``slak_tpu/models/layers.py``:
  * LayerNorm eps 1e-6 with fp32 statistics, over the channel axis of a
    channels-last tensor or of a channels-first (NCHW) one (the reference's
    ``channels_first`` LayerNorm, models/SLaK.py:237-261).
  * GELU is the exact erf formulation (``nn.GELU()`` default).
  * trunc_normal_ with timm's absolute bounds [-2, 2] at std 0.02, drawn
    from a ``torch.Generator``.

Under data parallel a step's batch is one shard of a global batch, and the
step's generator is seeded the same on every rank; inside
:func:`global_batch_shard` a drop-path draw is made for the whole global
batch and the shard keeps its own rows, so the ranks together draw what one
process would draw for the global batch.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.nn.functional as F

LN_EPS = 1e-6

# per thread: (this shard's index, the number of shards) of the batch
_SHARD = threading.local()


@contextlib.contextmanager
def global_batch_shard(index: int, count: int):
    """Inside, the batch a drop-path draw is made for is shard ``index``
    of ``count`` equal shards of a global batch, in order."""
    before = getattr(_SHARD, "v", None)
    _SHARD.v = (index, count)
    try:
        yield
    finally:
        _SHARD.v = before


def batch_shard():
    """(this shard's index, the number of shards) of the batch inside
    :func:`global_batch_shard`, else (0, 1)."""
    return getattr(_SHARD, "v", None) or (0, 1)


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


def drop_path_keep(n: int, rate: float, generator=None,
                   device=None) -> torch.Tensor:
    """The per-sample keep draws of one drop-path call: (n,) bool, True
    with probability 1 - rate, from ``generator`` (on its own device) when
    given, as the train step's explicit generator, else from torch's
    default, moved to ``device``. Inside :func:`global_batch_shard` the
    draw is the global batch's and this shard's n rows are kept."""
    dev = device if generator is None else generator.device
    index, count = batch_shard()
    keep = torch.rand((n * count,), generator=generator, device=dev) \
        < 1.0 - rate
    return keep[index * n:(index + 1) * n].to(device)


def drop_path(x: torch.Tensor, rate: float, generator=None,
              train: bool = False, keep: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """Stochastic depth per sample (batch axis 0); the identity in eval.
    ``keep`` is the draw of :func:`drop_path_keep`, drawn here when not
    given (a rematerialized block is handed the draw its first pass made,
    so that its recompute masks the same samples)."""
    if not train or rate == 0.0:
        return x
    if keep is None:
        keep = drop_path_keep(x.shape[0], rate, generator, x.device)
    mask = keep.reshape((x.shape[0],) + (1,) * (x.ndim - 1))
    return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))


def trunc_normal_(t: torch.Tensor, std: float = 0.02,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """In place: N(0, std) truncated to the absolute bounds [-2, 2]."""
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0, 2.0,
                                           generator=generator)
