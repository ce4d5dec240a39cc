"""Large-kernel depthwise convolution, eval and train routes (NCHW).

Port of ``slak_tpu/ops/depthwise.py``: the plain reference conv, the
eval fold of ``large_kernel_conv`` (:func:`fold_branches`, then
:func:`run_taps`) and the train route of one BN branch
(:func:`bn_branch_train`). The reference extension always pads
``(kh//2, kw//2)`` (forward_fp32.cu:140-144), so odd kernels give "same"
outputs.

Eval fold: each branch's BN folds into its taps; every branch that fits
inside the first branch's (kh, kw) window -- the (s, s) small branch inside
LoRA1's (K, s) -- is center-padded into it (exact for stride-1
same-padded odd kernels, the reference's merge identity,
models/SLaK.py:102-122); the biases sum into one per-channel vector that
the caller adds later (the fused MLP's ``pre_bias``). What is left -- the
(K, s) + (s, K) pair, or one (K, K) kernel -- runs through the K1 kernel
(:mod:`slak_tpu_torch.ops.dwconv`), one launch per branch into one output.
The port applies the fold at every stage, stage 4 (13x13 pair on 7x7
maps) included, so one route serves the whole model.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from slak_tpu_torch.ops.batchnorm import batch_norm_from_sums
from slak_tpu_torch.ops.dwconv import DwconvBnStats, dwconv, dwconv_plain


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain stride-1 same-padded depthwise conv. x: (N, C, H, W), w:
    (C, 1, kh, kw) (the torch layout), b: (C,) or None."""
    kh, kw = w.shape[-2:]
    return F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                    padding=(kh // 2, kw // 2), groups=x.shape[1])


def _pad_center(w: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """Zero-pad (C, h, w) taps to (C, kh, kw) at the center."""
    h, wd = w.shape[-2:]
    ph, pw = (kh - h) // 2, (kw - wd) // 2
    return F.pad(w, (pw, kw - wd - pw, ph, kh - h - ph))


def fold_branches(weights: Sequence[torch.Tensor],
                  scales: Sequence[Optional[torch.Tensor]],
                  biases: Sequence[Optional[torch.Tensor]]
                  ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """Eval fold of ``sum_i affine_i(dwconv(x, w_i))``. weights: (C, kh, kw)
    each. Returns (taps, bias_total): the scaled taps to run, with every
    later branch that fits inside the first one folded into it, and the
    summed per-channel bias (None when no branch has one). Mirrors
    ``slak_tpu`` ``_fold_eval_pair`` / ``large_kernel_conv``'s order."""
    def scaled(w, s):
        return w if s is None else w * s[:, None, None].to(w.dtype)

    kh0, kw0 = weights[0].shape[-2:]
    first = scaled(weights[0], scales[0])
    rest, bias_total = [], None
    for w, s, b in zip(weights[1:], scales[1:], biases[1:]):
        if w.shape[-2] <= kh0 and w.shape[-1] <= kw0:
            first = first + _pad_center(scaled(w, s), kh0, kw0)
            if b is not None:
                bias_total = b if bias_total is None else bias_total + b
        else:
            rest.append((scaled(w, s), b))
    for b in [biases[0]] + [b for _, b in rest]:
        if b is not None:
            bias_total = b if bias_total is None else bias_total + b
    return [first] + [w for w, _ in rest], bias_total


def run_taps(x: torch.Tensor, taps: Sequence[torch.Tensor],
             plain: bool = False) -> torch.Tensor:
    """sum_i dwconv(x, taps_i): one K1 launch per tap tensor, all adding
    into one output. ``plain`` runs the plain version on any device."""
    conv = dwconv_plain if plain else dwconv
    y = conv(x, taps[0])
    for t in taps[1:]:
        y = conv(x, t, out=y)
    return y


def bn_branch_train(x: torch.Tensor, w: torch.Tensor, bn: torch.nn.Module,
                    plain: bool = False) -> torch.Tensor:
    """Train route of one large conv(+BN) branch (``_branch_forward`` with
    the stats-fused banded kernel): the K4 conv emits y and its BN batch
    sums, and BN normalizes from the sums, updating ``bn``'s running
    stats. x: (N, C, H, W) compute dtype; w: (C, 1, kh, kw) float32."""
    y, s1, s2 = DwconvBnStats.apply(x, w, plain)
    n, _, h, wd = x.shape
    return batch_norm_from_sums(y, s1, s2, n * h * wd, bn.weight, bn.bias,
                                bn.running_mean, bn.running_var,
                                momentum=bn.momentum, eps=bn.eps)
